"""NameManager / Prefix: automatic symbol naming (counterpart of
``mxnet_tpu/name.py``; ref: python/mxnet/name.py).

``current().get(None, 'conv')`` yields 'conv0', 'conv1', ...; inside
``with Prefix('resnet_'):`` every automatic name takes the prefix. The
state is per thread.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_local = threading.local()


class NameManager:
    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        """An explicit ``name`` wins; otherwise ``hint%d``, counted per
        hint."""
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        current()  # the root manager exists before the first scope
        _local.stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()


class Prefix(NameManager):
    """A :class:`NameManager` whose automatic names start with ``prefix``."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    """The innermost manager on this thread (a root one at first)."""
    if not hasattr(_local, "stack"):
        _local.stack = [NameManager()]
    return _local.stack[-1]
