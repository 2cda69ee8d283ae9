"""AttrScope: attributes attached to the symbols made inside a ``with``
block (counterpart of ``mxnet_tpu/attribute.py``; ref:
python/mxnet/attribute.py, nnvm node attrs).

Inside ``with AttrScope(ctx_group='dev1'):`` every operator node and
variable made takes the scope's attributes as annotations: they are kept
and serialized with the node but never passed to the op. Scopes nest, the
inner value wins; a node's own attribute wins over the scope's. Loading a
graph (``symbol.load``) takes no scope attributes.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_local = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs

    def get(self, attr=None):
        """The scope's attributes merged with ``attr`` (``attr`` wins)."""
        if not self._attr:
            return dict(attr or {})
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        stack = _stack()
        merged = AttrScope()
        merged._attr = {**stack[-1]._attr, **self._attr}
        stack.append(merged)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()


def _stack():
    stack = getattr(_local, "stack", None)
    if not stack:
        stack = _local.stack = [AttrScope()]
    return stack


def current():
    """The merged scope in force on this thread."""
    return _stack()[-1]
