"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/sym_contrib.py``; ref:
python/mxnet/symbol/contrib.py): the symbolic forms of the contrib ops
of ``_contrib_ops.CONTRIB_OPS`` that ``mx.nd.contrib`` has ported, under
the same names, and the symbolic
control flow (``cond``, ``foreach``, ``while_loop``); the rest raise with
the ``ROADMAP.md`` item that owns them, as ``nd.contrib`` does."""
from __future__ import annotations

from ._contrib_ops import CONTRIB_OPS  # noqa: F401
from .nd.contrib import _NOT_PORTED, _PORTED
from .symbol import _make, cond, foreach, while_loop  # noqa: F401


def _wrap(opname):
    def f(*args, name=None, **kwargs):
        return _make(opname, *args, name=name, **kwargs)

    f.__name__ = opname
    return f


def _raise(name, item):
    def f(*args, **kwargs):
        raise NotImplementedError(
            "sym.contrib.%s is not ported to mxnet_tpu_torch yet "
            "(ROADMAP.md %s)" % (name, item))

    f.__name__ = name
    return f


for _alias, _op in _PORTED.items():
    globals()[_alias] = _wrap(_op)
for _alias, _item in _NOT_PORTED.items():
    globals()[_alias] = _raise(_alias, _item)
del _alias
