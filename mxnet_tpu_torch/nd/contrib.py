"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/nd/contrib.py``): the
contrib ops of ``_contrib_ops.CONTRIB_OPS`` and the control flow
(``cond``, ``foreach``, ``while_loop``, ``ops/control_flow.py``); the
names whose op is not ported yet raise ``NotImplementedError`` with the
``ROADMAP.md`` item that owns them."""
from __future__ import annotations

import numpy as np
import torch

from .._contrib_ops import CONTRIB_OPS
from ..ndarray import NDArray, invoke
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401

# the contrib names whose op waits for the vision half of A.17
_NOT_PORTED = {name: "A.17" for name in (
    "DeformableConvolution", "ModulatedDeformableConvolution",
    "PSROIPooling", "Proposal", "MultiProposal", "ROIAlign", "ROIPooling")}
# contrib name -> registry name, ported ops only
_PORTED = {alias: op for alias, op in CONTRIB_OPS.items()
           if alias not in _NOT_PORTED}


def _wrap(opname):
    def f(*args, **kwargs):
        return invoke(opname, args, kwargs)

    f.__name__ = opname
    return f


def _raise(name, item):
    def f(*args, **kwargs):
        raise NotImplementedError(
            "nd.contrib.%s is not ported to mxnet_tpu_torch yet "
            "(ROADMAP.md %s)" % (name, item))

    f.__name__ = name
    return f


for _alias, _op in _PORTED.items():
    globals()[_alias] = _wrap(_op)
for _alias, _item in _NOT_PORTED.items():
    globals()[_alias] = _raise(_alias, _item)


def boolean_mask(data, index, axis=0):
    """The rows of ``data`` along ``axis`` where ``index`` is nonzero (the
    output's shape depends on the values: eager, not differentiable)."""
    idx = torch.from_numpy(np.flatnonzero(index.asnumpy())).to(
        data._data.device)
    return NDArray(data._data.detach().index_select(axis, idx))
