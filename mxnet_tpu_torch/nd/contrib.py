"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/nd/contrib.py``): the
contrib names of the ported ops and the control flow (``cond``,
``foreach``, ``while_loop``, ``ops/control_flow.py``); the rest raise
``NotImplementedError`` with the ``ROADMAP.md`` item that owns them."""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import NDArray, invoke
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401

# contrib name → registry name, ported ops only
_PORTED = {
    "AdaptiveAvgPooling2D": "AdaptiveAvgPooling2D",
    "BilinearResize2D": "BilinearResize2D",
    "quantize": "contrib_quantize",
    "dequantize": "contrib_dequantize",
    "box_iou": "box_iou", "box_nms": "box_nms",
    "multibox_prior": "multibox_prior", "MultiBoxPrior": "multibox_prior",
    "multibox_target": "multibox_target",
    "MultiBoxTarget": "multibox_target",
    "multibox_detection": "multibox_detection",
    "MultiBoxDetection": "multibox_detection",
    "bipartite_matching": "bipartite_matching",
}
_NOT_PORTED = {
    "DeformableConvolution": "A.11/A.17",
    "ModulatedDeformableConvolution": "A.11/A.17",
    "PSROIPooling": "A.11/A.17", "Proposal": "A.11/A.17",
    "MultiProposal": "A.11/A.17", "ROIAlign": "A.11/A.17",
    "ROIPooling": "A.11/A.17",
    "arange_like": "A.17", "index_array": "A.17", "index_copy": "A.17",
    "allclose": "A.17", "div_sqrt_dim": "A.17",
    "gradientmultiplier": "A.17", "quantize_v2": "A.17",
    "group_adagrad_update": "A.17", "box_encode": "A.17",
    "box_decode": "A.17", "fft": "A.17", "ifft": "A.17",
    "interleaved_matmul_selfatt_qk": "A.17",
    "interleaved_matmul_selfatt_valatt": "A.17",
    "interleaved_matmul_encdec_qk": "A.17",
    "interleaved_matmul_encdec_valatt": "A.17",
}


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
