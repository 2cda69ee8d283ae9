"""``mx.nd``: imperative ops over NDArray (counterpart of
``mxnet_tpu/nd/__init__.py``).

Generated from the port's op registry, as the JAX namespace is from its
own (ref: python/mxnet/ndarray/register.py): ``nd.<op>(...)`` is
``invoke(op, args, kwargs)``. A name of the JAX registry that the port has
not ported yet is in ``NOT_PORTED`` with the ``ROADMAP.md`` item that
owns it, and ``nd.<name>`` raises ``NotImplementedError`` naming both.

The optimizer ``*_update`` ops are pure in the registry; here, as in MXNet,
they write the new states back into the state arrays passed in and honour
``out=`` for the weight. Every other op leaves its input arrays as they
were. The KV-cache writes (``cache_write``, ``quant_cache_write``,
``quant_cache_write_read``) write in place at the tensor level, where the
decode steps' captured graphs need fixed buffers; here they write into a
copy and return it, as the JAX package's functional ops do.
"""
from __future__ import annotations

import sys as _sys

from ..base import OP_REGISTRY as _REG
from .. import ops as _ops  # noqa: F401  (fills the registry)
from .. import symbol as _symbol  # noqa: F401  (the graph's source ops)
from ..ndarray import (NDArray, array, zeros, ones, full, empty,  # noqa: F401
                       arange, linspace, eye, concat, stack, waitall, invoke,
                       save, load)
from . import random  # noqa: F401
from . import contrib  # noqa: F401
from .. import linalg  # noqa: F401

_mod = _sys.modules[__name__]

# the JAX registry's names the port has not ported, by ROADMAP.md item
_NOT_PORTED_BY_ITEM = {
    "A.17 (contrib ops)": (
        "allclose", "arange_like", "box_decode", "box_encode", "contrib_fft",
        "contrib_ifft", "div_sqrt_dim", "gradientmultiplier",
        "group_adagrad_update", "index_array", "index_copy",
        "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
        "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
        "quantize_v2"),
    "A.17 (sparse)": ("_csr_dot",),
    "A.17 (detection)": (
        "_onnx_gather_nd", "_onnx_nms", "_onnx_scatter_nd", "yolo3_decode",
        "yolo3_target"),
    "A.11/A.17 (rcnn)": (
        "DeformableConvolution", "ModulatedDeformableConvolution",
        "MultiProposal", "PSROIPooling", "Proposal",
        "deformable_convolution", "modulated_deformable_convolution",
        "multi_proposal", "proposal", "psroi_pooling"),
    "A.11/A.17 (roi)": ("ROIAlign", "ROIPooling", "roi_align",
                        "roi_pooling"),
    "A.11/A.17 (spatial)": (
        "BilinearSampler", "GridGenerator", "SpatialTransformer",
        "bilinear_sampler", "grid_generator", "space_to_depth_stem_conv",
        "spatial_transformer"),
    "A.11/A.17 (pose)": ("heatmap_to_coords", "pose_target"),
    "A.11 (ctc)": ("CTCLoss", "ctc_loss"),
}
NOT_PORTED = {name: item for item, names in _NOT_PORTED_BY_ITEM.items()
              for name in names}


def not_ported(name, item):
    def f(*args, **kwargs):
        raise NotImplementedError(
            "nd.%s is not ported to mxnet_tpu_torch yet (ROADMAP.md %s)"
            % (name, item))

    f.__name__ = name
    return f


def _make(opname):
    def f(*args, **kwargs):
        return invoke(opname, args, kwargs)

    f.__name__ = opname
    f.__qualname__ = opname
    f.__doc__ = _REG[opname].__doc__
    return f


for _name in list(_REG):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make(_name))
for _name, _owner in NOT_PORTED.items():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, not_ported(_name, _owner))

# the arrays each KV-cache write writes into, by position and name: through
# nd the write goes into a copy
_CACHE_WRITES = {"cache_write": ("cache",),
                 "quant_cache_write": ("cache", "scale"),
                 "quant_cache_write_read": ("cache", "scale")}


def _make_copying(opname, written):
    def f(*args, **kwargs):
        args, kwargs = list(args), dict(kwargs)
        for i, name in enumerate(written):
            if i < len(args):
                args[i] = args[i].copy()
            elif name in kwargs:
                kwargs[name] = kwargs[name].copy()
        return invoke(opname, args, kwargs)

    f.__name__ = opname
    f.__doc__ = _REG[opname].__doc__
    return f


for _name, _written in _CACHE_WRITES.items():
    setattr(_mod, _name, _make_copying(_name, _written))

# the positions of the states each update op writes back (after the weight)
_UPDATE_STATE_ARGS = {
    "sgd_update": (), "signsgd_update": (),
    "sgd_mom_update": (2,), "rmsprop_update": (2,), "signum_update": (2,),
    "adam_update": (2, 3), "ftrl_update": (2, 3), "mp_sgd_update": (2,),
    "lamb_update_phase1": (2, 3), "mp_lamb_update_phase1": (2, 3),
    "mp_lamb_update_phase2": (4,),
    "mp_sgd_mom_update": (2, 3), "nag_mom_update": (2,),
    "mp_nag_mom_update": (2, 3), "ftml_update": (2, 3, 4),
    "rmspropalex_update": (2, 3, 4),
}


def _make_update(opname, state_pos):
    def f(*args, out=None, **kwargs):
        res = invoke(opname, args, kwargs)
        outs = res if isinstance(res, tuple) else (res,)
        for o, i in zip(outs[1:], state_pos):
            args[i]._rebind(o._data)
        if out is not None:
            out._rebind(outs[0]._data)
            return out if len(outs) == 1 else (out,) + outs[1:]
        return res

    f.__name__ = opname
    return f


for _name, _pos in _UPDATE_STATE_ARGS.items():
    setattr(_mod, _name, _make_update(_name, _pos))

# multi-weight updates: (stride, has momentum, has fp32 master, lrs/wds
# as trailing arrays)
_MULTI_UPDATE_LAYOUT = {
    "multi_sgd_update": (2, False, False, False),
    "multi_sgd_mom_update": (3, True, False, False),
    "multi_mp_sgd_update": (3, False, True, False),
    "multi_mp_sgd_mom_update": (4, True, True, False),
    "preloaded_multi_sgd_update": (2, False, False, True),
    "preloaded_multi_sgd_mom_update": (3, True, False, True),
    "preloaded_multi_mp_sgd_update": (3, False, True, True),
    "preloaded_multi_mp_sgd_mom_update": (4, True, True, True),
}


def _make_multi_update(opname, stride, has_mom, mp, preloaded):
    def f(*arrays, out=None, **kwargs):
        res = invoke(opname, arrays, kwargs)
        body = arrays[:-2] if preloaded else arrays
        num = len(body) // stride
        ws, states = res[:num], res[num:]
        si = 0
        for i in range(num):
            body[stride * i]._rebind(ws[i]._data)
            if has_mom:
                body[stride * i + 2]._rebind(states[si]._data)
                si += 1
            if mp:
                body[stride * i + stride - 1]._rebind(states[si]._data)
                si += 1
        if out is not None:
            for o, w in zip(out if isinstance(out, (list, tuple)) else [out],
                            ws):
                o._rebind(w._data)
        return res

    f.__name__ = opname
    return f


for _name, _layout in _MULTI_UPDATE_LAYOUT.items():
    setattr(_mod, _name, _make_multi_update(_name, *_layout))


def reset_arrays(*arrays, num_arrays=None):
    """Zero every array in place."""
    if num_arrays is not None and int(num_arrays) != len(arrays):
        raise ValueError("num_arrays=%s but %d arrays given"
                         % (num_arrays, len(arrays)))
    for a in arrays:
        a._rebind(a._data.detach().new_zeros(a._data.shape))


def onehot_encode(indices, out):
    """Write the one-hot encoding of ``indices`` into ``out``; returns it."""
    res = invoke("onehot_encode", (indices, out), {})
    out._rebind(res._data)
    return out


def sample_multinomial(data, *args, get_prob=False, **kwargs):
    if get_prob:
        return invoke("_sample_multinomial_prob", (data,) + args, kwargs)
    return invoke("sample_multinomial", (data,) + args, kwargs)


del _name, _owner, _pos, _layout, _written
