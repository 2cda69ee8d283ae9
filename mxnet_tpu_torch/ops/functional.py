"""Functional ops of BERT, GPT and the vision models (counterpart of
``mxnet_tpu/ops/functional.py``), as eager PyTorch.

``hybrid_forward(F, ...)`` receives this module as ``F``. Each op keeps the
JAX op's name, arguments and dtype rules. The dense products go to
``torch.matmul``, as the JAX package left them to XLA; LayerNorm and the
sparse-label softmax cross-entropy go to the port's CUDA kernels for CUDA
tensors (``ops/cuda/layernorm.py``, ``ops/cuda/softmax_xent.py``), the
attention seam and the KV-cache writes live in ``ops/attention.py``, and
the low-bit ops (``contrib_quantize``, ``contrib_dequantize``,
``quantized_fully_connected``, ``quantized_conv``) in ``ops/lowbit.py``.
Every op but the low-bit ones is differentiable under
``autograd.record()``.

The vision ops (``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``InstanceNorm``, ``GroupNorm``, every ``Activation`` and
``LeakyReLU`` type) are plain PyTorch, as the JAX package leaves them to
XLA outside any Pallas kernel: a convolution is ``torch.nn.functional``'s
(cuDNN on the card), BatchNorm is aten's ``native_batch_norm``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .. import random as _random
from ..base import register_op, resolve_device, resolve_dtype
from .attention import (cache_write, dequant_cache,  # noqa: F401
                        quant_cache_write, quant_cache_write_read,
                        scaled_dot_attention)
from .cuda.layernorm import layernorm
from .lowbit import dequantize as contrib_dequantize  # noqa: F401
from .lowbit import quantize as contrib_quantize  # noqa: F401
from .lowbit import quantized_conv  # noqa: F401
from .lowbit import quantized_fully_connected  # noqa: F401
from .cuda.softmax_xent import softmax_xent


@register_op("FullyConnected")
def FullyConnected(x, weight, bias=None, *, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x @ W^T + b with weight (num_hidden, in), computed in x's dtype;
    an fp32 bias is cast to y's dtype so it does not widen a bf16 y."""
    if num_hidden is not None and weight.shape[0] != num_hidden:
        raise ValueError("FullyConnected: weight rows %d != num_hidden %d"
                         % (weight.shape[0], num_hidden))
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None and not no_bias:
        y = y + bias.to(y.dtype)
    return y


class _Embedding(torch.autograd.Function):
    """Row gather with ``jnp.take``'s default (fill) mode: an id in [-n, 0)
    takes row ``id + n``, an id outside [-n, n) gives a NaN row. The index
    is wrapped and clamped on the device and the NaN rows masked in, with
    no host read, so a step inside a captured CUDA graph may meet any id
    and never an out-of-range gather.

    The backward adds each valid row's gradient into its (wrapped) row in
    fp32 and casts once to the table's dtype; an out-of-range id adds
    nothing, as the JAX VJP of the fill mode drops it. A bf16 accumulator
    (or bf16 atomics on the card) drops increments once a row is hit
    thousands of times, as BERT's token-type row 0 is (every token of the
    batch)."""

    @staticmethod
    def forward(ctx, flat, weight):
        n = weight.shape[0]
        valid = (flat >= -n) & (flat < n)
        rows = torch.where(flat < 0, flat + n, flat).clamp_(0, n - 1)
        ctx.save_for_backward(rows, valid)
        ctx.table = (weight.shape, weight.dtype)
        return weight.index_select(0, rows).masked_fill_(
            ~valid[:, None], float("nan"))

    @staticmethod
    def backward(ctx, grad):
        rows, valid = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        acc.index_add_(0, rows, torch.where(valid[:, None],
                                            grad.to(torch.float32), 0.0))
        return None, acc.to(dtype)


@register_op("Embedding")
def Embedding(indices, weight, *, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    flat = indices.reshape(-1).to(torch.int64)
    return _Embedding.apply(flat, weight).reshape(
        tuple(indices.shape) + (weight.shape[1],))


@register_op("LayerNorm")
def LayerNorm(x, gamma, beta, *, axis=-1, eps=1e-5):
    """LayerNorm with fp32 statistics and one cast back to x's dtype, through
    the kernel wrapper, which launches the CUDA kernel for a CUDA tensor (or
    raises) and takes its plain version only for a CPU tensor. Another axis
    than the last is moved last for the call."""
    if gamma.dim() != 1:
        raise ValueError("LayerNorm takes 1-D gamma/beta, got %s"
                         % (tuple(gamma.shape),))
    xt = x.movedim(axis, -1)
    C = xt.shape[-1]
    y = layernorm(xt.reshape(-1, C).contiguous(), gamma, beta, eps)
    return y.reshape(xt.shape).movedim(-1, axis)


@register_op("Dropout")
def Dropout(x, *, p=0.5, training=False, mode="training"):
    """Inverted dropout in training mode, the identity otherwise: the JAX
    op's ``where(mask, x / keep, 0)`` in x's dtype, with the keep mask drawn
    from ``random.generator(x.device)``."""
    if not training or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, device=x.device,
                      generator=_random.generator(x.device)) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def _scalar(ref, value):
    """``value`` as a 0-d tensor in ``ref``'s dtype on its device."""
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


@register_op("clip")
def clip(x, a_min, a_max):
    """``jnp.clip``: max(x, a_min), then min(., a_max). torch.maximum and
    torch.minimum split the gradient of a tie in half, as JAX's max and min
    do (``torch.clamp`` would give all of it to x)."""
    return torch.minimum(torch.maximum(x, _scalar(x, a_min)),
                         _scalar(x, a_max))


@register_op("relu6")
def relu6(x):
    return clip(x, 0.0, 6.0)


@register_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": TF.softplus,
    "softsign": TF.softsign,
    # exact erf form, as jax.nn.gelu(approximate=False)
    "gelu": TF.gelu,
    "gelu_tanh": lambda x: TF.gelu(x, approximate="tanh"),
    "swish": TF.silu,
    "silu": TF.silu,
    "relu6": relu6,
}


@register_op("Activation")
def Activation(x, *, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus), softsign, gelu (erf),
    gelu_tanh, swish/silu and relu6, in x's dtype."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError("unknown act_type %r" % act_type)
    return fn(x)


@register_op("LeakyReLU")
def LeakyReLU(x, gamma=None, *, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """leaky, prelu (``gamma`` per channel on axis 1), elu, selu and gelu,
    with the JAX op's ``x >= 0`` branch rule."""
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and x.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, g * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        return torch.selu(x)
    if act_type == "gelu":
        return TF.gelu(x)
    raise ValueError("unknown act_type %r" % act_type)


@register_op("flatten")
def flatten(x):
    return x.reshape(x.shape[0], -1)


@register_op("pad")
def pad(x, *, mode="constant", pad_width=None, constant_value=0.0):
    """``pad_width`` as MXNet gives it: (before, after) for every axis of x,
    first axis first."""
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    if mode == "constant":
        return TF.pad(x, flat, mode="constant", value=constant_value)
    # torch pads only the trailing axes in these modes: drop the leading
    # axes' zero pairs
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    return TF.pad(x, flat, mode="replicate" if mode == "edge" else "reflect")


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_DECONV = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


@register_op("Convolution")
def Convolution(x, weight, bias=None, *, kernel=None, stride=1, pad=0,
                dilate=1, num_group=1, num_filter=None, no_bias=False,
                layout="NCHW"):
    """1-3 d convolution of NC... x with an (O, I / groups, k...) weight,
    computed in x's dtype with the weight (and bias) cast to it."""
    if num_filter is not None and weight.shape[0] != num_filter:
        raise ValueError("Convolution: weight out-channels %d != num_filter "
                         "%d" % (weight.shape[0], num_filter))
    nd = x.dim() - 2
    b = None if bias is None or no_bias else bias.to(x.dtype)
    return _CONV[nd](x, weight.to(x.dtype), b, _ntuple(stride, nd),
                     _ntuple(pad, nd), _ntuple(dilate, nd), num_group)


@register_op("Deconvolution")
def Deconvolution(x, weight, bias=None, *, kernel=None, stride=1, pad=0,
                  dilate=1, num_group=1, num_filter=None, adj=0,
                  no_bias=False, layout="NCHW"):
    """The transposed convolution: weight (I, O / groups, k...), ``adj``
    extra rows at the high end of each spatial axis, in x's dtype."""
    if num_filter is not None and weight.shape[1] * num_group != num_filter:
        raise ValueError("Deconvolution: weight out-channels %d != "
                         "num_filter %d" % (weight.shape[1] * num_group,
                                            num_filter))
    nd = x.dim() - 2
    b = None if bias is None or no_bias else bias.to(x.dtype)
    return _DECONV[nd](x, weight.to(x.dtype), b, _ntuple(stride, nd),
                       _ntuple(pad, nd), _ntuple(adj, nd), num_group,
                       _ntuple(dilate, nd))


@register_op("Pooling")
def Pooling(x, *, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, count_include_pad=True):
    """max, avg and sum pooling over the spatial axes of NC... x; ``stride``
    defaults to ``kernel``. Max pooling pads with -inf and sends a window's
    gradient to its first largest element, as JAX's ``reduce_window`` VJP;
    a global max splits it evenly among ties, as ``jnp.max``'s. avg divides
    by the kernel's size, or with ``count_include_pad=False`` by the count
    of real elements in the window."""
    if global_pool:
        dims = tuple(range(2, x.dim()))
        if pool_type == "max":
            return torch.amax(x, dim=dims, keepdim=True)
        if pool_type == "sum":
            return torch.sum(x, dim=dims, keepdim=True)
        return torch.mean(x, dim=dims, keepdim=True)
    nd = x.dim() - 2
    kernel = _ntuple(kernel, nd)
    stride = _ntuple(kernel if stride is None else stride, nd)
    pad = _ntuple(pad, nd)
    if nd == 1:  # as a 2-d pool over a height of 1
        y = Pooling(x.unsqueeze(2), kernel=(1,) + kernel,
                    pool_type=pool_type, stride=(1,) + stride,
                    pad=(0,) + pad, count_include_pad=count_include_pad)
        return y.squeeze(2)
    if pool_type == "max":
        pool = TF.max_pool2d if nd == 2 else TF.max_pool3d
        return pool(x, kernel, stride, pad)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unknown pool_type %r" % pool_type)
    if nd == 3:  # fp32 inside: the CPU has no bf16 avg_pool3d
        y = TF.avg_pool3d(x.float(), kernel, stride, pad,
                          count_include_pad=count_include_pad,
                          divisor_override=1 if pool_type == "sum" else None)
        return y.to(x.dtype)
    if pool_type == "sum":
        return TF.avg_pool2d(x, kernel, stride, pad, divisor_override=1)
    return TF.avg_pool2d(x, kernel, stride, pad,
                         count_include_pad=count_include_pad)


@register_op("BatchNorm")
def BatchNorm(x, gamma, beta, moving_mean, moving_var, *, eps=1e-5,
              momentum=0.9, fix_gamma=False, use_global_stats=False, axis=1,
              training=False):
    """Returns (y, new_moving_mean, new_moving_var). y is normalized in
    fp32 and cast once to x's dtype (aten's ``native_batch_norm``, which
    takes a bf16 x with fp32 statistics and parameters). In training
    (unless ``use_global_stats``) the statistics are the batch's, and the
    moving ones move by MXNet's rule, ``momentum * moving + (1 - momentum)
    * batch``, with the biased batch variance; the new moving statistics
    carry no gradient. Otherwise the moving statistics normalize and come
    back unchanged."""
    axis = axis % x.dim()
    xt = x if axis == 1 else x.movedim(axis, 1)
    g = torch.ones_like(gamma, dtype=torch.float32) if fix_gamma \
        else gamma.float()
    b = beta.float()
    if training and not use_global_stats:
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            xt, g, b, None, None, True, 0.0, eps)
        with torch.no_grad():
            # invstd = (var + eps) ** -0.5, computed in fp32
            var = invstd.float().pow(-2) - eps
            new_mean = momentum * moving_mean.float() \
                + (1 - momentum) * mean.float()
            new_var = momentum * moving_var.float() + (1 - momentum) * var
    else:
        y, _, _ = torch.ops.aten.native_batch_norm(
            xt, g, b, moving_mean.float(), moving_var.float(), False, 0.0,
            eps)
        new_mean, new_var = moving_mean, moving_var
    if axis != 1:
        y = y.movedim(1, axis)
    return y, new_mean, new_var


def _normalize(x, dims, eps):
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


@register_op("InstanceNorm")
def InstanceNorm(x, gamma, beta, *, eps=1e-5):
    """Each sample's channel over its spatial axes, in x's dtype (as the JAX
    op: no fp32 statistics), then gamma and beta on axis 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return _normalize(x, tuple(range(2, x.dim())), eps) \
        * gamma.reshape(shape) + beta.reshape(shape)


@register_op("GroupNorm")
def GroupNorm(x, gamma, beta, *, num_groups=1, eps=1e-5):
    """Each sample's channel groups over the group's channels and the
    spatial axes, in x's dtype, then gamma and beta on axis 1."""
    n, c = x.shape[:2]
    xr = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    xr = _normalize(xr, tuple(range(2, xr.dim())), eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return xr.reshape(x.shape) * gamma.reshape(shape) + beta.reshape(shape)


@register_op("reshape")
def reshape(x, *, shape):
    return x.reshape(tuple(shape))


@register_op("transpose")
def transpose(x, *, axes=None):
    if axes is None:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register_op("slice_axis")
def slice_axis(x, *, axis, begin, end):
    """``x[begin:end]`` along ``axis`` with Python's slice rules, as the JAX
    op: a negative bound counts from the end, an ``end`` past the axis is
    clamped, an empty range gives an empty tensor."""
    axis = axis % x.dim()
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register_op("squeeze")
def squeeze(x, *, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


@register_op("expand_dims")
def expand_dims(x, *, axis):
    return x.unsqueeze(axis)


@register_op("take")
def take(a, indices, *, axis=0, mode="clip"):
    """Rows of ``a`` along ``axis`` at ``indices``. ``mode="clip"`` (MXNet's
    and JAX's default) clamps each index to [0, n - 1] on the device, so no
    index reaches ``index_select`` out of range (on a CUDA tensor that is a
    device-side assert); ``"wrap"`` takes it modulo n."""
    n = a.shape[axis]
    flat = indices.reshape(-1).to(torch.int64)
    if mode == "clip":
        flat = flat.clamp(0, n - 1)
    elif mode == "wrap":
        flat = flat.remainder(n)
    else:
        raise ValueError("take: mode %r is not 'clip' or 'wrap'" % (mode,))
    out = a.index_select(axis, flat)
    shape = list(a.shape)
    shape[axis:axis + 1] = list(indices.shape)
    return out.reshape(shape)


@register_op("arange")
def arange(start, stop=None, step=1.0, *, dtype="float32", ctx=None):
    """MXNet's arange, with ``ctx`` naming the device (default: the
    current CUDA device, as every entry point)."""
    return torch.arange(start, stop, step, dtype=resolve_dtype(dtype),
                        device=resolve_device(ctx))


@register_op("lesser")
def lesser(a, b):
    """Elementwise a < b as 0/1 in a's dtype (MXNet's comparison ops)."""
    return (a < b).to(a.dtype)


@register_op("lesser_equal")
def lesser_equal(a, b):
    """Elementwise a <= b as 0/1 in a's dtype."""
    return (a <= b).to(a.dtype)


@register_op("argmax")
def argmax(x, *, axis=None, keepdims=False):
    """Index of the largest element (the first one on ties, as
    ``jnp.argmax``), as float32: MXNet returns float indices."""
    if axis is None:
        return torch.argmax(x).to(torch.float32)
    return torch.argmax(x, dim=axis, keepdim=keepdims).to(torch.float32)


@register_op("concat")
def concat(*xs, dim=1):
    return torch.cat(xs, dim=dim)


@register_op("dot")
def dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    # mixed dtypes promote as in jnp.dot: a quantized model's fp32
    # activations against its bf16 tied LM head give fp32 logits
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


@register_op("cast")
def cast(x, *, dtype):
    return x.to(resolve_dtype(dtype))


def _dims(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def _reduce(op, x, axis, keepdims):
    if axis is None:
        out = op(x)
        return out.reshape((1,) * x.dim()) if keepdims else out
    return op(x, dim=_dims(axis), keepdim=keepdims)


@register_op("sum")
def sum(x, *, axis=None, keepdims=False):
    return _reduce(torch.sum, x, axis, keepdims)


@register_op("mean")
def mean(x, *, axis=None, keepdims=False):
    """The mean; of an integer or bool tensor in fp32, as ``jnp.mean``."""
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    return _reduce(torch.mean, x, axis, keepdims)


def _fill_value(dtype):
    """What ``jnp.take_along_axis`` gives for an index out of range: NaN
    for floats, the most negative value for signed ints, the largest for
    unsigned ones, True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register_op("pick")
def pick(x, index, *, axis=-1, keepdims=False):
    """x's element at ``index`` along ``axis``. An index in [-n, n) counts
    from the end when negative; one outside gives the JAX op's fill value
    (NaN in a float output) and never another row's element: the gather
    reads the index modulo n and a ``where`` puts the fill value in."""
    n = x.shape[axis]
    idx = index.to(torch.int64).unsqueeze(axis)
    inside = (idx >= -n) & (idx < n)
    out = torch.take_along_dim(x, idx.remainder(n), dim=axis)
    out = torch.where(inside, out, _fill_value(x.dtype))
    return out if keepdims else out.squeeze(axis)


@register_op("log_softmax")
def log_softmax(x, *, axis=-1):
    return torch.log_softmax(x, dim=axis)


@register_op("softmax_xent_rows")
def softmax_xent_rows(logits, labels, *, axis=-1):
    """Per-row sparse-label NLL under softmax: logits (..., V) along
    ``axis``, int labels shaped like logits minus that axis; fp32 NLLs in
    the labels' shape. The rows go through the softmax-xent kernel wrapper
    (``ops/cuda/softmax_xent.py``), fp32 inside whatever the logits'
    dtype, as the JAX op's kernel gate does."""
    axis = axis % logits.dim()
    if axis != logits.dim() - 1:
        logits = logits.movedim(axis, -1)
    rows_shape = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1])
    lab = labels.to(torch.int32).reshape(-1)
    return softmax_xent(flat, lab).reshape(rows_shape)
