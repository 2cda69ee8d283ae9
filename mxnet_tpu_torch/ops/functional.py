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

import builtins

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
        # out of place: a Function returning an in-place op's result loses
        # its backward under torch.compile on torch 2.11 (base.cast_out)
        return weight.index_select(0, rows).masked_fill(
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


@register_op("Dropout", needs_training=True)
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


@register_op("BatchNorm", needs_training=True)
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


def mx_shape(in_shape, shape):
    """MXNet's reshape codes resolved against ``in_shape`` (ref:
    src/operator/tensor/matrix_op-inl.h InferReshapeShape): 0 copies the
    input dim, -1 is inferred, -2 copies every remaining input dim, -3
    merges two consecutive input dims, -4 splits one input dim into the
    next two entries (one of them may be -1)."""
    shape = tuple(shape)
    if all(s > 0 or s == -1 for s in shape):
        return shape
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(in_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(in_shape[i:])
            i = len(in_shape)
        elif s == -3:
            out.append(in_shape[i] * in_shape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = in_shape[i] // d2
            if d2 == -1:
                d2 = in_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


@register_op("reshape")
def reshape(x, *, shape):
    return x.reshape(mx_shape(tuple(x.shape), shape))


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
    idx = [builtins.slice(None)] * x.dim()
    idx[axis] = builtins.slice(begin, end)
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
    """MXNet's dot: the last axis of a against the first axis of b
    (``transpose_a`` moves a's first axis last, ``transpose_b`` b's last
    axis first)."""
    if transpose_a and a.dim() > 1:
        a = a.movedim(0, -1)
    if transpose_b and b.dim() > 1:
        b = b.movedim(-1, 0)
    # mixed dtypes promote as in jnp.dot: a quantized model's fp32
    # activations against its bf16 tied LM head give fp32 logits
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=1)


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


def int_result(x, out):
    """A reduction of an integer or bool x in the JAX package's dtype:
    int32 for the narrow signed ints and bool, x's own otherwise (torch
    widens them all to int64)."""
    if x.is_floating_point() or x.is_complex():
        return out
    if x.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return out.to(torch.int32)
    return out.to(x.dtype)


@register_op("sum")
def sum(x, *, axis=None, keepdims=False):
    return int_result(x, _reduce(torch.sum, x, axis, keepdims))


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


# ---------------------------------------------------------------- the rest
# of the JAX registry's functional ops: the elementwise families (``jnp`` and
# ``scipy.special`` there), comparisons, reductions, sorting, shape and
# index ops, products and the sequence and resize layers. Each keeps the JAX
# op's arguments and dtype rules; a python scalar operand takes the other
# operand's dtype, as JAX's weak types do.


def _t(a, like):
    """A python scalar as a 0-d tensor on ``like``'s device: a 0-d operand
    takes part in type promotion as a scalar does."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(a, device=like.device)


def _pair_args(a, b):
    if not isinstance(a, torch.Tensor):
        a = _t(a, b)
    elif not isinstance(b, torch.Tensor):
        b = _t(b, a)
    return a, b


def _unary(name, f, keep_int=False):
    """Register elementwise ``f``; with ``keep_int`` an integer input comes
    back unchanged (``jnp.floor`` and kin keep ints)."""
    def op(x):
        if keep_int and not (x.is_floating_point() or x.is_complex()):
            return x.clone()
        return f(x)

    op.__name__ = name
    register_op(name)(op)
    return op


def _float_in(f):
    """``f`` on x, an integer x first cast to float32 as jnp does for the
    transcendental functions."""
    def g(x):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        return f(x)

    return g


abs = _unary("abs", torch.abs)
sign = _unary("sign", torch.sign)
ceil = _unary("ceil", torch.ceil, keep_int=True)
floor = _unary("floor", torch.floor, keep_int=True)
trunc = _unary("trunc", torch.trunc, keep_int=True)
round = _unary("round", torch.round, keep_int=True)
rint = _unary("rint", _float_in(torch.round))  # jnp.rint: ints to float
fix = _unary("fix", torch.trunc, keep_int=True)
exp = _unary("exp", _float_in(torch.exp))
expm1 = _unary("expm1", _float_in(torch.expm1))
log = _unary("log", _float_in(torch.log))
log1p = _unary("log1p", _float_in(torch.log1p))
log2 = _unary("log2", _float_in(torch.log2))
log10 = _unary("log10", _float_in(torch.log10))
sqrt = _unary("sqrt", _float_in(torch.sqrt))
rsqrt = _unary("rsqrt", _float_in(torch.rsqrt))
cbrt = _unary("cbrt", _float_in(
    lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)))
rcbrt = _unary("rcbrt", _float_in(
    lambda x: 1.0 / (torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))))
square = _unary("square", torch.square)
reciprocal = _unary("reciprocal", lambda x: 1.0 / x)
negative = _unary("negative", torch.negative)
sin = _unary("sin", _float_in(torch.sin))
cos = _unary("cos", _float_in(torch.cos))
tan = _unary("tan", _float_in(torch.tan))
arcsin = _unary("arcsin", _float_in(torch.asin))
arccos = _unary("arccos", _float_in(torch.acos))
arctan = _unary("arctan", _float_in(torch.atan))
sinh = _unary("sinh", _float_in(torch.sinh))
cosh = _unary("cosh", _float_in(torch.cosh))
tanh = _unary("tanh", _float_in(torch.tanh))
arcsinh = _unary("arcsinh", _float_in(torch.asinh))
arccosh = _unary("arccosh", _float_in(torch.acosh))
arctanh = _unary("arctanh", _float_in(torch.atanh))
degrees = _unary("degrees", _float_in(torch.rad2deg))
radians = _unary("radians", _float_in(torch.deg2rad))
erf = _unary("erf", _float_in(torch.erf))
erfinv = _unary("erfinv", _float_in(torch.erfinv))
gammaln = _unary("gammaln", _float_in(torch.lgamma))
gamma = _unary("gamma", _float_in(lambda x: torch.exp(torch.lgamma(x))))
digamma = _unary("digamma", _float_in(torch.digamma))
softsign = _unary("softsign", lambda x: x / (1 + torch.abs(x)))
relu = _unary("relu", torch.relu)
softrelu = _unary("softrelu", _float_in(
    lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))))
logical_not = _unary("logical_not", torch.logical_not)
isnan = _unary("isnan", torch.isnan)
isinf = _unary("isinf", torch.isinf)
isfinite = _unary("isfinite", torch.isfinite)


@register_op("polygamma")
def polygamma(n, x):
    """The n-th derivative of digamma at x; n is an int order."""
    return torch.polygamma(int(n), x)


def _binary(name, f):
    def op(a, b):
        a, b = _pair_args(a, b)
        return f(a, b)

    op.__name__ = name
    register_op(name)(op)
    return op


def _true_divide(a, b):
    return torch.true_divide(a, b)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", _true_divide)
mod = _binary("mod", torch.remainder)  # Python's sign, as jnp.mod
power = _binary("power", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
hypot = _binary("hypot", lambda a, b: torch.hypot(*_floats(a, b)))
arctan2 = _binary("arctan2", lambda a, b: torch.atan2(*_floats(a, b)))


def _floats(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    if not dt.is_floating_point:
        dt = torch.float32
    return a.to(dt), b.to(dt)


def _compare(name, f):
    """0/1 in the first operand's dtype (MXNet's comparison ops)."""
    def op(a, b):
        ref = a if isinstance(a, torch.Tensor) else None
        a, b = _pair_args(a, b)
        dt = ref.dtype if ref is not None else torch.promote_types(
            a.dtype, b.dtype)
        return f(a, b).to(dt)

    op.__name__ = name
    register_op(name)(op)
    return op


equal = _compare("equal", torch.eq)
not_equal = _compare("not_equal", torch.ne)
greater = _compare("greater", torch.gt)
greater_equal = _compare("greater_equal", torch.ge)


def _logical(name, f):
    def op(a, b):
        a, b = _pair_args(a, b)
        return f(a, b).to(torch.float32)

    op.__name__ = name
    register_op(name)(op)
    return op


logical_and = _logical("logical_and", torch.logical_and)
logical_or = _logical("logical_or", torch.logical_or)
logical_xor = _logical("logical_xor", torch.logical_xor)

for _n, _f in [
        ("broadcast_add", add), ("broadcast_sub", subtract),
        ("broadcast_mul", multiply), ("broadcast_div", divide),
        ("broadcast_mod", mod), ("broadcast_power", power),
        ("broadcast_maximum", maximum), ("broadcast_minimum", minimum),
        ("broadcast_hypot", hypot), ("broadcast_equal", equal),
        ("broadcast_not_equal", not_equal), ("broadcast_greater", greater),
        ("broadcast_greater_equal", greater_equal),
        ("broadcast_lesser", lesser),
        ("broadcast_lesser_equal", lesser_equal),
        ("broadcast_logical_and", logical_and),
        ("broadcast_logical_or", logical_or),
        ("broadcast_logical_xor", logical_xor)]:
    register_op(_n)(_f)


@register_op("where")
def where(condition, x, y):
    x, y = _pair_args(x, y)
    return torch.where(condition.to(torch.bool), x, y)


@register_op("smooth_l1")
def smooth_l1(x, *, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x,
                       torch.abs(x) - 0.5 / s2)


# ---------------------------------------------------------------- reductions


def _axes(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(axis)


@register_op("nansum")
def nansum(x, *, axis=None, keepdims=False):
    return int_result(x, torch.nansum(x, dim=_axes(x, axis),
                                      keepdim=keepdims))


def _prod(x, axis, keepdims):
    out = x
    for a in sorted((a % x.dim() for a in _axes(x, axis)), reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return int_result(x, out)


@register_op("prod")
def prod(x, *, axis=None, keepdims=False):
    return _prod(x, axis, keepdims)


@register_op("nanprod")
def nanprod(x, *, axis=None, keepdims=False):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype,
                                                   device=x.device), x)
    return _prod(x, axis, keepdims)


@register_op("max")
def max(x, *, axis=None, keepdims=False):
    return torch.amax(x, dim=_axes(x, axis), keepdim=keepdims)


@register_op("min")
def min(x, *, axis=None, keepdims=False):
    return torch.amin(x, dim=_axes(x, axis), keepdim=keepdims)


@register_op("var")
def var(x, *, axis=None, keepdims=False):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.var(x, dim=_axes(x, axis), unbiased=False, keepdim=keepdims)


@register_op("std")
def std(x, *, axis=None, keepdims=False):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.std(x, dim=_axes(x, axis), unbiased=False, keepdim=keepdims)


@register_op("argmin")
def argmin(x, *, axis=None, keepdims=False):
    """Index of the smallest element (the first on ties), as float32."""
    if axis is None:
        return torch.argmin(x).to(torch.float32)
    return torch.argmin(x, dim=axis, keepdim=keepdims).to(torch.float32)


@register_op("norm")
def norm(x, *, ord=2, axis=None, keepdims=False):
    """The 2-norm as sqrt(sum(x ** 2)), the 1-norm as sum(|x|)."""
    if ord == 2:
        return torch.sqrt(torch.sum(torch.square(x), dim=_axes(x, axis),
                                    keepdim=keepdims))
    if ord == 1:
        return torch.sum(torch.abs(x), dim=_axes(x, axis), keepdim=keepdims)
    raise ValueError("norm only supports ord 1/2")


def _scan(f, x, axis, dtype):
    dt = resolve_dtype(dtype)
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = f(x, dim=axis, dtype=dt)
    return out if dt is not None else int_result(x, out)


@register_op("cumsum")
def cumsum(x, *, axis=None, dtype=None):
    return _scan(torch.cumsum, x, axis, dtype)


@register_op("cumprod")
def cumprod(x, *, axis=None, dtype=None):
    return _scan(torch.cumprod, x, axis, dtype)


@register_op("L2Normalization")
def L2Normalization(x, *, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, x.dim()))
    elif mode == "channel":
        ax = (1,)
    else:  # spatial
        ax = tuple(range(2, x.dim()))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True)
                          + eps)


def _sorted(x, axis, descending):
    """(values, indices) along ``axis``, ties in index order."""
    return torch.sort(x, dim=axis, descending=descending, stable=True)


@register_op("topk", nondiff=True)
def topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with ``is_ascend``) along ``axis``, the
    lower index first among ties (``lax.top_k``); indices as ``dtype``."""
    vals, idx = _sorted(x, axis, not is_ascend)
    vals = vals.narrow(axis, 0, k)
    idx = idx.narrow(axis, 0, k).to(resolve_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


@register_op("sort")
def sort(x, *, axis=-1, is_ascend=True):
    s = _sorted(x, axis, False)[0]
    return s if is_ascend else torch.flip(s, dims=(axis,))


@register_op("argsort")
def argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    """The stable ascending order, reversed whole for descending (as the
    JAX op: ties then come last index first)."""
    i = _sorted(x, axis, False)[1]
    if not is_ascend:
        i = torch.flip(i, dims=(axis,))
    return i.to(resolve_dtype(dtype))


# ---------------------------------------------------------------- shape ops


@register_op("swapaxes")
def swapaxes(x, *, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register_op("broadcast_to")
def broadcast_to(x, *, shape):
    shape = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@register_op("broadcast_like")
def broadcast_like(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op("tile")
def tile(x, *, reps):
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


@register_op("repeat")
def repeat(x, *, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("flip")
def flip(x, *, axis):
    return torch.flip(x, dims=(axis,) if isinstance(axis, int)
                      else tuple(axis))


reverse = register_op("reverse")(flip)


@register_op("stack")
def stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


@register_op("split")
def split(x, *, num_outputs, axis=1, squeeze_axis=False):
    n = x.shape[axis]
    if n % num_outputs:
        raise ValueError("split: axis of %d does not split into %d equal "
                         "parts" % (n, num_outputs))
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def basic_index(x, key):
    """``x[key]`` for a tuple of ints, slices, ``None`` and ``...``; a
    slice with a negative step, which torch's indexing refuses, is taken
    with ``index_select``."""
    keys = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, builtins.slice) and k.step is not None
               and k.step < 0 for k in keys):
        return x[key]
    n_real = len([k for k in keys if k is not None and k is not Ellipsis])
    out, axis = x, 0
    for k in keys:
        if k is Ellipsis:
            axis += x.dim() - n_real
        elif k is None:
            out = out.unsqueeze(axis)
            axis += 1
        elif isinstance(k, builtins.slice):
            idx = list(range(*k.indices(out.shape[axis])))
            out = out.index_select(axis, torch.tensor(
                idx, dtype=torch.int64, device=x.device))
            axis += 1
        else:
            out = out.select(axis, k)
    return out


@register_op("slice")
def slice(x, *, begin, end, step=None):
    step = step or [None] * len(begin)
    return basic_index(x, tuple(builtins.slice(b, e, s)
                                for b, e, s in zip(begin, end, step)))


@register_op("slice_like")
def slice_like(x, y, *, axes=None):
    idx = [builtins.slice(None)] * x.dim()
    for ax in (axes if axes is not None else range(x.dim())):
        idx[ax] = builtins.slice(0, y.shape[ax])
    return x[tuple(idx)]


@register_op("gather_nd")
def gather_nd(data, indices):
    """indices (M, ...) select along data's first M axes."""
    idx = tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))
    return data[idx]


@register_op("scatter_nd")
def scatter_nd(data, indices, *, shape):
    idx = tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))
    return torch.zeros(tuple(shape), dtype=data.dtype,
                       device=data.device).index_put(idx, data)


@register_op("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """An index outside [0, depth) gives a row of ``off_value``."""
    cols = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int64)[..., None] == cols).to(
        resolve_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register_op("diag")
def diag(x, *, k=0):
    if x.dim() <= 2:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=0, dim2=1)


@register_op("trace")
def trace(x, *, offset=0, axis1=0, axis2=1):
    return int_result(x, torch.diagonal(x, offset=offset, dim1=axis1,
                                        dim2=axis2).sum(-1))


@register_op("depth_to_space")
def depth_to_space(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


@register_op("space_to_depth")
def space_to_depth(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


# the JAX package asks for int64 with x64 off, which gives int32
@register_op("_onnx_shape")
def _onnx_shape(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register_op("shape_array")
def shape_array(x):
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


@register_op("size_array")
def size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register_op("zeros_like")
def zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def ones_like(x):
    return torch.ones_like(x)


@register_op("BlockGrad")
def BlockGrad(x):
    return x.detach()


stop_gradient = BlockGrad


# ---------------------------------------------------------------- products


def _same(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


@register_op("batch_dot")
def batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(*_same(a, b))


@register_op("matmul")
def matmul(a, b):
    return torch.matmul(*_same(a, b))


@register_op("khatri_rao")
def khatri_rao(*xs):
    out = xs[0]
    for m in xs[1:]:
        out = torch.einsum("ir,jr->ijr", out, m).reshape(-1, out.shape[1])
    return out


# ---------------------------------------------------------------- nn


@register_op("softmax")
def softmax(x, *, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=axis)


@register_op("softmax_cross_entropy")
def softmax_cross_entropy(logits, labels):
    """The summed sparse-label NLL, through the softmax-xent kernel
    wrapper (``softmax_xent_rows``)."""
    return torch.sum(softmax_xent_rows(logits, labels))


class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; the incoming gradient goes to the logits unchanged
    (MXNet's SoftmaxOutput: the caller supplies prob - one_hot)."""

    @staticmethod
    def forward(ctx, x):
        return torch.softmax(x, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g


@register_op("SoftmaxOutput")
def SoftmaxOutput(x, label=None, *, grad_scale=1.0, ignore_label=-1,
                  use_ignore=False, preserve_shape=False, multi_output=False):
    return _SoftmaxOutput.apply(x)


@register_op("SequenceMask")
def SequenceMask(x, sequence_length=None, *, use_sequence_length=False,
                 value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return x
    T = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = T
    pos = torch.arange(T, device=x.device).reshape(shape)
    lshape = [1] * x.dim()
    batch_axis = 1 if axis == 0 else 0
    lshape[batch_axis] = x.shape[batch_axis]
    mask = pos < sequence_length.reshape(lshape)
    return torch.where(mask, x, _scalar(x, value))


@register_op("SequenceLast")
def SequenceLast(x, sequence_length=None, *, use_sequence_length=False,
                 axis=0):
    xm = x.movedim(axis, 0)
    if not use_sequence_length or sequence_length is None:
        return xm[-1]
    last = sequence_length.to(torch.int64) - 1
    return xm[last, torch.arange(xm.shape[1], device=x.device)]


@register_op("SequenceReverse")
def SequenceReverse(x, sequence_length=None, *, use_sequence_length=False,
                    axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, dims=(axis,))
    T = x.shape[axis]
    xm = x.movedim(axis, 0)
    pos = torch.arange(T, device=x.device)[:, None]
    L = sequence_length.to(torch.int64)[None, :]
    src = torch.where(pos < L, L - 1 - pos, pos)
    out = xm[src, torch.arange(xm.shape[1], device=x.device)[None, :]]
    return out.movedim(0, axis)


@register_op("LRN")
def LRN(x, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response norm across the channels of NCHW x."""
    sq = torch.square(x)
    half = nsize // 2
    sqp = TF.pad(sq, (0, 0, 0, 0, half, half))
    C = x.shape[1]
    s = sqp[:, 0:C]
    for i in range(1, nsize):
        s = s + sqp[:, i:i + C]
    return x / torch.pow(knorm + (alpha / nsize) * s, beta)


@register_op("UpSampling")
def UpSampling(x, *, scale=2, sample_type="nearest"):
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(x, scale, dim=2), scale, dim=3)
    return TF.interpolate(x, scale_factor=scale, mode="bilinear",
                          align_corners=False)


def adaptive_avg_matrix(n_in, n_out):
    """Row-averaging matrix of adaptive pooling, windows
    [floor(i·n/o), ceil((i+1)·n/o))."""
    import numpy as np

    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        s, e = (i * n_in) // n_out, -((-(i + 1) * n_in) // n_out)
        m[i, s:e] = 1.0 / (e - s)
    return m


@register_op("AdaptiveAvgPooling2D")
def AdaptiveAvgPooling2D(x, *, output_size=None):
    """(B, C, H, W) → (B, C, oh, ow) as two averaging products."""
    if output_size is None or output_size == ():
        return x
    if isinstance(output_size, (tuple, list)):
        oh, ow = (int(output_size[0]),
                  int(output_size[1 if len(output_size) > 1 else 0]))
    else:
        oh = ow = int(output_size)
    h, w = x.shape[2], x.shape[3]
    left = torch.from_numpy(adaptive_avg_matrix(h, oh)).to(x.device, x.dtype)
    right = torch.from_numpy(adaptive_avg_matrix(w, ow)).to(
        x.device, x.dtype).t()
    return torch.einsum("oh,bchw,wp->bcop", left, x, right)


def _bilinear_gather(x, ys, xs):
    """Sample NCHW x at float rows ``ys`` × cols ``xs`` (already in
    [0, dim - 1]) with bilinear weights; an integer x in float32, rounded
    back."""
    H, W = x.shape[2], x.shape[3]
    integral = not x.is_floating_point()
    compute = torch.float32 if integral else x.dtype
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0).to(compute)[:, None]
    wx = (xs - x0).to(compute)[None, :]
    xc = x.to(compute)
    v00 = xc[:, :, y0[:, None], x0[None, :]]
    v01 = xc[:, :, y0[:, None], x1[None, :]]
    v10 = xc[:, :, y1[:, None], x0[None, :]]
    v11 = xc[:, :, y1[:, None], x1[None, :]]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    if integral:
        out = torch.round(out).to(x.dtype)
    return out


def _linspace(a, b, n, device):
    import numpy as np

    return torch.from_numpy(np.linspace(a, b, n).astype(np.float32)).to(
        device)


@register_op("BilinearResize2D")
def BilinearResize2D(x, *, height=None, width=None, scale_height=None,
                     scale_width=None):
    """Align-corners bilinear resize (output pixel i samples
    i·(H-1)/(h-1)), MXNet's convention."""
    H, W = x.shape[2], x.shape[3]
    h = int(height) if height is not None else int(H * scale_height)
    w = int(width) if width is not None else int(W * scale_width)
    zero = torch.zeros(1, dtype=torch.float32, device=x.device)
    ys = _linspace(0.0, H - 1.0, h, x.device) if h > 1 else zero
    xs = _linspace(0.0, W - 1.0, w, x.device) if w > 1 else zero
    return _bilinear_gather(x, ys, xs)


@register_op("_resize_linear_asymmetric")
def _resize_linear_asymmetric(x, *, height=None, width=None,
                              scale_height=None, scale_width=None):
    """ONNX's asymmetric linear Resize: source = output / scale."""
    H, W = x.shape[2], x.shape[3]
    h = int(height) if height is not None else int(H * scale_height)
    w = int(width) if width is not None else int(W * scale_width)
    sh = float(scale_height) if scale_height is not None else h / H
    sw = float(scale_width) if scale_width is not None else w / W
    ys = torch.clamp(torch.arange(h, dtype=torch.float32,
                                  device=x.device) / sh, max=H - 1.0)
    xs = torch.clamp(torch.arange(w, dtype=torch.float32,
                                  device=x.device) / sw, max=W - 1.0)
    return _bilinear_gather(x, ys, xs)


@register_op("_resize_linear_half_pixel")
def _resize_linear_half_pixel(x, *, height=None, width=None,
                              scale_height=None, scale_width=None,
                              pytorch_mode=False):
    """Half-pixel-centre bilinear resize, no antialiasing (ONNX Resize's
    default)."""
    h = int(height) if height is not None else int(x.shape[2] * scale_height)
    w = int(width) if width is not None else int(x.shape[3] * scale_width)
    if pytorch_mode and (h == 1 or w == 1):
        raise NotImplementedError(
            "pytorch_half_pixel Resize with an output dim of 1 differs "
            "from half_pixel and is not implemented")
    return TF.interpolate(x, size=(h, w), mode="bilinear",
                          align_corners=False, antialias=False)


# the fused recurrence and the detection ops live in their own modules, and
# are ``F``'s as every op is
from .rnn import RNN, _rnn_init  # noqa: E402,F401
from .detection import (  # noqa: E402,F401
    bipartite_matching, box_iou, box_nms, multibox_detection, multibox_prior,
    multibox_target)
