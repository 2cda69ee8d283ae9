"""The rest of MXNet's op families (counterpart of
``mxnet_tpu/ops/extra.py``): the legacy CamelCase aliases, ``elemwise_*``,
the regression output heads with their fixed backwards, and assorted
tensor ops, as eager PyTorch.

The output heads (``*RegressionOutput``, ``SVMOutput``, ``MakeLoss``,
``IdentityAttachKLSparseReg``) are identity-like forwards whose gradient
is not the forward's own: each is a ``torch.autograd.Function`` with the
JAX op's ``custom_vjp`` backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .. import random as _random
from ..base import register_op
from . import functional as F

register_op("Reshape")(F.reshape)
register_op("Flatten")(F.flatten)
register_op("Cast")(F.cast)
register_op("Concat")(F.concat)
register_op("SwapAxis")(F.swapaxes)


def _same_shape(name, f):
    def op(lhs, rhs):
        if tuple(lhs.shape) != tuple(rhs.shape):
            raise ValueError("%s requires equal shapes, got %s and %s"
                             % (name, tuple(lhs.shape), tuple(rhs.shape)))
        return f(lhs, rhs)

    op.__name__ = name
    register_op(name)(op)
    return op


elemwise_add = _same_shape("elemwise_add", torch.add)
elemwise_sub = _same_shape("elemwise_sub", torch.sub)
elemwise_mul = _same_shape("elemwise_mul", torch.mul)
elemwise_div = _same_shape("elemwise_div", torch.true_divide)


@register_op("add_n")
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


register_op("ElementWiseSum")(add_n)


@register_op("argmax_channel")
def argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register_op("batch_take")
def batch_take(x, indices):
    """out[i] = x[i, indices[i]]."""
    idx = indices.to(torch.int64)
    return torch.take_along_dim(x, idx[:, None], dim=1)[:, 0]


@register_op("broadcast_axis")
def broadcast_axis(x, *, axis, size):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for ax, s in zip(axes, sizes):
        if shape[ax] != 1:
            raise ValueError("broadcast_axis: axis %d has size %d != 1"
                             % (ax, shape[ax]))
        shape[ax] = s
    return torch.broadcast_to(x, tuple(shape))


register_op("broadcast_axes")(broadcast_axis)


@register_op("hard_sigmoid")
def hard_sigmoid(x, *, alpha=0.2, beta=0.5):
    return F.clip(alpha * x + beta, 0.0, 1.0)


@register_op("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register_op("moments")
def moments(x, *, axes=None, keepdims=False):
    """(mean, var) over ``axes``."""
    ax = tuple(axes) if axes is not None else tuple(range(x.dim()))
    return (torch.mean(x, dim=ax, keepdim=keepdims),
            torch.var(x, dim=ax, unbiased=False, keepdim=keepdims))


@register_op("unravel_index")
def unravel_index(indices, *, shape):
    """Flat → multi index, stacked on a leading axis, in the indices'
    dtype (int32 for float indices, as the JAX op casts them)."""
    idx = indices.to(torch.int64)
    coords = []
    for s in reversed(tuple(shape)):
        coords.append(idx % s)
        idx = idx // s
    out = torch.stack(list(reversed(coords)), dim=0)
    return out.to(indices.dtype if not indices.is_floating_point()
                  else torch.int32)


@register_op("ravel_multi_index")
def ravel_multi_index(coords, *, shape):
    """Multi (leading axis) → flat index, in the coordinates' dtype."""
    strides, acc = [], 1
    for s in reversed(tuple(shape)):
        strides.append(acc)
        acc *= s
    st = torch.tensor(list(reversed(strides)), dtype=coords.dtype,
                      device=coords.device)
    # a sum of products, not tensordot: CUDA has no integer matmul
    return (st.reshape((-1,) + (1,) * (coords.dim() - 1)) * coords).sum(
        0).to(coords.dtype)


@register_op("SoftmaxActivation")
def SoftmaxActivation(x, *, mode="instance"):
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register_op("shuffle")
def shuffle(x):
    """A random permutation along axis 0, drawn from
    ``random.generator(x.device)``."""
    perm = torch.randperm(x.shape[0], generator=_random.generator(x.device),
                          device=x.device)
    return x[perm]


relu6 = F.relu6


# ---------------------------------------------------- training output heads


def _regression_output(transform, grad_fn, opname):
    """Forward ``transform(data)``; backward (out - label) · grad_scale / n
    (or its sign), n the label's size per batch row, whatever the incoming
    gradient (MXNet's regression_output-inl.h)."""

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = transform(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, g):
            out, label = ctx.saved_tensors
            n = label.numel() // (label.shape[0] if label.dim() else 1) or 1
            d = grad_fn(out, label.reshape(out.shape)) * ctx.grad_scale / n
            return d.to(out.dtype), torch.zeros_like(label), None

    def op(data, label, *, grad_scale=1.0):
        return _Op.apply(data, label, grad_scale)

    op.__name__ = opname
    register_op(opname)(op)
    return op


LinearRegressionOutput = _regression_output(
    torch.clone, lambda out, y: out - y, "LinearRegressionOutput")
MAERegressionOutput = _regression_output(
    torch.clone, lambda out, y: torch.sign(out - y), "MAERegressionOutput")
LogisticRegressionOutput = _regression_output(
    torch.sigmoid, lambda out, y: out - y, "LogisticRegressionOutput")


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, y, margin, reg, use_linear):
        ctx.save_for_backward(d, y)
        ctx.cfg = (margin, reg, use_linear)
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        d, y = ctx.saved_tensors
        margin, reg, use_linear = ctx.cfg
        onehot = F.one_hot(y.to(torch.int64), depth=d.shape[1],
                           dtype=d.dtype)
        signed = torch.where(onehot > 0, -1.0, 1.0).to(d.dtype)
        viol = (margin + signed * d) > 0
        if use_linear:
            grad = torch.where(viol, signed, 0.0)
        else:  # squared hinge
            grad = torch.where(viol, 2.0 * (margin + signed * d) * signed,
                               0.0)
        return ((reg * grad).to(d.dtype), torch.zeros_like(y), None, None,
                None)


@register_op("SVMOutput")
def SVMOutput(data, label, *, margin=1.0, regularization_coefficient=1.0,
              use_linear=False):
    """Identity forward; the SVM hinge gradient in backward."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(d)
        ctx.cfg = (grad_scale, normalization, valid_thresh)
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.cfg
        # made on the device (no host copy: the backward may run inside a
        # CUDA graph capture)
        scale = torch.full((), grad_scale, dtype=d.dtype, device=d.device)
        if normalization == "batch":
            scale = scale / d.shape[0]
        elif normalization == "valid":
            valid = torch.sum((d > valid_thresh).to(d.dtype))
            scale = scale / torch.clamp(valid, min=1)
        return torch.broadcast_to(scale, d.shape).to(d.dtype), None, None, \
            None


@register_op("MakeLoss")
def MakeLoss(data, *, grad_scale=1.0, normalization="null",
             valid_thresh=0.0):
    """Identity forward; the backward seeds ``grad_scale`` (divided by the
    batch, or by the count of elements above ``valid_thresh``)."""
    return _MakeLoss.apply(data, grad_scale, normalization, valid_thresh)


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, target, penalty):
        ctx.save_for_backward(d)
        ctx.cfg = (target, penalty)
        return d.clone()

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        t, penalty = ctx.cfg
        rho = torch.clamp(torch.mean(d, dim=0, keepdim=True), 1e-6, 1 - 1e-6)
        kl_grad = penalty * (-t / rho + (1 - t) / (1 - rho))
        return g + kl_grad.to(d.dtype), None, None


@register_op("IdentityAttachKLSparseReg")
def IdentityAttachKLSparseReg(data, *, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    """Identity forward; backward adds the KL sparsity penalty's gradient
    at the batch's mean activation."""
    return _KLSparseReg.apply(data, sparseness_target, penalty)


@register_op("Correlation")
def Correlation(f1, f2, *, kernel_size=1, max_displacement=4, stride1=1,
                stride2=1, pad_size=4, is_multiply=True):
    """FlowNet correlation: every displacement a shifted product (or
    absolute difference) averaged over channels, then a kernel_size² mean
    filter; (N, D*D, ceil(H/stride1), ceil(W/stride1))."""
    n, c, h, w = f1.shape
    d = max_displacement // stride2
    p = int(pad_size)
    if p < d * stride2:
        raise ValueError("pad_size %d < max shift %d" % (p, d * stride2))
    f2p = TF.pad(f2, (p, p, p, p))
    k = int(kernel_size)
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = dy * stride2 + p, dx * stride2 + p
            shifted = f2p[:, :, oy:oy + h, ox:ox + w]
            if is_multiply:
                corr = torch.mean(f1 * shifted, dim=1)
            else:
                corr = torch.mean(torch.abs(f1 - shifted), dim=1)
            if k > 1:  # SAME-padded k×k sum, over k²
                lo = (k - 1) // 2
                cp = TF.pad(corr, (lo, k - 1 - lo, lo, k - 1 - lo))
                corr = TF.avg_pool2d(cp[:, None], k, 1, divisor_override=1
                                     )[:, 0] / (k * k)
            outs.append(corr)
    out = torch.stack(outs, dim=1)
    if stride1 > 1:
        out = out[:, :, ::stride1, ::stride1]
    return out


@register_op("identity")
def identity(x):
    return x


@register_op("softmin")
def softmin(x, *, axis=-1, temperature=None):
    if temperature is not None:
        x = x / temperature
    return torch.softmax(-x, dim=axis)


register_op("SliceChannel")(F.split)


@register_op("choose_element_0index")
def choose_element_0index(lhs, rhs, *, axis=1, keepdims=False):
    return F.pick(lhs, rhs, axis=axis, keepdims=keepdims)


@register_op("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """out[i, rhs[i]] = mhs[i], the rest lhs."""
    idx = rhs.to(torch.int64)[:, None]
    return lhs.scatter(1, idx, mhs[:, None].to(lhs.dtype))


@register_op("Crop")
def Crop(*args, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=None):
    data = args[0]
    H, W = data.shape[2], data.shape[3]
    if len(args) == 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = h_w
    if th <= 0 or tw <= 0 or th > H or tw > W:
        raise ValueError("invalid crop size (%d, %d) for input %s"
                         % (th, tw, (H, W)))
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = offset
    if y0 < 0 or x0 < 0 or y0 + th > H or x0 + tw > W:
        raise ValueError("crop window out of bounds")
    return data[:, :, y0:y0 + th, x0:x0 + tw]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register_op("im2col")
def im2col(data, *, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(N, C, H, W) → (N, C·kh·kw, L) sliding-window patches."""
    return TF.unfold(data, _pair(kernel), _pair(dilate), _pair(pad),
                     _pair(stride))


@register_op("col2im")
def col2im(data, *, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    """The adjoint of im2col: patches overlap-added back to (N, C, H, W)."""
    return TF.fold(data, tuple(output_size), _pair(kernel), _pair(dilate),
                   _pair(pad), _pair(stride))


@register_op("einsum")
def einsum(*args, equation):
    return torch.einsum(equation, *args)


@register_op("take_along_axis")
def take_along_axis(a, indices, *, axis):
    return torch.take_along_dim(a, indices.to(torch.int64), dim=int(axis))


@register_op("scatter_elements")
def scatter_elements(data, indices, updates, *, axis=0, reduction="none"):
    """ONNX ScatterElements: ``updates`` at per-element positions along
    ``axis``; ``reduction`` none, add or mul."""
    idx = indices.to(torch.int64)
    axis = int(axis)
    if reduction == "add":
        return data.scatter_add(axis, idx, updates)
    if reduction == "mul":
        return data.scatter_reduce(axis, idx, updates, reduce="prod")
    return data.scatter(axis, idx, updates)


@register_op("trilu")
def trilu(x, *, k=0, upper=True):
    return torch.triu(x, int(k)) if upper else torch.tril(x, int(k))


@register_op("celu")
def celu(x, *, alpha=1.0):
    return TF.celu(x, alpha=float(alpha))


@register_op("hardswish")
def hardswish(x):
    return x * F.clip(x / 6.0 + 0.5, 0.0, 1.0)


@register_op("thresholded_relu")
def thresholded_relu(x, *, alpha=1.0):
    return torch.where(x > alpha, x, torch.zeros_like(x))


@register_op("logsumexp")
def logsumexp(data, *, axis=None, keepdims=False):
    ax = tuple(range(data.dim())) if axis is None else (
        axis if isinstance(axis, tuple) else (int(axis),))
    return torch.logsumexp(data, dim=ax, keepdim=bool(keepdims))
