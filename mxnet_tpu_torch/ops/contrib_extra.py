"""The long tail of ``mx.nd.contrib`` ops (counterpart of
``mxnet_tpu/ops/contrib_extra.py``; ref: src/operator/contrib/*).

The interleaved attention ops keep upstream's interleaved-projection
layout (contrib/transformer.cc, gluonnlp's fused-transformer path) as
einsums; the rest are small utility and box-coder ops. Each takes the JAX
package's arguments and returns its dtypes (``index_array`` int32).
"""
from __future__ import annotations

import torch

from ..base import register_op
from .legacy_ops import _clip

__all__ = []


@register_op("arange_like", nondiff=True)
def arange_like(data, *, start=0.0, step=1.0, repeat=1, axis=None,
                ctx=None):
    """(ref: contrib/arange_like) an arange shaped like ``data`` (or its
    ``axis``); ``repeat`` repeats each value, as ``nd.arange`` does."""
    def fill(n):
        m = -(-n // repeat)
        base = start + step * torch.arange(m, dtype=torch.float32,
                                           device=data.device)
        return base.repeat_interleave(repeat)[:n].to(data.dtype)

    if axis is None:
        return fill(data.numel()).reshape(data.shape)
    return fill(data.shape[axis])


@register_op("index_array", nondiff=True)
def index_array(data, *, axes=None):
    """(ref: contrib/index_array.cc) each element's coordinates: shape
    ``data.shape + (len(axes),)``, int32."""
    nd_ = data.dim()
    axes = tuple(range(nd_)) if axes is None else tuple(a % nd_ for a in axes)
    grids = []
    for a in axes:
        shape = [1] * nd_
        shape[a] = data.shape[a]
        grids.append(torch.arange(data.shape[a], dtype=torch.int32,
                                  device=data.device).reshape(shape)
                     .expand(data.shape))
    return torch.stack(grids, dim=-1)


@register_op("index_copy", nondiff=True)
def index_copy(old, index, new_tensor):
    """(ref: contrib/index_copy.cc) ``old`` with its rows ``index``
    replaced by ``new_tensor``'s."""
    return old.index_copy(0, index.long(), new_tensor.to(old.dtype))


@register_op("allclose", nondiff=True)
def allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    """(ref: contrib/allclose_op.cc) a (1,) float32 of 1.0 or 0.0, computed
    on the device."""
    ok = torch.isclose(a, b.to(a.dtype), rtol=rtol, atol=atol,
                       equal_nan=equal_nan).all()
    return ok.to(torch.float32).reshape(1)


def _scalar(value, like):
    return torch.tensor(value, dtype=like.dtype, device=like.device)


@register_op("div_sqrt_dim")
def div_sqrt_dim(data):
    """(ref: contrib/transformer.cc DivSqrtDim) ``data / sqrt(last dim)``,
    the root taken in ``data``'s dtype."""
    return data / _scalar(data.shape[-1], data).sqrt()


class _GradMultiply(torch.autograd.Function):
    """The identity forward, the gradient times ``scalar``."""

    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return g * _scalar(ctx.scalar, g), None


@register_op("gradientmultiplier")
def gradientmultiplier(data, *, scalar=1.0):
    """(ref: contrib/gradient_multiplier_op.cc) a bit-exact identity
    forward whose gradient is scaled by ``scalar`` (the gradient-reversal
    trick at ``scalar < 0``): the scale is applied in the backward only,
    in the gradient's dtype."""
    return _GradMultiply.apply(data, float(scalar))


@register_op("quantize_v2", nondiff=True)
def quantize_v2(data, *, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """(ref: quantization/quantize_v2.cc) affine uint8 or symmetric int8
    quantization, over the calibrated range when given, else over the
    data's; ``out_type="auto"`` takes uint8 for a calibrated range that is
    not negative, else int8. Returns (q, min (1,), max (1,))."""
    if out_type not in ("auto", "int8", "uint8"):
        raise ValueError("out_type must be auto/int8/uint8, got %r"
                         % (out_type,))
    f32 = dict(dtype=torch.float32, device=data.device)
    if min_calib_range is not None and max_calib_range is not None:
        dmin = torch.tensor(min_calib_range, **f32)
        dmax = torch.tensor(max_calib_range, **f32)
        if out_type == "auto":
            out_type = "uint8" if min_calib_range >= 0 else "int8"
    else:
        dmin = data.min().to(torch.float32)
        dmax = data.max().to(torch.float32)
        if out_type == "auto":
            out_type = "int8"  # as the JAX package: no host read of a sign
    if out_type == "uint8":
        scale = 255.0 / torch.clamp_min(dmax - dmin, 1e-20)
        q = torch.clamp(torch.round((data - dmin) * scale), 0, 255).to(
            torch.uint8)
        return q, dmin.reshape(1), dmax.reshape(1)
    absmax = torch.maximum(dmin.abs(), dmax.abs())
    scale = 127.0 / torch.clamp_min(absmax, 1e-20)
    q = torch.clamp(torch.round(data * scale), -127, 127).to(torch.int8)
    return q, (-absmax).reshape(1), absmax.reshape(1)


@register_op("group_adagrad_update", nondiff=True)
def group_adagrad_update(weight, grad, history, *, lr, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """(ref: contrib/optimizer_op.cc GroupAdagradUpdate) AdaGrad with one
    accumulator a row (the embedding optimizer). Returns (weight,
    history)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    axes = tuple(range(1, g.dim()))
    h = history + (g.square().mean(dim=axes, keepdim=True) if axes
                   else g.square())
    return weight - lr * g / (h.sqrt() + epsilon), h


def _corner_to_center(box):
    x0, y0, x1, y1 = box.split(1, dim=-1)
    w = x1 - x0
    h = y1 - y0
    return x0 + w * 0.5, y0 + h * 0.5, w, h


@register_op("box_encode", nondiff=True)
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """(ref: contrib/bounding_box.cc BoxEncode) matched ground-truth boxes
    against anchors → normalized (dx, dy, dw, dh) targets, and the masks of
    the positive samples. ``samples`` (B, N) in {+1, 0, -1}, ``matches``
    (B, N) ground-truth indices, ``anchors`` (B, N, 4) and ``refs`` (B, M,
    4) corner boxes."""
    idx = matches.clamp(0, refs.shape[1] - 1).to(torch.int64)
    matched = torch.gather(refs, 1, idx[..., None].expand(
        *idx.shape, 4))
    ax, ay, aw, ah = _corner_to_center(anchors)
    gx, gy, gw, gh = _corner_to_center(matched)
    t = torch.cat([
        ((gx - ax) / aw - means[0]) / stds[0],
        ((gy - ay) / ah - means[1]) / stds[1],
        (torch.log(gw / aw) - means[2]) / stds[2],
        (torch.log(gh / ah) - means[3]) / stds[3]], dim=-1)
    mask = (samples > 0.5)[..., None].to(t.dtype) * torch.ones_like(t)
    return t * mask, mask


@register_op("box_decode", nondiff=True)
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """(ref: contrib/bounding_box.cc BoxDecode) the inverse of
    ``box_encode``: (dx, dy, dw, dh) deltas and anchors → corner boxes."""
    if format == "corner":
        ax, ay, aw, ah = _corner_to_center(anchors)
    else:
        ax, ay, aw, ah = anchors.split(1, dim=-1)
    dx, dy, dw, dh = data.split(1, dim=-1)
    cx = dx * std0 * aw + ax
    cy = dy * std1 * ah + ay
    dw = dw * std2
    dh = dh * std3
    if clip is not None and clip > 0:
        dw = torch.clamp_max(dw, clip)
        dh = torch.clamp_max(dh, clip)
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.cat([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                      cy + h * 0.5], dim=-1)


@register_op("contrib_fft", nondiff=True)
def contrib_fft(data, *, compute_size=128):
    """(ref: contrib/fft.cc) the FFT along the last axis, interleaved
    ``[re0, im0, re1, im1, ...]``: the last dimension doubles."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    ri = torch.stack([out.real, out.imag], dim=-1)
    return ri.reshape(*data.shape[:-1], 2 * data.shape[-1]).to(
        torch.float32)


@register_op("contrib_ifft", nondiff=True)
def contrib_ifft(data, *, compute_size=128):
    """(ref: contrib/ifft.cc) the inverse of ``contrib_fft``: interleaved
    pairs in, the real part out (the last dimension halves), unnormalized
    as upstream's cuFFT: ``ifft(fft(x)) == n * x``."""
    n = data.shape[-1] // 2
    ri = data.reshape(*data.shape[:-1], n, 2).to(torch.float32)
    comp = torch.complex(ri[..., 0], ri[..., 1])
    return (torch.fft.ifft(comp, dim=-1).real * n).to(torch.float32)


# ---- the interleaved attention ops (ref: src/operator/contrib/
# transformer.cc, gluonnlp's fused self/encdec attention): each head's
# projections interleaved along the features, qkv (L, B, H * 3 * D) = per
# head [q; k; v]


def _split_qkv(qkv, heads):
    L, B, Fd = qkv.shape
    d = Fd // (3 * heads)
    x = qkv.reshape(L, B, heads, 3, d)
    return x[..., 0, :], x[..., 1, :], x[..., 2, :], d


def _inv_sqrt(d, like):
    return 1.0 / _scalar(d, like).sqrt()


@register_op("interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads):
    q, k, _, d = _split_qkv(queries_keys_values, heads)
    scores = torch.einsum("lbhd,mbhd->bhlm", q * _inv_sqrt(d, q), k)
    B, H, L, M = scores.shape
    return scores.reshape(B * H, L, M)


@register_op("interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads):
    _, _, v, d = _split_qkv(queries_keys_values, heads)
    L, B = v.shape[0], v.shape[1]
    att = attention.reshape(B, heads, attention.shape[1],
                            attention.shape[2])
    out = torch.einsum("bhlm,mbhd->lbhd", att, v)
    return out.reshape(L, B, heads * d)


@register_op("interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, *, heads):
    Lq, B, Fd = queries.shape
    d = Fd // heads
    q = queries.reshape(Lq, B, heads, d)
    k = keys_values.reshape(keys_values.shape[0], B, heads, 2, d)[..., 0, :]
    scores = torch.einsum("lbhd,mbhd->bhlm", q * _inv_sqrt(d, q), k)
    return scores.reshape(B * heads, Lq, keys_values.shape[0])


@register_op("interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, *, heads):
    M, B, Fd = keys_values.shape
    d = Fd // (2 * heads)
    v = keys_values.reshape(M, B, heads, 2, d)[..., 1, :]
    att = attention.reshape(B, heads, attention.shape[1],
                            attention.shape[2])
    out = torch.einsum("bhlm,mbhd->lbhd", att, v)
    return out.reshape(attention.shape[1], B, heads * d)
