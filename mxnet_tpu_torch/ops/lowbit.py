"""The low-bit arithmetic of quantized inference (counterpart of the op
part of ``mxnet_tpu/quantization.py``): symmetric quantize / dequantize,
per-slice weight quantization, and the quantized fully-connected product,
registered as the ``F`` ops ``contrib_quantize``, ``contrib_dequantize``,
``quantized_fully_connected`` and ``quantized_conv``.

The products are library GEMMs, as the JAX package leaves them to XLA's
``dot_general`` outside any Pallas kernel; each mode has one fixed route,
chosen by the weight's dtype (:func:`lowbit_matmul`):

* ``int8``: ``torch._int_mm``, int32 accumulation (exact);
* ``e4m3``: ``torch._scaled_mm`` with unit scales and an fp32 output, the
  rescale applied afterwards in fp32 as in JAX;
* ``e5m2``: cuBLASLt takes no e5m2 x e5m2 product, so both operands are
  upcast exactly to fp32 (an e5m2 value has 3 significant bits) and
  multiplied by ``torch.matmul``; a product of two such values is exact in
  fp32 (and in TF32), so only the order of the sums differs from a native
  fp8 product.

Each route pads the operands with zeros to the shapes the card's GEMMs
take (rows above 16 and a multiple of 8, inner and output widths a
multiple of 16) after the activation's scale is taken, so padding changes
neither the scale nor the kept rows, and passes the weight as the
column-major view ``qweight.t()``, never a copy.

A quantized convolution is the same product over the columns of its
quantized input (:func:`im2col`: every window of the padded input as a
row, built from views of any dtype, so the int8 values are never widened),
one product per group: ``torch.nn.functional.conv2d`` has no int8 form on
the card, and the JAX op accumulates int8 exactly in int32 as this does.

A division by a constant is written as a division by a 0-d tensor in the
operand's dtype on its device. On the card a Python scalar divisor is
turned into a multiply by its reciprocal, which can differ from the JAX
division in the last bit; the 0-d tensor keeps the true division, and its
dtype keeps JAX's weak-type rule (a bf16 amax is divided in bf16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..base import register_op

# symmetric-quantization ranges per mode; the fp8 values are the finite
# maxima of the formats (e4m3: 448, e5m2: 57344)
_QMAX = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}
_FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def quant_dtype(mode):
    """The storage dtype of a quantization mode."""
    if mode == "int8":
        return torch.int8
    if mode not in _FP8_DTYPES:
        raise ValueError("quantization mode must be one of %s, got %r"
                         % (sorted(_QMAX), mode))
    return _FP8_DTYPES[mode]


def _dtype_qparams(dt):
    """(qmax, integral) of a quantized storage dtype."""
    if dt == torch.int8:
        return 127.0, True
    for mode, fdt in _FP8_DTYPES.items():
        if dt == fdt:
            return _QMAX[mode], False
    raise TypeError("unsupported quantized weight dtype %r" % (dt,))


def _const(ref, value):
    """``value`` as a 0-d tensor in ``ref``'s dtype on its device (see the
    module docstring on division by a constant)."""
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def _scale_of(amax, qmax):
    """max(amax, 1e-8) / qmax, in amax's dtype."""
    return torch.maximum(amax, _const(amax, 1e-8)) / _const(amax, qmax)


@register_op("contrib_quantize")
def quantize(x, *, axis=None):
    """Symmetric int8: (q, scale). ``axis=None`` is per-tensor, ``axis=i``
    per slice along dim i (scale keeps the reduced dims)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        red = tuple(d for d in range(x.dim()) if d != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    scale = _scale_of(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@register_op("contrib_dequantize")
def dequantize(q, scale):
    return q.to(torch.float32) * scale


def quantize_weight(w, axis=0, mode="int8"):
    """Symmetric per-slice weight quantization: (q, scale), scale keeping
    dims along ``axis``. int8 rounds (half to even); fp8 casts (the
    format's own rounding)."""
    red = tuple(d for d in range(w.dim()) if d != axis)
    amax = w.abs().amax(dim=red, keepdim=True)
    qmax = _QMAX[mode]
    scale = _scale_of(amax, qmax)
    if mode == "int8":
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(w / scale, -qmax, qmax).to(quant_dtype(mode))
    return q, scale


def _quantize_act(x, x_scale, dt, qmax, integral):
    """Dynamic (``x_scale`` None: the per-tensor amax of x) or static (a
    calibrated 0-d scale) quantized activations in the weight's dtype."""
    if x_scale is None:
        x_scale = _scale_of(x.abs().amax(), qmax)
    # a calibrated scale is a Python float in JAX, weakly typed: x divides
    # by it in x's dtype, and the rescale takes it in fp32
    div = x_scale.to(x.dtype)
    if integral:
        qx = torch.clamp(torch.round(x / div), -qmax, qmax).to(dt)
    else:
        qx = torch.clamp(x / div, -qmax, qmax).to(dt)
    return qx, x_scale


def _ceil(n, m):
    return -(-n // m) * m


def _pad2(t, rows, cols):
    """``t`` (R, C) zero-padded to (rows, cols); ``t`` itself when it fits."""
    R, C = t.shape
    if (R, C) == (rows, cols):
        return t
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:R, :C] = t
    return out


def lowbit_matmul(qx, qw):
    """qx (M, K) @ qw (N, K)^T for int8 or fp8 operands of one dtype, in
    int32 (int8) or fp32 (fp8), through the dtype's fixed route (module
    docstring)."""
    M, K = qx.shape
    N = qw.shape[0]
    Kp, Np = _ceil(K, 16), _ceil(N, 16)
    Mp = 32 if M <= 16 else _ceil(M, 8)
    a = _pad2(qx.contiguous(), Mp, Kp)
    b = _pad2(qw.contiguous(), Np, Kp).t()   # (Kp, Np), column-major
    if qx.dtype == torch.int8:
        acc = torch._int_mm(a, b)
    elif qx.dtype == torch.float8_e4m3fn:
        one = torch.ones((), dtype=torch.float32, device=qx.device)
        acc = torch._scaled_mm(a, b, one, one, out_dtype=torch.float32)
    elif qx.dtype == torch.float8_e5m2:
        acc = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    else:
        raise TypeError("lowbit_matmul takes int8 or fp8, got %s" % qx.dtype)
    return acc[:M, :N]


@register_op("quantized_fully_connected")
def quantized_fully_connected(x, qweight, w_scale, bias=None, *,
                              x_scale=None):
    """x fp -> quantized (dynamic per-tensor, or static when a calibrated
    ``x_scale`` is given); the low-bit product (int32 for int8 weights,
    fp32 for fp8); fp32 rescale and bias. qweight (out, in) int8/fp8,
    w_scale (out, 1) fp32; returns fp32 of x's shape with the last axis
    ``out``."""
    qmax, integral = _dtype_qparams(qweight.dtype)
    qx, x_scale = _quantize_act(x, x_scale, qweight.dtype, qmax, integral)
    acc = lowbit_matmul(qx.reshape(-1, qx.shape[-1]), qweight)
    acc = acc.reshape(tuple(x.shape[:-1]) + (qweight.shape[0],))
    y = acc.to(torch.float32) * (x_scale * w_scale.reshape(-1))
    if bias is not None:
        y = y + bias
    return y




def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def im2col(x, kernel, stride, pad, dilate):
    """The windows of ``x`` (N, C, *S), zero-padded by ``pad`` on both
    sides of each spatial axis, as rows: ((N * prod(out), C * prod(kernel)),
    out), a row's columns in (C, k...) order, the order of an (O, C, k...)
    weight flattened. Views of ``x`` and one copy, in x's dtype."""
    nd = x.dim() - 2
    flat = []
    for p in reversed(pad):
        flat += [p, p]
    x = TF.pad(x, flat)
    for i in range(nd):
        x = x.unfold(2 + i, (kernel[i] - 1) * dilate[i] + 1, stride[i])
    x = x[(Ellipsis,) + tuple(slice(None, None, d) for d in dilate)]
    N, C = x.shape[:2]
    out = tuple(x.shape[2:2 + nd])
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) + tuple(
        range(2 + nd, 2 + 2 * nd))
    return x.permute(perm).reshape(N * math.prod(out),
                                   C * math.prod(kernel)), out


def quantized_conv_acc(qx, qweight, stride=1, pad=0, dilate=1, num_group=1):
    """The quantized convolution's accumulator: qx (N, C, *S) and qweight
    (O, C / groups, k...) of one low-bit dtype; (N, O, *out) int32 for
    int8, fp32 for fp8, through :func:`lowbit_matmul` per group."""
    nd = qx.dim() - 2
    kernel = tuple(qweight.shape[2:])
    rows, out = im2col(qx, kernel, _ntuple(stride, nd), _ntuple(pad, nd),
                       _ntuple(dilate, nd))
    O, G = qweight.shape[0], num_group
    w = qweight.reshape(O, -1)
    if G == 1:
        acc = lowbit_matmul(rows, w)
    else:
        K = w.shape[1]
        rows = rows.reshape(rows.shape[0], G, K)
        Og = O // G
        acc = torch.cat([lowbit_matmul(rows[:, g], w[g * Og:(g + 1) * Og])
                         for g in range(G)], dim=1)
    acc = acc.reshape((qx.shape[0],) + out + (O,))
    return acc.permute((0, nd + 1) + tuple(range(1, nd + 1)))


@register_op("quantized_conv")
def quantized_conv(x, qweight, w_scale, bias=None, *, stride=1, pad=0,
                   dilate=1, num_group=1, x_scale=None):
    """x fp -> quantized per tensor (dynamic, or static with a calibrated
    ``x_scale``); the low-bit convolution with qweight (O, I / groups,
    k...) int8/fp8 (:func:`quantized_conv_acc`); fp32 rescale by
    ``x_scale * w_scale`` per output channel (w_scale (O, 1, ...) fp32) and
    bias. Returns fp32 (N, O, *out)."""
    nd = x.dim() - 2
    qmax, integral = _dtype_qparams(qweight.dtype)
    qx, x_scale = _quantize_act(x, x_scale, qweight.dtype, qmax, integral)
    acc = quantized_conv_acc(qx, qweight, stride, pad, dilate, num_group)
    shape = (1, -1) + (1,) * nd
    y = acc.to(torch.float32) * (x_scale * w_scale.reshape(-1)).reshape(
        shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y
