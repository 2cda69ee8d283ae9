"""int8/fp8 quantization (counterpart of ``mxnet_tpu/quantization.py``).

Symmetric per-channel quantized weights and dynamic (or calibrated static)
per-tensor quantized activations, accumulated in int32 for int8 and in
fp32 for fp8, then rescaled in fp32: the JAX package's recipe, op for op.
``quantize_model`` swaps the eligible ``Dense`` and ``Conv2D`` layers in
place for :class:`QuantizedDense` and :class:`QuantizedConv2D`, whose
quantized weights are grad-less Parameters under the JAX names
(``qweight``, ``w_scale``, ``bias``), so parameter files cross between the
packages bit for bit. The arithmetic (quantize, dequantize, the low-bit
products and the route each dtype takes) lives in
:mod:`mxnet_tpu_torch.ops.lowbit`, as ``F`` ops.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import resolve_device
from .gluon import nn
from .gluon.block import HybridBlock
from .ops.lowbit import (_FP8_DTYPES, _QMAX, dequantize,  # noqa: F401
                         lowbit_matmul, quant_dtype, quantize,
                         quantize_weight, quantized_conv,
                         quantized_fully_connected)

__all__ = ["quantize", "dequantize", "quantize_weight",
           "quantized_fully_connected", "quantized_conv", "QuantizedDense",
           "QuantizedConv2D", "quantize_model", "calibrate_model",
           "fp8_supported", "quant_dtype", "stats", "lowbit_matmul"]

# capability-probe cache: (mode, device type) -> bool
_FP8_SUPPORT = {}

# telemetry (the same fixed keys as the JAX package's ``stats()``);
# quantize_model and calibrate_model update it
_QUANT_STATS = {
    "quantized_layers": 0,
    "weight_bytes_quantized": 0,
    "weight_bytes_fp32": 0,
    "calibrated_layers": 0,
    "calib_mode": "none",
    "mode": "none",
}


def stats():
    """Quantization telemetry snapshot."""
    return dict(_QUANT_STATS)


def _probe_device():
    # the port's default device: the card, or DeviceError without one
    return resolve_device(None)


def fp8_supported(mode="e4m3", device=None):
    """True when the port can compute the ``mode`` product (``e4m3`` or
    ``e5m2``) on ``device`` (default: the current CUDA device; without one
    it raises ``DeviceError`` unless ``device="cpu"`` is asked for): its
    route runs once on a tiny product there, cached per mode and device
    type, as the JAX package probes its backend once. ``int8`` is always
    True."""
    if mode == "int8":
        return True
    if mode not in _FP8_DTYPES:
        return False
    dev = _probe_device() if device is None else torch.device(device)
    key = (mode, dev.type)
    got = _FP8_SUPPORT.get(key)
    if got is None:
        a = torch.ones((2, 16), device=dev).to(_FP8_DTYPES[mode])
        try:
            out = lowbit_matmul(a, a)
            got = bool(out.shape == (2, 2) and float(out[0, 0]) == 16.0)
        except RuntimeError:  # the library refuses the dtype on this device
            got = False
        _FP8_SUPPORT[key] = got
    return got


def _check_mode(mode, device=None):
    if mode not in _QMAX:
        raise ValueError("quantization mode must be one of %s, got %r"
                         % (sorted(_QMAX), mode))
    if mode != "int8" and not fp8_supported(mode, device):
        raise RuntimeError("fp8 mode %r is not supported on this device "
                           "(capability probe failed); use mode='int8'"
                           % mode)


class _LayerCollector:
    """Input-activation statistics of one layer during calibration
    forwards (host numpy, as in the JAX package)."""

    def __init__(self, mode="naive", num_bins=8001):
        self.mode = mode
        self.num_bins = num_bins
        self.amax = 0.0
        self.hist = None          # allocated in pass 2 (entropy mode)
        self.phase = 1

    def collect(self, x):
        if isinstance(x, torch.Tensor):
            a = x.detach().to(torch.float32).cpu().numpy()
        else:
            a = np.asarray(x)
        a = np.abs(a.astype(np.float32)).ravel()
        if self.phase == 1:
            self.amax = max(self.amax, float(a.max(initial=0.0)))
        else:
            h, _ = np.histogram(a, bins=self.num_bins, range=(0.0, self.amax))
            self.hist = h if self.hist is None else self.hist + h

    def threshold(self):
        if self.mode == "naive" or self.hist is None:
            return self.amax
        return _optimal_threshold(self.hist, self.amax)


def _smooth_distribution(d, eps=1e-4):
    """Move eps mass onto zero entries so the KL stays finite."""
    is_zero = d == 0
    n_zero = int(is_zero.sum())
    n_nonzero = d.size - n_zero
    if n_zero == 0 or n_nonzero == 0:
        return d
    eps1 = eps * n_zero / n_nonzero
    # floor at eps so entries smaller than the deducted mass stay positive
    return np.where(is_zero, eps, np.maximum(d - eps1 * (d > 0), eps))


def _optimal_threshold(hist, amax, num_quantized_bins=255):
    """The KL-divergence-minimizing clip threshold (the TensorRT entropy
    calibration): for each candidate, the reference p is the clipped
    histogram with the clipped mass folded into its edge bin, q the
    255-level quantization of the unfolded clipped histogram."""
    num_bins = hist.size
    if amax <= 0 or hist.sum() == 0:
        return amax
    best_kl, best_i = np.inf, num_bins
    hist = hist.astype(np.float64)
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, (num_bins - num_quantized_bins) // 128)):
        sliced = hist[:i]
        if sliced.sum() == 0:
            continue
        p = sliced.copy()
        p[-1] += hist[i:].sum()             # the reference keeps the clip
        # 255 coarse bins, each coarse bin's mass spread uniformly over its
        # nonzero fine bins
        idx = (np.arange(i) * num_quantized_bins // i).clip(
            0, num_quantized_bins - 1)
        q_coarse = np.bincount(idx, weights=sliced,
                               minlength=num_quantized_bins)
        nz = (sliced != 0).astype(np.float64)
        nz_count = np.bincount(idx, weights=nz, minlength=num_quantized_bins)
        q = np.where(nz > 0,
                     q_coarse[idx] / np.maximum(nz_count[idx], 1.0), 0.0)
        p = _smooth_distribution(p / p.sum())
        q = _smooth_distribution(q / max(q.sum(), 1e-12))
        kl = float(np.sum(p * np.log(p / q)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return amax * best_i / num_bins


class QuantizedDense(HybridBlock):
    """Inference-only Dense with pre-quantized int8/fp8 weights.

    ``qweight`` (out, in), ``w_scale`` (out, 1) fp32 and ``bias`` fp32 are
    grad-less Parameters under the Dense's prefix, so ``save_parameters``,
    ``load_parameters`` and a server's weight swap carry them like any
    other weight. The output is fp32, as in the JAX package."""

    def __init__(self, dense, mode="int8", **kwargs):
        super().__init__(prefix=dense.prefix, **kwargs)
        w = dense.weight._tensor().detach().to(torch.float32)
        _check_mode(mode, w.device)
        qw, ws = quantize_weight(w, axis=0, mode=mode)
        self._mode = mode
        self.qweight = self.params.get("qweight", shape=tuple(qw.shape),
                                       dtype=quant_dtype(mode),
                                       grad_req="null")
        self.qweight.set_data(qw)
        self.w_scale = self.params.get("w_scale", shape=tuple(ws.shape),
                                       dtype="float32", grad_req="null")
        self.w_scale.set_data(ws.to(torch.float32))
        if getattr(dense, "bias", None) is not None:
            b = dense.bias._tensor().detach().to(torch.float32)
            self.bias = self.params.get("bias", shape=tuple(b.shape),
                                        dtype="float32", grad_req="null")
            self.bias.set_data(b)
        self._flatten = dense._flatten
        self._act = dense.act
        self._x_scale = None      # static activation scale (0-d fp32)
        self._collector = None

    def hybrid_forward(self, F, x, qweight, w_scale, bias=None):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        if self._collector is not None:
            self._collector.collect(x)
        y = F.quantized_fully_connected(x, qweight, w_scale, bias,
                                        x_scale=self._x_scale)
        if self._act is not None:
            y = self._act(y)
        return y


class QuantizedConv2D(HybridBlock):
    """Inference-only Conv2D with pre-quantized per-output-channel weights
    (ref: quantized_conv.cc): ``qweight`` (O, I / groups, kh, kw),
    ``w_scale`` (O, 1, 1, 1) fp32 and ``bias`` fp32, grad-less Parameters
    under the Conv2D's prefix (see :class:`QuantizedDense`). The output is
    fp32, as in the JAX package."""

    def __init__(self, conv, mode="int8", **kwargs):
        super().__init__(prefix=conv.prefix, **kwargs)
        w = conv.weight._tensor().detach().to(torch.float32)
        _check_mode(mode, w.device)
        qw, ws = quantize_weight(w, axis=0, mode=mode)
        self._mode = mode
        self.qweight = self.params.get("qweight", shape=tuple(qw.shape),
                                       dtype=quant_dtype(mode),
                                       grad_req="null")
        self.qweight.set_data(qw)
        self.w_scale = self.params.get("w_scale", shape=tuple(ws.shape),
                                       dtype="float32", grad_req="null")
        self.w_scale.set_data(ws.to(torch.float32))
        if getattr(conv, "bias", None) is not None:
            b = conv.bias._tensor().detach().to(torch.float32)
            self.bias = self.params.get("bias", shape=tuple(b.shape),
                                        dtype="float32", grad_req="null")
            self.bias.set_data(b)
        k = conv._kwargs
        self._conv_kw = dict(stride=k["stride"], pad=k["pad"],
                             dilate=k["dilate"], num_group=k["num_group"])
        self._act = conv.act
        self._x_scale = None      # static activation scale (0-d fp32)
        self._collector = None

    def hybrid_forward(self, F, x, qweight, w_scale, bias=None):
        if self._collector is not None:
            self._collector.collect(x)
        y = F.quantized_conv(x, qweight, w_scale, bias,
                             x_scale=self._x_scale, **self._conv_kw)
        if self._act is not None:
            y = self._act(y)
        return y


_QUANTIZED = (QuantizedDense, QuantizedConv2D)


def _quantized_layers(block, out):
    for child in block._children.values():
        if isinstance(child, _QUANTIZED):
            out.append(child)
        else:
            _quantized_layers(child, out)
    return out


def _param_device(block):
    """The device of the block's first materialized parameter; for a bare
    skeleton the port's default device (the card, ``DeviceError`` without
    one), never the CPU unasked."""
    for p in block.collect_params().values():
        if p.device is not None:
            return p.device
    return resolve_device(None)


def _as_input(x, device):
    """A calibration input on ``device``: a tensor, an ``NDArray`` (its
    tensor) or anything numpy takes."""
    from .ndarray import NDArray

    if isinstance(x, NDArray):
        x = x._data
    return x.to(device) if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x), device=device)


def calibrate_model(block, calib_data, mode="naive", num_bins=8001):
    """Freeze static activation scales from calibration batches
    (``naive``: the amax; ``entropy``: the KL threshold of a second,
    histogram pass over the same batches). ``calib_data`` is an iterable
    of the net's positional input (or tuples of them), tensors, NDArrays
    or numpy arrays, moved to the parameters' device. The port runs eagerly, so the
    collectors see every forward and no compiled program needs dropping."""
    if mode not in ("naive", "entropy"):
        raise ValueError("calib mode must be 'naive' or 'entropy', got %r"
                         % (mode,))
    calib_data = list(calib_data)
    if not calib_data:
        raise ValueError("calib_data is empty: zero calibration batches "
                         "would freeze degenerate activation scales")
    layers = _quantized_layers(block, [])
    if not layers:
        return block
    for l in layers:
        l._collector = _LayerCollector(mode, num_bins)
        l._x_scale = None         # dynamic during calibration forwards
    device = _param_device(block)

    def _run():
        with torch.no_grad():
            for batch in calib_data:
                if isinstance(batch, tuple):
                    block(*[_as_input(b, device) for b in batch])
                else:
                    block(_as_input(batch, device))

    try:
        _run()                    # pass 1: amax
        if mode == "entropy":
            for l in layers:
                l._collector.phase = 2
            _run()                # pass 2: histograms over [0, amax]
        for l in layers:
            t = l._collector.threshold()
            # JAX's Python float max(t, 1e-8) / qmax, as a 0-d fp32 tensor
            l._x_scale = torch.full((), max(t, 1e-8) / _QMAX[l._mode],
                                    dtype=torch.float32, device=device)
    finally:
        for l in layers:
            l._collector = None
    _QUANT_STATS["calibrated_layers"] = len(layers)
    _QUANT_STATS["calib_mode"] = mode
    return block


def _swap_children(block, exclude, mode):
    swapped = []
    for name, child in list(block._children.items()):
        if isinstance(child, _QUANTIZED):
            continue              # idempotent
        q = None
        if not any(e in child.prefix for e in exclude):
            if isinstance(child, nn.Dense):
                q = QuantizedDense(child, mode=mode)
            elif isinstance(child, nn.Conv2D):
                # as in the JAX package, a convolution is quantized to int8
                # in every mode: fp8 targets the Dense products
                q = QuantizedConv2D(child, mode="int8")
        if q is not None:
            setattr(block, name, q)
            swapped.append(q)
        else:
            swapped.extend(_swap_children(child, exclude, mode))
    return swapped


def quantize_model(block, exclude=(), mode="int8", calib_mode="none",
                   calib_data=None, num_bins=8001):
    """Replace the ``Dense`` and ``Conv2D`` children with
    :class:`QuantizedDense` and :class:`QuantizedConv2D` (int8 whatever
    ``mode``) in place, skipping prefixes that contain any substring of
    ``exclude``;
    optionally calibrate static activation ranges (``calib_mode`` none,
    naive or entropy, against ``calib_data``). ``mode``: int8, or e4m3/e5m2
    where :func:`fp8_supported` says so. Safe to call on a quantized model
    (its quantized layers are kept)."""
    _check_mode(mode, _param_device(block))
    swapped = _swap_children(block, exclude, mode)
    if swapped:
        qb = fb = 0
        layers = _quantized_layers(block, [])
        for q in layers:
            qw = q.qweight._tensor()
            qb += qw.numel() * qw.element_size() \
                + q.w_scale._tensor().numel() * 4
            fb += qw.numel() * 4
        _QUANT_STATS["quantized_layers"] = len(layers)
        _QUANT_STATS["weight_bytes_quantized"] = int(qb)
        _QUANT_STATS["weight_bytes_fp32"] = int(fb)
        _QUANT_STATS["mode"] = mode
    if calib_mode != "none":
        if calib_data is None:
            raise ValueError("calib_mode=%r requires calib_data"
                             % (calib_mode,))
        calibrate_model(block, calib_data, mode=calib_mode,
                        num_bins=num_bins)
    return block
