"""``mxnet_tpu_torch.quant``: the quantized-inference façade (counterpart
of ``mxnet_tpu/quant``).

* Weight quantization: :func:`quantize_model` swaps every eligible
  ``Dense`` for its quantized twin (symmetric per-channel ``int8``, or
  ``e4m3``/``e5m2`` fp8 where :func:`fp8_supported` says the device can).
* Calibration: :func:`calibrate_model` freezes static activation scales
  (``naive`` amax or KL ``entropy`` thresholds).
* Quantized serving: ``serve.ModelServer(..., quantize="int8")`` and
  ``serve.GenerativeServer(..., quantize="int8")``; the generative path
  also keeps its paged KV cache as int8 pages with per-page-per-head
  scales (about half the bf16 bytes).
* Persistence: quantized weights are Parameters, so parameter files carry
  them bit for bit between the packages.

The implementation lives in :mod:`mxnet_tpu_torch.quantization`::

    from mxnet_tpu_torch import quant
    quant.quantize_model(net, mode="int8", calib_mode="entropy",
                         calib_data=[batch])
"""
from ..quantization import (QuantizedConv2D, QuantizedDense,  # noqa: F401
                            calibrate_model, dequantize, fp8_supported,
                            lowbit_matmul, quant_dtype, quantize,
                            quantize_model, quantize_weight, quantized_conv,
                            quantized_fully_connected, stats)

__all__ = ["quantize", "dequantize", "quantize_weight",
           "quantized_fully_connected", "quantized_conv", "QuantizedDense",
           "QuantizedConv2D", "quantize_model", "calibrate_model",
           "fp8_supported", "quant_dtype", "stats", "lowbit_matmul"]
