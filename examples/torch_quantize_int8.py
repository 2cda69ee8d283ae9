"""int8 inference with calibrated activation scales on the PyTorch port
(the twin of ``examples/quantize_int8.py``).

Mirrors the reference's quantization example (incubator-mxnet
example/quantization/imagenet_inference.py): take a trained fp32 model,
calibrate activation ranges on a handful of batches, swap layers for their
int8 twins, and compare. The int8 products accumulate in int32 and are
rescaled in fp32.

Run: python examples/torch_quantize_int8.py [--mode naive|entropy]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet  # noqa: E402
from mxnet_tpu_torch.quantization import (_quantized_layers,  # noqa: E402
                                          quantize_model)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="entropy", choices=["naive", "entropy"])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"scales" (each quantized layer's activation scale, in
    order), "rel_err", "agreement", "ms"}; ``weights`` ({name: array})
    replace the initial parameters (``convert.carry_params``)."""
    args = parse(argv)
    with context_from_device(resolve_device(args.device)):
        mx.random.seed(0)
        net = get_resnet(1, 18, classes=10, thumbnail=True)
        net.initialize()

        rng = np.random.RandomState(0)
        calib = [nd.array(rng.randn(args.batch_size, 3, 32, 32)
                          .astype(np.float32))
                 for _ in range(args.batches)]
        x = calib[0]
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            net(x)  # the deferred shapes first
            carry_params(net, weights)

        ref = net(x).asnumpy()

        # calibrate + swap in place; calibration must run before hybridize()
        quantize_model(net, calib_mode=args.mode, calib_data=calib)
        net.hybridize()

        t0 = time.perf_counter()
        out = net(x).asnumpy()
        ms = (time.perf_counter() - t0) * 1e3
        print("int8 forward (%s calibration): %.1f ms" % (args.mode, ms))

        rel = np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6)
        agree = (out.argmax(-1) == ref.argmax(-1)).mean()
        print("max relative error vs fp32: %.4f" % rel)
        print("top-1 agreement: %.0f%%" % (100 * agree))
        scales = [float(q._x_scale) for q in _quantized_layers(net, [])]
    return {"scales": scales, "rel_err": float(rel),
            "agreement": float(agree), "ms": ms}


if __name__ == "__main__":
    main()
