"""Dynamic-batching inference serving on the PyTorch port (the twin of
``examples/serve_model.py``).

Mirrors the reference's mxnet-model-server flow (archive → load → worker
handlers calling Module.predict) in-process: export a trained block,
warm-start it through ``serve.load`` (dtype-exact: a bf16 model reloads as
bf16), and serve a stream of single requests through the dynamic batcher
(batch-size buckets, each one CUDA graph captured at warmup on a card,
deadline coalescing, typed load shedding) with a latency/throughput
snapshot at the end. The default model is the JAX example's ResNet-18 at
CIFAR shape; ``--layers 50 --image-size 224 --classes 1000
--no-thumbnail`` serves ResNet-50 at ImageNet width.

Run: python examples/torch_serve_model.py [--requests 512] [--buckets 1,8,32]
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--buckets", default="1,8,32")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--layers", type=int, default=18)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--no-thumbnail", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {"rows" (each request's output, in order), "samples",
    "warm_stats" (after the warmup's captures), "stats" (after the
    traffic), "seconds", "block" (the served SymbolBlock), "server" (the
    stopped server, its bucket programs kept)}."""
    args = parse(argv)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    size = args.image_size
    device = resolve_device(args.device)
    with context_from_device(device) as ctx:
        mx.random.seed(0)
        # a "trained" model, exported like a deploy job
        net = get_resnet(1, args.layers, classes=args.classes,
                         thumbnail=not args.no_thumbnail)
        net.initialize()
        net(nd.array(np.zeros((1, 3, size, size), np.float32)))
        net.hybridize()
        with tempfile.TemporaryDirectory() as d:
            mx.checkpoint.save_for_serving(d + "/model", net, epoch=0,
                                           input_shapes=[(1, 3, size, size)])
            blk = mx.serve.load(d + "/model", epoch=0, ctx=ctx)
        del net

        srv = mx.serve.ModelServer(blk, [((3, size, size), "float32")],
                                   buckets=buckets,
                                   max_wait_ms=args.max_wait_ms,
                                   max_queue=4096, timeout_ms=30000.0,
                                   device=device)
        warm = srv.stats()
        rng = np.random.default_rng(0)
        samples = [rng.normal(size=(3, size, size)).astype(np.float32)
                   for _ in range(args.requests)]
        with srv:
            t0 = time.perf_counter()
            handles = [srv.submit(s) for s in samples]
            outs = [h.result(30) for h in handles]
            dt = time.perf_counter() - t0
        assert len(outs) == args.requests
        snap = srv.stats()
    print("served %d requests in %.3fs (%.0f req/s)"
          % (args.requests, dt, args.requests / dt))
    print("batches=%d  mean_batch=%s  fill=%s  p50=%sms  p99=%sms  "
          "shed=%d  timeouts=%d"
          % (snap["batches"], snap["mean_batch_size"],
             snap["batch_fill_ratio"], snap["p50_ms"], snap["p99_ms"],
             snap["shed"], snap["timeouts"]))
    return {"rows": outs, "samples": samples, "warm_stats": warm,
            "stats": snap, "seconds": dt, "block": blk, "server": srv}


if __name__ == "__main__":
    main()
