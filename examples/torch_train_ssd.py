#!/usr/bin/env python
"""SSD detection training on the PyTorch port (the twin of
``examples/train_ssd.py``; bench config #4, mirrors gluoncv's
train_ssd.py) on synthetic boxes: multibox targets, the loss, then
detection with NMS on the device.

    python examples/torch_train_ssd.py [--steps 5] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon, nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.models.ssd import SSD, SSDLoss  # noqa: E402


def synthetic_batch(rng, batch=4, size=128, num_classes=3):
    imgs = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    labels = np.zeros((batch, 2, 5), np.float32)
    for b in range(batch):
        for k in range(2):
            cls = rng.integers(0, num_classes)
            x1, y1 = rng.uniform(0, 0.5, 2)
            w, h = rng.uniform(0.2, 0.45, 2)
            labels[b, k] = [cls, x1, y1, min(x1 + w, 1.0), min(y1 + h, 1.0)]
    return nd.array(imgs), nd.array(labels)


def make_net(num_classes=3):
    net = SSD(num_classes=num_classes, sizes=((0.2, 0.3), (0.45, 0.55)),
              ratios=((1, 2, 0.5),) * 2)
    net.initialize(mx.init.Xavier())
    return net


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


NUM_CLASSES = 3


def main(argv=None, weights=None):
    """Returns {"losses", "detections", "seconds"}; ``weights`` ({name:
    array}) replace the initial parameters (``convert.carry_params``)."""
    args = parse(argv)
    device = resolve_device(args.device)
    with context_from_device(device):
        mx.random.seed(0)
        net = make_net(NUM_CLASSES)
        rng = np.random.default_rng(0)
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            net(nd.zeros((1, 3, args.size, args.size)))  # deferred shapes
            carry_params(net, weights)
        loss_fn = SSDLoss(NUM_CLASSES)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9,
                                 "wd": 5e-4})
        losses = []
        t0 = time.perf_counter()
        for step in range(args.steps):
            x, labels = synthetic_batch(rng, args.batch, args.size,
                                        NUM_CLASSES)
            with autograd.record():
                cls_preds, box_preds, anchors = net(x)
                L = loss_fn(cls_preds, box_preds, labels, anchors).mean()
            L.backward()
            trainer.step(x.shape[0])
            losses.append(float(L.asscalar()))
            print("step %d loss %.4f" % (step, losses[-1]))
        det = net.detect(x, device=device)
        print("detections:", tuple(det.shape))
    return {"losses": losses, "detections": tuple(det.shape),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
