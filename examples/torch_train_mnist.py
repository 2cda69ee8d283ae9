#!/usr/bin/env python
"""MNIST training on the PyTorch port (the twin of
``examples/train_mnist.py``; gluon imperative + hybridize, mirroring the
reference's example/gluon/mnist.py). Synthetic images unless ``--root``
holds the idx-gz files; a ``DataLoader`` with one worker process.

    python examples/torch_train_mnist.py [--epochs 2] [--device cpu]
"""
import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, gluon  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.gluon.data.vision import transforms  # noqa: E402

ROOT = os.path.join(REPO, "_work", "datasets", "mnist")


def make_net():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(128, activation="relu"),
            gluon.nn.Dense(64, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    return net


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--samples", type=int, default=1024,
                    help="synthetic dataset size (without the files)")
    ap.add_argument("--max-batches", type=int, default=0,
                    help="stop each epoch after this many (0: all)")
    ap.add_argument("--shuffle", type=int, default=1)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"losses", "accuracy", "seconds"}; ``weights`` ({name:
    array}) replace the initial parameters (``convert.carry_params``)."""
    args = parse(argv)
    with context_from_device(resolve_device(args.device)):
        mx.random.seed(0)
        net = make_net()
        if weights is not None:
            from mxnet_tpu_torch.convert import carry_params

            net(mx.nd.zeros((1, 784)))  # the deferred shapes first
            carry_params(net, weights)
        net.hybridize()

        to_tensor = transforms.ToTensor()
        train_ds = gluon.data.vision.MNIST(
            root=args.root, train=True,
            synthetic_size=args.samples).transform_first(to_tensor)
        loader = gluon.data.DataLoader(train_ds, batch_size=args.batch_size,
                                       shuffle=bool(args.shuffle),
                                       num_workers=args.workers)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": args.lr, "momentum": 0.9})
        metric = mx.metric.Accuracy()
        losses = []
        t0 = time.perf_counter()
        try:
            for epoch in range(args.epochs):
                metric.reset()
                for nb, (data, label) in enumerate(loader, 1):
                    data = data.reshape(data.shape[0], -1)
                    with autograd.record():
                        out = net(data)
                        loss = loss_fn(out, label.astype("float32"))
                    loss.backward()
                    trainer.step(data.shape[0])
                    metric.update(label, out)
                    losses.append(float(loss.mean().asscalar()))
                    if nb == args.max_batches:
                        break
                print("epoch %d %s=%.4f" % (epoch, *metric.get()))
        finally:
            if hasattr(loader, "close"):
                loader.close()
    return {"losses": losses, "accuracy": metric.get()[1],
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
