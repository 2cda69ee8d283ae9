#!/usr/bin/env python
"""Keras-style training with ``gluon.contrib.estimator`` on the PyTorch
port (the twin of ``examples/train_estimator.py``): the event-handler
workflow (logging each epoch, the best checkpoint by validation accuracy,
early stopping) over a small MLP on synthetic data, so it needs no
downloads. The checkpoints go to a temporary directory that is removed at
the end, unless ``--ckpt-dir`` names one to keep.

    python examples/torch_train_estimator.py [--epochs 20] [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import nd  # noqa: E402
from mxnet_tpu_torch.base import resolve_device  # noqa: E402
from mxnet_tpu_torch.context import context_from_device  # noqa: E402
from mxnet_tpu_torch.gluon import Trainer, loss as gloss, nn  # noqa: E402
from mxnet_tpu_torch.gluon.contrib.estimator import (  # noqa: E402
    BatchEnd, CheckpointHandler, EarlyStoppingHandler, Estimator,
    LoggingHandler)


def make_data(n, seed):
    """The original's batches of 32: x (32, 20) normal, y the argmax of a
    fixed linear map plus noise (5 classes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 20)).astype(np.float32)
    w = np.linspace(-1, 1, 20 * 5).reshape(20, 5).astype(np.float32)
    y = (x @ w + 0.1 * rng.normal(size=(n, 5))).argmax(1)
    return [(nd.array(x[i:i + 32]), nd.array(y[i:i + 32]))
            for i in range(0, n, 32)]


def make_net():
    net = nn.Sequential()
    net.add(nn.Dense(64, activation="relu"), nn.Dense(5))
    net.initialize(mx.init.Xavier())
    return net


class LossRecorder(BatchEnd):
    """Each batch's mean loss, as the step computed it."""

    def __init__(self):
        self.losses = []

    def batch_end(self, estimator, batch=None):
        self.losses.append(float(estimator._last_loss.mean().asscalar()))


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--samples", type=int, default=2048,
                    help="training samples (validation: a quarter)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep the checkpoints here (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, weights=None):
    """Returns {"losses", "val_accuracy", "checkpoints", "epochs_run"};
    ``weights`` ({name: array}) replace the initial parameters
    (``convert.carry_params``)."""
    args = parse(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_est_ckpt_")
    try:
        with context_from_device(resolve_device(args.device)):
            mx.random.seed(0)
            net = make_net()
            if weights is not None:
                from mxnet_tpu_torch.convert import carry_params

                net(nd.zeros((1, 20)))  # the deferred shapes first
                carry_params(net, weights)
            est = Estimator(net, gloss.SoftmaxCrossEntropyLoss(),
                            train_metrics=mx.metric.Accuracy(),
                            trainer=Trainer(net.collect_params(), "adam",
                                            {"learning_rate": args.lr}))
            recorder = LossRecorder()
            epochs = []

            class EpochCount(BatchEnd):
                def batch_end(self, estimator, batch=None):
                    if not epochs or epochs[-1] != estimator.current_epoch:
                        epochs.append(estimator.current_epoch)

            est.fit(make_data(args.samples, seed=0),
                    val_data=make_data(args.samples // 4, seed=1),
                    epochs=args.epochs,
                    event_handlers=[
                        LoggingHandler(log_interval="epoch"),
                        CheckpointHandler(ckpt, model_prefix="mlp",
                                          save_best=True,
                                          monitor="validation accuracy",
                                          mode="max", max_checkpoints=3),
                        EarlyStoppingHandler(monitor="validation accuracy",
                                             patience=5, mode="max"),
                        recorder, EpochCount()])
            val = est.val_metrics[0].get()
            print("final validation:", val)
            saved = sorted(os.listdir(ckpt))
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    return {"losses": recorder.losses, "val_accuracy": val[1],
            "checkpoints": saved, "epochs_run": len(epochs)}


if __name__ == "__main__":
    main()
