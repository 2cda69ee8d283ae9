"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``; ref:
python/mxnet/callback.py)."""
from __future__ import annotations

import logging
import time

import numpy as np

from .model import BatchEndParam  # noqa: F401

__all__ = ["Speedometer", "BatchEndParam", "module_checkpoint",
           "do_checkpoint", "LogValidationMetricsCallback", "ProgressBar",
           "log_train_metric"]


class Speedometer:
    """(ref: callback.py:Speedometer) Samples a second, logged every
    ``frequent`` batches; ``speeds`` keeps each reading."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.speeds = []

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (time.time()
                                                           - self.tic)
                self.speeds.append(speed)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d] Speed: %.2f samples/sec %s" % (
                        param.epoch, count, speed,
                        " ".join("%s=%f" % nv for nv in name_value))
                else:
                    msg = "Epoch[%d] Batch [%d] Speed: %.2f samples/sec" % (
                        param.epoch, count, speed)
                logging.info(msg)
                print(msg)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback saving ``mod`` in the checkpoint layout (ref:
    callback.py:module_checkpoint)."""
    period = max(int(period), 1)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1)

    return _callback


def do_checkpoint(prefix, period=1):
    """(ref: callback.py:do_checkpoint) ``prefix-%04d.params`` as a plain
    npz of the arguments' ``asnumpy()`` (the JAX package's file), and the
    symbol's JSON."""

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            arrs = {k: v.asnumpy() for k, v in (arg or {}).items()}
            with open("%s-%04d.params" % (prefix, iter_no + 1), "wb") as f:
                np.savez(f, **arrs)
            if sym is not None:
                sym.save("%s-symbol.json" % prefix)

    return _callback


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                             value)


class ProgressBar:
    """(ref: callback.py:ProgressBar) A text bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.length - filled)
        logging.info("[%s] %s%%", bar, pct)


def log_train_metric(period, auto_reset=False):
    """(ref: callback.py:log_train_metric) The metric logged every
    ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback
