"""Estimator: a Keras-style fit loop with composable event handlers
(counterpart of ``mxnet_tpu/gluon/contrib/estimator.py``; ref:
python/mxnet/gluon/contrib/estimator/estimator.py and event_handler.py).

The loop is host orchestration: the device work (forward under
``autograd.record``, ``autograd.backward``, ``Trainer.step``) is the
port's usual path, so the handlers add no device work of their own.
Checkpoints are ``save_parameters`` files and the Trainer's state files,
both readable by the JAX package.

Handlers implement any subset of the six event mixins (TrainBegin,
EpochBegin, BatchBegin, BatchEnd, EpochEnd, TrainEnd); `fit` fires them in
that order around the loop. The default set (MetricHandler, ValidationHandler
when val_data is given, LoggingHandler, StoppingHandler) mirrors upstream's
`_prepare_default_handlers`.
"""
from __future__ import annotations

import copy
import os
import re
import time
import warnings

from ... import autograd
from ... import metric as metric_mod
from ..trainer import Trainer

__all__ = [
    "Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
    "BatchBegin", "BatchEnd", "MetricHandler", "ValidationHandler",
    "LoggingHandler", "StoppingHandler", "CheckpointHandler",
    "EarlyStoppingHandler",
]


# ---- event mixins (ref: event_handler.py: EventHandler ABCs) ----------------

class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator, batch=None):
        pass


class BatchEnd:
    def batch_end(self, estimator, batch=None):
        pass


class StopTraining(Exception):
    """Raised (internally) by handlers that set estimator.stop_training."""


_HIGHER_BETTER = ("acc", "f1", "mcc", "auc", "map", "recall", "precision",
                  "pearson", "correlation")


def _resolve_mode(mode, name):
    """'auto' (upstream default) infers the improvement direction from the
    metric name: accuracy-like metrics maximize, losses minimize."""
    if mode != "auto":
        return mode
    n = (name or "").lower()
    return "max" if any(k in n for k in _HIGHER_BETTER) else "min"


def _monitored_value(estimator, monitor, who):
    """(name, value) of the monitored metric, or (None, None) — with a
    one-time warning when `monitor` names no train/val metric, because a
    typo must not silently disable best-tracking/early-stopping."""
    # default monitor prefers VALIDATION metrics: best-checkpoint /
    # early-stop against a train metric would happily save an overfit model
    # (ADVICE r3). A NaN (never-updated) metric is skipped, so before the
    # first validation pass the train metric stands in — with a one-time
    # warning, since silently tracking train for a whole run is the exact
    # failure mode this ordering exists to prevent.
    ordered = (estimator.val_metrics + estimator.train_metrics
               if monitor is None
               else estimator.train_metrics + estimator.val_metrics)
    n_val = len(estimator.val_metrics)
    matched_nan = False
    for mi, m in enumerate(ordered):
        for name, val in m.get_name_value():  # flat even for composites
            if monitor is None or name == monitor:
                if val != val:  # NaN = never updated; keep searching
                    matched_nan = True
                    continue
                if monitor is None and estimator.val_metrics \
                        and mi >= n_val \
                        and not getattr(estimator, "_warned_train_monitor",
                                        False):
                    estimator._warned_train_monitor = True
                    warnings.warn(
                        "%s: validation metrics have no value yet; "
                        "monitoring TRAIN metric %r until validation runs"
                        % (who, name))
                return name, val
    if monitor is None or matched_nan:
        # nothing has a value yet (e.g. before the first batch) — skip this
        # round rather than warn about a typo that isn't one
        return None, None
    warnings.warn("%s: monitored metric %r not found among %s"
                  % (who, monitor,
                     [n for m in estimator.train_metrics
                      + estimator.val_metrics
                      for n, _ in m.get_name_value()]))
    return None, None


class MetricHandler(EpochBegin, BatchEnd):
    """Resets train metrics at epoch start and updates them per batch
    (ref: event_handler.py:MetricHandler). Installed by default."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, batch=None):
        label, pred, loss = (estimator._last_label, estimator._last_pred,
                             estimator._last_loss)
        for m in self.metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(0, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Runs `eval_fn` on val_data every `epoch_period` epochs (and/or every
    `batch_period` batches) and stores results in estimator.val_metrics
    (ref: event_handler.py:ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self._nbatch = 0

    def train_begin(self, estimator):
        self._nbatch = 0

    def batch_end(self, estimator, batch=None):
        self._nbatch += 1
        if self.batch_period and self._nbatch % self.batch_period == 0:
            self.eval_fn(self.val_data)

    def epoch_end(self, estimator):
        if self.epoch_period and (estimator.current_epoch + 1) \
                % self.epoch_period == 0:
            self.eval_fn(self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Periodic throughput + metric logging
    (ref: event_handler.py:LoggingHandler). log_interval in batches, or
    'epoch' to log only at epoch boundaries."""

    def __init__(self, log_interval=50, metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics
        self._t_epoch = 0.0
        self._samples = 0

    def _vals(self, estimator):
        ms = self.metrics if self.metrics is not None else \
            (estimator.train_metrics + estimator.val_metrics)
        return ", ".join("%s=%.4f" % (n, v)
                         for m in ms for n, v in [m.get()])

    def train_begin(self, estimator):
        self._t_train = time.perf_counter()
        print("[estimator] training begin: %d epochs" % (estimator.max_epoch,))

    def train_end(self, estimator):
        print("[estimator] training done in %.1fs: %s"
              % (time.perf_counter() - self._t_train, self._vals(estimator)))

    def epoch_begin(self, estimator):
        self._t_epoch = time.perf_counter()
        self._samples = 0

    def batch_end(self, estimator, batch=None):
        self._samples += estimator._last_batch_size
        if self.log_interval != "epoch" \
                and (estimator.current_batch + 1) % self.log_interval == 0:
            dt = time.perf_counter() - self._t_epoch
            print("epoch %d batch %d: %.1f samples/s, %s"
                  % (estimator.current_epoch, estimator.current_batch,
                     self._samples / max(dt, 1e-9), self._vals(estimator)))

    def epoch_end(self, estimator):
        dt = time.perf_counter() - self._t_epoch
        print("epoch %d done in %.1fs: %s"
              % (estimator.current_epoch, dt, self._vals(estimator)))


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop at max_epoch/max_batch (ref: event_handler.py:StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self._nbatch = 0

    def train_begin(self, estimator):
        self._nbatch = 0
        if self.max_epoch is not None:
            estimator.max_epoch = self.max_epoch

    def batch_end(self, estimator, batch=None):
        self._nbatch += 1
        if self.max_batch is not None and self._nbatch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator):
        if self.max_epoch is not None \
                and estimator.current_epoch + 1 >= self.max_epoch:
            estimator.stop_training = True


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves net params (+ trainer states) every epoch_period epochs or
    batch_period batches; `save_best` keeps <prefix>-best.params per the
    monitored metric; `resume_from_checkpoint` reloads the newest epoch file
    (ref: event_handler.py:CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="auto", save_best=False, epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.mode = mode
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.best = None
        self._nbatch = 0
        self._saved = []

    def _save(self, estimator, tag, rotate=True):
        os.makedirs(self.model_dir, exist_ok=True)
        path = os.path.join(self.model_dir,
                            "%s-%s.params" % (self.model_prefix, tag))
        estimator.net.save_parameters(path)
        if estimator.trainer is not None:
            try:
                estimator.trainer.save_states(path[:-len(".params")]
                                              + ".states")
            except Exception as e:  # params saved; states are best-effort,
                warnings.warn(       # but silence would corrupt a resume
                    "CheckpointHandler: trainer state save failed (%r) — "
                    "resuming from %s will reset optimizer state" % (e, path))
        if rotate:
            self._saved.append(path)
            while len(self._saved) > self.max_checkpoints:
                old = self._saved.pop(0)
                for p in (old, old[:-len(".params")] + ".states"):
                    if os.path.exists(p):
                        os.remove(p)
        return path

    def train_begin(self, estimator):
        self._nbatch = 0
        self._epoch_offset = 0
        if self.resume_from_checkpoint:
            import glob
            cands = glob.glob(os.path.join(
                self.model_dir, self.model_prefix + "-epoch*.params"))
            if cands:  # numeric sort: epoch11 is newer than epoch9
                cands.sort(key=lambda f: int(
                    re.search(r"epoch(\d+)\.params$", f).group(1)))
                newest = cands[-1]
                estimator.net.load_parameters(newest)
                states = newest[:-len(".params")] + ".states"
                if estimator.trainer is not None and os.path.exists(states):
                    estimator.trainer.load_states(states)
                # continue the numbering: the resumed run's saves must sort
                # AFTER the run they resumed from, or a later resume (and
                # rotation) would prefer the older run's files
                self._epoch_offset = 1 + int(
                    re.search(r"epoch(\d+)\.params$", newest).group(1))

    def batch_end(self, estimator, batch=None):
        self._nbatch += 1
        if self.batch_period and self._nbatch % self.batch_period == 0:
            self._save(estimator, "batch%d" % self._nbatch)

    def epoch_end(self, estimator):
        e = estimator.current_epoch
        if self.epoch_period and (e + 1) % self.epoch_period == 0:
            self._save(estimator,
                       "epoch%d" % (e + getattr(self, "_epoch_offset", 0)))
        if self.save_best:
            name, val = _monitored_value(estimator, self.monitor,
                                         "CheckpointHandler(save_best=True)")
            if val is not None:
                mode = _resolve_mode(self.mode, name)
                better = self.best is None or \
                    (val < self.best if mode == "min" else val > self.best)
                if better:
                    self.best = val
                    self._save(estimator, "best", rotate=False)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric hasn't improved by min_delta for
    `patience` epochs (ref: event_handler.py:EarlyStoppingHandler)."""

    def __init__(self, monitor=None, min_delta=0.0, patience=3, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.baseline = baseline
        self.best = None
        self.waiting = 0
        self.stopped_epoch = None

    def train_begin(self, estimator):
        self.best = self.baseline
        self.waiting = 0
        self.stopped_epoch = None

    def epoch_end(self, estimator):
        name, val = _monitored_value(estimator, self.monitor,
                                     "EarlyStoppingHandler")
        if val is None:
            return
        if _resolve_mode(self.mode, name) == "min":
            better = self.best is None or val < self.best - self.min_delta
        else:
            better = self.best is None or val > self.best + self.min_delta
        if better:
            self.best = val
            self.waiting = 0
        else:
            self.waiting += 1
            if self.waiting >= self.patience:
                self.stopped_epoch = estimator.current_epoch
                estimator.stop_training = True

    def train_end(self, estimator):
        if self.stopped_epoch is not None:
            print("[estimator] early stop at epoch %d (best %s=%.4f)"
                  % (self.stopped_epoch, self.monitor or "metric",
                     self.best if self.best is not None else float("nan")))


def _as_metric_list(metrics, default):
    if metrics is None:
        metrics = [default]
    if not isinstance(metrics, (list, tuple)):
        metrics = [metrics]
    out = []
    for m in metrics:
        m = metric_mod.create(m) if isinstance(m, str) else m
        if isinstance(m, metric_mod.CompositeEvalMetric):
            # flatten: handlers monitor/log per-child (name, value) pairs
            out.extend(m.metrics)
        else:
            out.append(m)
    return out


class Estimator:
    """The fit/evaluate loop (ref: estimator.py:Estimator).

    Attributes exposed to handlers: current_epoch, current_batch, max_epoch,
    stop_training, train_metrics, val_metrics, net, trainer, and the
    last-batch tensors (_last_label/_last_pred/_last_loss)."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = _as_metric_list(train_metrics, "accuracy")
        # upstream clones train metrics as "validation X" when not given
        self.val_metrics = _as_metric_list(
            val_metrics, "accuracy") if val_metrics is not None else []
        self.trainer = trainer or Trainer(net.collect_params(), "adam")
        self.stop_training = False
        self.current_epoch = 0
        self.current_batch = 0
        self.max_epoch = 0

    # -- default handler assembly (ref: estimator.py:_prepare_default_handlers)
    def _default_handlers(self, val_data, event_handlers, verbose):
        handlers = list(event_handlers)
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.insert(0, MetricHandler(self.train_metrics))
        if val_data is not None \
                and not any(isinstance(h, ValidationHandler) for h in handlers):
            if not self.val_metrics:
                # upstream clones the train metrics as "validation X";
                # deepcopy preserves custom names/kwargs that a registry
                # round-trip through the display name would lose
                self.val_metrics = []
                for m in self.train_metrics:
                    c = copy.deepcopy(m)
                    c.name = "validation " + c.name
                    c.reset()
                    self.val_metrics.append(c)
            # BEFORE any non-metric handler: checkpoint/early-stop
            # epoch_end must see THIS epoch's validation numbers
            at = next((i for i, h in enumerate(handlers)
                       if not isinstance(h, MetricHandler)), len(handlers))
            handlers.insert(at, ValidationHandler(val_data, self.evaluate))
        if verbose and not any(isinstance(h, LoggingHandler)
                               for h in handlers):
            handlers.append(LoggingHandler())
        return handlers

    def _fire(self, handlers, event, batch=None):
        for h in handlers:
            fn = getattr(h, event, None)
            if fn is None:
                continue
            if event in ("batch_begin", "batch_end"):
                fn(self, batch=batch)
            else:
                fn(self)

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=(),
            batches=None, verbose=False):
        """Train for `epochs` epochs and/or `batches` total batches —
        whichever bound hits first stops the loop (upstream semantics)."""
        if epochs is None and batches is None:
            epochs = 1
        self.stop_training = False
        handlers = self._default_handlers(val_data, event_handlers, verbose)
        if batches is not None:
            handlers.append(StoppingHandler(max_batch=batches))
        if epochs is None:
            epochs = 1 << 30  # batch-bounded run
        self.max_epoch = epochs
        self._fire(handlers, "train_begin")
        for epoch in range(epochs):
            self.current_epoch = epoch
            self._fire(handlers, "epoch_begin")
            ran_batches = 0
            for i, batch in enumerate(train_data):
                ran_batches += 1
                data, label = batch[0], batch[1]
                self.current_batch = i
                self._fire(handlers, "batch_begin", batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                autograd.backward(loss)
                self.trainer.step(data.shape[0])
                self._last_label, self._last_pred = label, pred
                self._last_loss, self._last_batch_size = loss, data.shape[0]
                self._fire(handlers, "batch_end", batch)
                if self.stop_training:
                    break
            self._fire(handlers, "epoch_end")
            if self.stop_training:
                break
            if ran_batches == 0:
                # an empty epoch repeats forever (exhausted one-shot
                # iterator / empty loader) — especially under the
                # batch-bounded 2^30-epoch sentinel
                warnings.warn("fit: train_data yielded no batches in epoch "
                              "%d; stopping" % epoch)
                break
        self._fire(handlers, "train_end")
        return [m.get() for m in self.train_metrics]

    def evaluate(self, val_data, metrics=None):
        ms = _as_metric_list(metrics, "accuracy") if metrics is not None \
            else (self.val_metrics or _as_metric_list(None, "accuracy"))
        for m in ms:
            m.reset()
        for batch in val_data:
            data, label = batch[0], batch[1]
            pred = self.net(data)
            for m in ms:
                if isinstance(m, metric_mod.Loss):
                    m.update(0, self.loss(pred, label))
                else:
                    m.update(label, pred)
        return [m.get() for m in ms]
