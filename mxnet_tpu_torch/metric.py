"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; ref:
python/mxnet/metric.py).

numpy arithmetic over host copies of the labels and predictions, the JAX
package's own, so a metric reads the same in both packages. The registry
(``register``, ``create`` by name, JSON config or ``(name, kwargs)``, the
upstream aliases ``acc``, ``top_k_acc``, ``ce``) is the port's copy of the
JAX package's ``registry.py`` machinery for this one family.
"""
from __future__ import annotations

import json

import numpy
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "CustomMetric",
           "CompositeEvalMetric", "create", "register", "np", "np_metric",
           "check_label_shapes"]

_REGISTRY = {}  # lower-cased name -> EvalMetric subclass


def register(klass, name=None):
    """(ref: registry.py:get_register_func) ``klass`` under its lower-cased
    name (or ``name``)."""
    assert issubclass(klass, EvalMetric), \
        "%s must subclass EvalMetric to register as a metric" % klass
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def _alias(*aliases):
    def reg(klass):
        register(klass)
        for name in aliases:
            register(klass, name)
        return klass

    return reg


def _create_registered(*args, **kwargs):
    """(ref: registry.py:get_create_func) an instance, a registered name, a
    JSON config ``'{"type": name, ...}'`` or a ``(name, kwargs)`` pair."""
    if args and isinstance(args[0], EvalMetric):
        assert len(args) == 1 and not kwargs, \
            "metric instance given: no further arguments allowed"
        return args[0]
    if args and isinstance(args[0], (tuple, list)) and len(args[0]) == 2 \
            and isinstance(args[0][0], str):
        name, conf = args[0]
        conf = dict(conf)
        conf.update(kwargs)
        return _create_registered(name, *args[1:], **conf)
    if args and isinstance(args[0], str):
        name, args = args[0], args[1:]
        if name.startswith("{"):
            conf = json.loads(name)
            name = conf.pop("type")
            conf.update(kwargs)
            kwargs = conf
    else:
        raise ValueError("metric: expected an instance, name, or JSON config")
    if name.lower() not in _REGISTRY:
        raise ValueError("metric %r is not registered (known: %s)"
                         % (name, ", ".join(sorted(_REGISTRY))))
    return _REGISTRY[name.lower()](*args, **kwargs)


def create(metric, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        return CompositeEvalMetric([create(m) for m in metric])
    if callable(metric):
        return CustomMetric(metric, **kwargs)
    return _create_registered(metric, **kwargs)


def _np(x):
    """A host numpy copy (bfloat16 as float32)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return NDArray(x).asnumpy()
    return numpy.asarray(x)


_ARRAYS = (NDArray, numpy.ndarray, torch.Tensor)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))


def _pairs(labels, preds):
    if isinstance(labels, _ARRAYS):
        labels, preds = [labels], [preds]
    return zip(labels, preds)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label), _np(pred)
            if pred.ndim > label.ndim:
                pred = numpy.argmax(pred, axis=self.axis)
            self.sum_metric += float((pred.astype("int64").flat
                                      == label.astype("int64").flat).sum())
            self.num_inst += label.size


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label).astype("int64"), _np(pred)
            topk = numpy.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += float((topk == label[:, None]).any(axis=1)
                                     .sum())
            self.num_inst += label.shape[0]


class _ConfusionMetric(EvalMetric):
    """Per-class tp/fp/fn from one confusion matrix a batch."""

    def reset(self):
        super().reset()
        self.tp = {}
        self.fp = {}
        self.fn = {}

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label).astype("int64").ravel(), _np(pred)
            if pred.ndim > 1:
                pred = numpy.argmax(pred, axis=-1)
            pred = pred.astype("int64").ravel()
            c = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            cm = numpy.bincount(label * c + pred, minlength=c * c).reshape(
                c, c).astype(numpy.float64)
            row = cm.sum(axis=1)
            col = cm.sum(axis=0)
            diag = numpy.diag(cm)
            for k in numpy.nonzero(row + col)[0]:
                k = int(k)
                self.tp[k] = self.tp.get(k, 0.0) + diag[k]
                self.fp[k] = self.fp.get(k, 0.0) + (col[k] - diag[k])
                self.fn[k] = self.fn.get(k, 0.0) + (row[k] - diag[k])
            self.num_inst += 1


@register
class F1(_ConfusionMetric):
    """Micro or macro F1; a binary macro F1 is the positive class's."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average

    @staticmethod
    def _f1(tp, fp, fn):
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        return 2 * prec * rec / max(prec + rec, 1e-12)

    def get(self):
        classes = sorted(self.tp)
        if not classes:
            return self.name, 0.0
        if self.average == "micro":
            return self.name, self._f1(sum(self.tp.values()),
                                       sum(self.fp.values()),
                                       sum(self.fn.values()))
        if classes in ([0, 1], [1], [0]):
            return self.name, self._f1(self.tp.get(1, 0.0),
                                       self.fp.get(1, 0.0),
                                       self.fn.get(1, 0.0))
        scores = [self._f1(self.tp[c], self.fp[c], self.fn[c])
                  for c in classes]
        return self.name, float(numpy.mean(scores))


@register
class MCC(_ConfusionMetric):
    """Binary Matthews correlation coefficient."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        tp = self.tp.get(1, 0.0)
        fp = self.fp.get(1, 0.0)
        fn = self.fn.get(1, 0.0)
        tn = self.tp.get(0, 0.0)
        denom = numpy.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return self.name, float((tp * tn - fp * fn) / max(denom, 1e-12))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(numpy.abs(
                label - pred.reshape(label.shape)).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(((label - pred.reshape(label.shape))
                                      ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, float(numpy.sqrt(value))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label).astype("int64").ravel(), _np(pred)
            prob = pred.reshape(-1, pred.shape[-1])[numpy.arange(label.size),
                                                    label]
            self.sum_metric += float(-numpy.log(prob + self.eps).sum())
            self.num_inst += label.size


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label).astype("int64").ravel(), _np(pred)
            prob = pred.reshape(-1, pred.shape[-1])[numpy.arange(label.size),
                                                    label]
            if self.ignore_label is not None:
                prob = prob[label != self.ignore_label]
            self.sum_metric += float(-numpy.log(prob + self.eps).sum())
            self.num_inst += prob.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(numpy.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _pairs(labels, preds):
            label, pred = _np(label).ravel(), _np(pred).ravel()
            self.sum_metric += float(numpy.corrcoef(label, pred)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of the outputs (a loss head's values); labels unused."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, _ARRAYS):
            preds = [preds]
        for pred in preds:
            pred = _np(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(name, **kwargs)
        self.feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if isinstance(labels, _ARRAYS):
            labels, preds = [labels], [preds]
        if not self._allow_extra_outputs and len(labels) != len(preds):
            raise ValueError(
                "%d labels vs %d predictions — pass allow_extra_outputs=True "
                "to ignore extra outputs" % (len(labels), len(preds)))
        for label, pred in zip(labels, preds):
            v = self.feval(_np(label), _np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


np_metric = CustomMetric


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A numpy ``feval(label, pred)`` as a CustomMetric (ref:
    metric.py:np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, feval.__name__, allow_extra_outputs)


_alias("acc")(Accuracy)
_alias("top_k_accuracy", "top_k_acc")(TopKAccuracy)
_alias("ce")(CrossEntropy)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """(ref: metric.py:check_label_shapes) ``len()`` compared before any
    wrapping (a bare array's batch size), or with ``shape`` the full
    shapes; returns ``(labels, preds)``, wrapped in lists with ``wrap``."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = tuple(labels.shape), tuple(preds.shape)
    if label_shape != pred_shape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (label_shape, pred_shape))
    if wrap:
        if isinstance(labels, _ARRAYS):
            labels = [labels]
        if isinstance(preds, _ARRAYS):
            preds = [preds]
    return labels, preds
