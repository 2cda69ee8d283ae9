"""Loss blocks (ref: python/mxnet/gluon/loss.py; the JAX package's
``mxnet_tpu/gluon/loss.py``), the ones the BERT pretraining step needs."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(F, loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return F.mean(loss, axis=axes) if axes else loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """(ref: loss.py:SoftmaxCrossEntropyLoss). The sparse-label raw-logits
    case (language-model and classification training) goes through
    ``F.softmax_xent_rows`` and so through the softmax-xent kernels; the
    other two keep the log_softmax formulation, as the JAX package does."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            loss = F.softmax_xent_rows(pred, label, axis=self._axis)
        elif self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            if not self._from_logits:
                pred = F.log_softmax(pred, axis=self._axis)
            label = F.reshape(label, shape=pred.shape)
            loss = -F.sum(pred * label, axis=self._axis)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
