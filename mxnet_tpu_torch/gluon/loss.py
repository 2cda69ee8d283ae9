"""Loss blocks (ref: python/mxnet/gluon/loss.py; the JAX package's
``mxnet_tpu/gluon/loss.py``), with the same arguments, formulas and
reductions: a loss is the mean over every axis but ``batch_axis``, after
``sample_weight`` and ``weight`` (``TripletLoss``, ``CosineEmbeddingLoss``,
``CTCLoss`` and ``SDMLLoss`` return per-sample values, and
``PoissonNLLLoss`` the mean over everything, as there)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..parallel import tensor_parallel as _tp
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss",
           "PoissonNLLLoss", "SDMLLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(F, loss, batch_axis):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return F.mean(loss, axis=axes) if axes else loss


def _like(label, pred):
    return label.reshape(pred.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """weight / 2 * (label - pred) ** 2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.square(_like(label, pred) - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.abs(_like(label, pred) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


def sigmoid_bce_with_logits(logits, targets):
    """max(x, 0) - x z + log1p(exp(-|x|)): the sigmoid cross-entropy from
    logits without overflow."""
    return torch.relu(logits) - logits * targets \
        + torch.log1p(torch.exp(-torch.abs(logits)))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """(ref: loss.py:SigmoidBinaryCrossEntropyLoss). ``pos_weight`` is
    accepted and not used, as in the JAX package."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _like(label, pred)
        if not self._from_sigmoid:
            loss = sigmoid_bce_with_logits(pred, label)
        else:
            eps = 1e-12
            loss = -(torch.log(pred + eps) * label
                     + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """(ref: loss.py:SoftmaxCrossEntropyLoss). The sparse-label raw-logits
    case (language-model and classification training) goes through
    ``F.softmax_xent_rows`` and so through the softmax-xent kernels; the
    other two keep the log_softmax formulation, as the JAX package does.
    Logits that a model inside a ``tensor_parallel.tp_scope`` split along
    the vocabulary go through ``tensor_parallel.vocab_parallel_xent`` on
    the blocks."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            # logits a tensor-parallel head split along the vocabulary
            # take the vocabulary-parallel loss on their blocks
            loss = _tp.xent_rows(pred, label, self._axis)
            if loss is None:
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


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.abs(_like(label, pred) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _like(label, pred))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(self._margin
                                       - pred * _like(label, pred)))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class LogisticLoss(Loss):
    """``label_format`` "signed" takes labels in {-1, 1}, "binary" in
    {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label \
            + torch.log(1.0 + torch.exp(-torch.abs(pred)))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _batch_mean(F, loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        axes = tuple(range(1, pred.dim()))
        loss = torch.sum(torch.square(positive - pred)
                         - torch.square(negative - pred), dim=axes)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """(ref: gluon/loss.py:CTCLoss) Connectionist temporal classification,
    the blank label first (class 0): pred (N, T, C) unnormalized scores
    (layout "NTC", or "TNC"), label (N, L) class ids (or (L, N) with
    ``label_layout="TN"``); ``pred_lengths`` and ``label_lengths`` default
    to T and L. Returns each sample's negative log likelihood, computed by
    ``torch.nn.functional.ctc_loss`` on fp32 log-probabilities."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "TNC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        N, T = pred.shape[:2]
        L = label.shape[1]
        logp = torch.log_softmax(pred.float(), dim=-1).transpose(0, 1)
        if pred_lengths is None:
            pred_lengths = torch.full((N,), T, dtype=torch.int64)
        if label_lengths is None:
            label_lengths = torch.full((N,), L, dtype=torch.int64)
        loss = TF.ctc_loss(logp, label.long(), pred_lengths.long(),
                           label_lengths.long(), blank=0, reduction="none")
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """1 - cos for label 1, max(cos - margin, 0) otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        axes = tuple(range(1, input1.dim()))
        num = torch.sum(input1 * input2, dim=axes)
        den = torch.sqrt(torch.sum(torch.square(input1), dim=axes)) \
            * torch.sqrt(torch.sum(torch.square(input2), dim=axes))
        cos = num / (den + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1.0, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood (ref: gluon/loss.py:PoissonNLLLoss):
    ``from_logits`` takes ``pred`` as the log rate (exp(pred) - target
    pred), else as the rate (pred - target log(pred + epsilon));
    ``compute_full`` adds Stirling's approximation of log(target!) where
    target > 1."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * torch.log(target + epsilon) - target
                        + 0.5 * torch.log(2.0 * math.pi
                                          * (target + epsilon)))
            loss = loss + torch.where(target > 1.0, stirling,
                                      torch.zeros_like(target))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return torch.mean(loss)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss (ref: gluon/loss.py:SDMLLoss):
    the rows of x1 and x2 at the same index are positives, every other
    pair an in-batch negative; the KL from a smoothed identity to the
    softmax of the negative squared L2 distances, per row."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def hybrid_forward(self, F, x1, x2):
        n = x1.shape[0]
        d = (torch.sum(torch.square(x1), dim=1, keepdim=True)
             + torch.sum(torch.square(x2), dim=1).reshape(1, -1)
             - 2.0 * torch.matmul(x1, x2.t()))
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        smoothed = eye * (1.0 - self._smoothing) \
            + (1.0 - eye) * self._smoothing / max(n - 1, 1)
        logp = torch.log_softmax(-d, dim=-1)
        kl = torch.sum(smoothed * (torch.log(smoothed + 1e-12) - logp), dim=1)
        return _apply_weighting(F, kl, self._weight, None)
