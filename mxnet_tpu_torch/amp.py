"""Mixed precision (counterpart of ``mxnet_tpu/amp.py``;
ref: python/mxnet/amp/amp.py).

``convert_hybrid_block`` (or ``convert_model``) casts a block's parameters
to bfloat16 and keeps the normalization parameters (BatchNorm's moving
statistics among them) in float32. bfloat16 has float32's exponent range,
so it needs no loss scaling; ``LossScaler`` keeps upstream's dynamic
scaling for float16, and ``init_trainer`` turns on the optimizer's float32
master weights."""
from __future__ import annotations

import contextlib

import torch

_initialized = False


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Accepted as upstream's; the cast is ``convert_hybrid_block``'s."""
    global _initialized
    _initialized = True


def init_trainer(trainer):
    """Keep float32 master weights in ``trainer``'s optimizer."""
    trainer.optimizer.multi_precision = True
    return trainer


def convert_hybrid_block(block, target_dtype="bfloat16",
                         cast_optional_params=False):
    block.cast(target_dtype)
    _fix_norms(block)
    return block


convert_model = convert_hybrid_block


def _fix_norms(block):
    from .gluon.nn.basic_layers import (BatchNorm, GroupNorm, InstanceNorm,
                                        LayerNorm)

    if isinstance(block, (BatchNorm, LayerNorm, InstanceNorm, GroupNorm)):
        for p in block._reg_params.values():
            p.cast(torch.float32)
    for child in block._children.values():
        _fix_norms(child)


class LossScaler:
    """Dynamic loss scaling for float16 (ref: python/mxnet/amp/
    loss_scaler.py): multiply the loss by ``loss_scale``, check the
    gradients in one reduction (``multi_all_finite``, one host read), halve
    on overflow (the caller skips that step) and double after
    ``scale_window`` clean steps. ``init_scale=1`` makes it a no-op."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0, max_scale=2.0 ** 24,
                 **kwargs):
        self.loss_scale = float(init_scale)
        self._factor = float(scale_factor)
        self._window = int(scale_window)
        self._min, self._max = float(min_scale), float(max_scale)
        self._unskipped = 0

    def scale(self, loss):
        if self.loss_scale == 1.0:
            return loss
        return loss * self.loss_scale

    def unscale(self, grads):
        if self.loss_scale == 1.0:
            return grads
        inv = 1.0 / self.loss_scale
        if not isinstance(grads, (list, tuple)):
            return grads * inv
        return type(grads)(g * inv for g in grads)

    def has_overflow(self, grads):
        """True if any gradient element is not finite."""
        from .ops.legacy_ops import multi_all_finite

        if not isinstance(grads, (list, tuple)):
            grads = [grads]
        raw = [getattr(g, "_data", g) for g in grads]
        if not raw:
            return False
        return bool(float(multi_all_finite(*raw)[0]) == 0.0)

    def update(self, overflow=False):
        """Adjust the scale after a step; returns it."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._factor, self._min)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale = min(self.loss_scale * self._factor,
                                      self._max)
                self._unskipped = 0
        return self.loss_scale


def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled:``: the loss as it is
    (bfloat16 needs no scaling), as the JAX package yields it."""
    return contextlib.nullcontext(loss)
