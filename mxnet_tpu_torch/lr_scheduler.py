"""Learning-rate schedulers (ref: python/mxnet/lr_scheduler.py; the port's
copy of ``mxnet_tpu/lr_scheduler.py``). A scheduler is a callable of the
update count; ``Optimizer(lr_scheduler=)`` reads it at every step, and a
warmup of ``warmup_steps`` updates (linear from ``warmup_begin_lr``, or
constant) comes first."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr  # constant

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * self.factor ** ((num_update - self.warmup_steps) // self.step)
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = min(num_update, self.max_update) - self.warmup_steps
        span = max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * (1 - n / span) ** self.power


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = min(num_update, self.max_update) - self.warmup_steps
        span = max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + 0.5 * (self.base_lr - self.final_lr) * (1 + math.cos(math.pi * n / span))
