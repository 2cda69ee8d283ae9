"""Optimizers (ref: python/mxnet/optimizer/optimizer.py; the JAX package's
``mxnet_tpu/optimizer.py``): ``Optimizer`` and ``Adam``.

MXNet fuses each update into a hand-written CUDA kernel and the JAX package
jits one program over every parameter. Here :meth:`Optimizer.fused_update`
is one multi-tensor step over every parameter with ``torch._foreach_*``
ops, which updates the weights, the fp32 master copies and the moments in
place. It is plain elementwise arithmetic, outside any Pallas kernel in the
JAX package, so it has no hand-written kernel of its own.

Multi-precision (the AMP recipe): with ``multi_precision=True`` a bf16 or
fp16 weight keeps an fp32 master copy in its state; the step runs on the
master and casts it back into the weight. Gradients are rescaled and
clipped in fp32.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "create", "register"]

LOW_PRECISION = (torch.bfloat16, torch.float16)
_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registry name (``"adam"``), or ``name`` itself when it
    is already an :class:`Optimizer`."""
    if isinstance(name, Optimizer):
        return name
    if name.lower() not in _REGISTRY:
        raise ValueError("unknown optimizer %r (registered: %s)"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[name.lower()](**kwargs)


class Optimizer:
    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, param_idx2name=None,
                 multi_precision=False):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self._index_update_count = {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update, self._index_update_count[index])

    def _get_lr(self, index):
        name = self.idx2name.get(index, index)
        return self.learning_rate * self.lr_mult.get(
            name, self.lr_mult.get(index, 1.0))

    def _get_wd(self, index):
        name = self.idx2name.get(index, index)
        return self.wd * self.wd_mult.get(name, self.wd_mult.get(index, 1.0))

    def create_state(self, index, weight):
        """The state of one weight; with ``multi_precision`` a low-precision
        weight's state is ``{"master": fp32 copy, "state": ...}``."""
        state = self.init_state(weight)
        if self.multi_precision and weight.dtype in LOW_PRECISION:
            return {"master": weight.detach().to(torch.float32),
                    "state": state}
        return state

    def init_state(self, weight):
        return ()

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        """Update the fp32 weights ``ws`` in place from the fp32 gradients
        ``gs`` (which the step may overwrite) and the inner states."""
        raise NotImplementedError

    def fused_update(self, params, grads, states, indices=None):
        """Update every weight of ``params`` in place, in one multi-tensor
        step. ``grads`` and ``states`` match ``params``; ``indices`` are the
        per-parameter keys of the lr/wd multipliers and update counts
        (default: positions). The states are updated in place too and
        returned."""
        if not params:
            return []
        if indices is None:
            indices = list(range(len(params)))
        for i in indices:
            self._update_count(i)
        ts = [self._index_update_count[i] for i in indices]
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        # a profiler range, so a trace can sum the step's kernels
        with torch.no_grad(), torch.profiler.record_function(
                "mxnet_tpu_torch::optimizer_step"):
            # fp32 gradients, rescaled (out of place: never the params' own
            # gradient tensors) and clipped
            gs = torch._foreach_mul([g.to(torch.float32) for g in grads],
                                    self.rescale_grad)
            if self.clip_gradient is not None:
                torch._foreach_clamp_min_(gs, -self.clip_gradient)
                torch._foreach_clamp_max_(gs, self.clip_gradient)
            ws, inner, low, low32 = [], [], [], []
            for w, s in zip(params, states):
                if isinstance(s, dict) and "master" in s:
                    w32, s = s["master"], s["state"]
                elif w.dtype == torch.float32:
                    w32 = w
                else:
                    w32 = w.to(torch.float32)
                ws.append(w32)
                inner.append(s)
                if w32 is not w:
                    low.append(w)
                    low32.append(w32)
            self._foreach_step(ws, gs, inner, lrs, wds, ts)
            if low:  # cast the fp32 results back into the weights
                torch._foreach_copy_(low, low32)
        return list(states)


@register
class Adam(Optimizer):
    """(ref: src/operator/optimizer_op.cc:adam_update). Weight decay is added
    to the gradient, and the bias corrections are taken in fp32, as in the
    JAX package's ``Adam._step``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, weight):
        return (torch.zeros_like(weight, dtype=torch.float32),
                torch.zeros_like(weight, dtype=torch.float32))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - self.beta2)
        one, b1, b2 = np.float32(1), np.float32(self.beta1), \
            np.float32(self.beta2)
        c1 = [float(one - b1 ** np.float32(t)) for t in ts]
        c2 = [float(one - b2 ** np.float32(t)) for t in ts]
        upd = torch._foreach_mul(torch._foreach_div(ms, c1), lrs)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, c2))
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ws, upd)
