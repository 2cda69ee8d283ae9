"""Optimizers (ref: python/mxnet/optimizer/optimizer.py; the JAX package's
``mxnet_tpu/optimizer.py``): the fifteen the JAX package registers (SGD,
NAG, Adam, AdamW, AdaGrad, AdaDelta, RMSProp, Ftrl, LAMB, Signum, AdaMax,
FTML, DCASGD, LARS, SGLD), an ``lr_scheduler`` on every one, and
``Updater``/``get_updater``.

MXNet fuses each update into a hand-written CUDA kernel and the JAX package
jits one program over every parameter. Here :meth:`Optimizer.fused_update`
is one multi-tensor step over every parameter with ``torch._foreach_*``
ops, which updates the weights, the fp32 master copies and the states in
place. It is plain elementwise arithmetic, outside any Pallas kernel in the
JAX package, so it has no hand-written kernel of its own. LAMB's and
LARS's per-tensor norms are ``torch._foreach_norm`` in fp32, with no host
read. :meth:`Optimizer.update` is the per-index form of the same step.

Each optimizer's state has the JAX package's layout, leaf for leaf (the
order of a tuple's members and each leaf's dtype: fp32, and SGLD's (2,)
uint32 pseudo-state), so a Trainer state file crosses between the
packages. SGLD draws its noise from ``random.generator`` (torch's Philox),
the JAX package from threefry: the two streams cannot match.

Multi-precision (the AMP recipe): with ``multi_precision=True`` a bf16 or
fp16 weight keeps an fp32 master copy in its state; the step runs on the
master and casts it back into the weight. Gradients are rescaled and
clipped in fp32. A low-precision weight without a master is stepped in
fp32 and cast back once.

A row-sparse gradient (the JAX package's lazy ``_update_rsp``) waits for
``sparse.py`` (ROADMAP.md A.17) and raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import profiler
from . import random as _random

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta",
           "AdaMax", "FTML", "DCASGD", "LARS", "RMSProp", "Ftrl", "LAMB",
           "Signum", "SGLD", "Updater", "create", "get_updater", "register",
           "sharded_step", "StepProgram"]

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


def _f32(x):
    return np.float32(x)


def _zeros(weight):
    return torch.zeros_like(weight, dtype=torch.float32)


def _bias_corrections(beta, ts):
    """``1 - beta ** t`` for each update count, in fp32 as the JAX package
    takes it (in a step program, one 0-d device tensor for a group's
    count, :class:`_GroupCount`)."""
    if isinstance(ts, _GroupCount):
        return ts.derived(("bias", beta),
                          lambda host: _bias_corrections(beta, host))
    return [float(_f32(1) - _f32(beta) ** _f32(t)) for t in ts]


class _DeviceCounts:
    """A step program's update counts, one for each group of parameters
    that step alike: the host values, and for each number the step
    derives from them (:meth:`derived`) a (groups,) device buffer written
    before each run, so a captured step reads the new values."""

    def __init__(self, host, device):
        self.host = list(host)
        self.device = device
        self.buffers = {}

    def derived(self, key, fn):
        got = self.buffers.get(key)
        if got is None:
            buf = torch.tensor(fn(self.host), dtype=torch.float32,
                               device=self.device)
            got = self.buffers[key] = (buf, fn, buf.unbind())
        return got[2]

    def write(self, host):
        self.host[:] = host
        for buf, fn, _ in self.buffers.values():
            buf.copy_(torch.tensor(fn(host), dtype=torch.float32),
                      non_blocking=False)


class _GroupCount:
    """One group's update count in a step program: what the step derives
    from it is one 0-d device tensor, which a ``torch._foreach_*`` op
    applies to the whole group in one multi-tensor launch."""

    def __init__(self, counts, g):
        self.counts, self.g = counts, g

    def derived(self, key, fn):
        return self.counts.derived(key, fn)[self.g]


def _as_tensor(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _adam_moments(opt, states, gs):
    """Adam's (mean, variance) states of ``opt.beta1``/``beta2`` updated
    in place from ``gs``; returns the two lists."""
    ms = [s[0] for s in states]
    vs = [s[1] for s in states]
    torch._foreach_mul_(ms, opt.beta1)
    torch._foreach_add_(ms, gs, alpha=1 - opt.beta1)
    torch._foreach_mul_(vs, opt.beta2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - opt.beta2)
    return ms, vs


def _adam_direction(opt, ms, vs, ts):
    """mhat / (sqrt(vhat) + eps), with the bias corrections of ``ts``."""
    mhat = torch._foreach_div(ms, _bias_corrections(opt.beta1, ts))
    denom = torch._foreach_sqrt(torch._foreach_div(
        vs, _bias_corrections(opt.beta2, ts)))
    torch._foreach_add_(denom, opt.epsilon)
    torch._foreach_div_(mhat, denom)
    return mhat


class Optimizer:
    # whether _foreach_step reads its host numbers only as the rates, the
    # decays and _bias_corrections, so StepProgram can capture it
    graph_safe = False

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, param_idx2name=None,
                 begin_num_update=0, multi_precision=False):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name or {}
        self.lr_mult = {}
        self.wd_mult = {}
        self._index_update_count = {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        """The scheduler's rate at ``num_update`` when there is one, else
        the fixed rate."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count.setdefault(index, self.begin_num_update)
        self._index_update_count[index] += 1
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
        ``gs`` (which the step may overwrite) and the inner states (updated
        in place too)."""
        raise NotImplementedError

    def _apply(self, params, grads, states, lrs, wds, ts):
        """One multi-tensor step with the per-parameter rates, decays and
        update counts given: gradients rescaled and clipped in fp32,
        masters stepped and cast back into the weights."""
        # a profiler scope, so a trace can sum the step's kernels
        with torch.no_grad(), profiler.scope(
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
        self._apply(params, grads, states,
                    [self._get_lr(i) for i in indices],
                    [self._get_wd(i) for i in indices],
                    [self._index_update_count[i] for i in indices])
        return list(states)

    def update(self, index, weight, grad, state):
        """The per-index update (ref: optimizer.py:Optimizer.update): the
        weight in place; returns the state."""
        if getattr(grad, "stype", "default") == "row_sparse" \
                or getattr(grad, "is_sparse", False):
            return self._update_rsp(index, weight, grad, state)
        return self.fused_update([weight], [grad], [state], [index])[0]

    def update_multi_precision(self, index, weight, grad, state):
        return self.update(index, weight, grad, state)

    def _update_rsp(self, index, weight, grad, state):
        raise NotImplementedError(
            "a row-sparse gradient takes the lazy row update, which waits "
            "for sparse.py (ROADMAP.md A.17)")


class StepProgram:
    """One optimizer's fused multi-tensor step over one parameter set as
    one CUDA graph (the JAX package's one fused update program,
    ``mxnet_tpu/optimizer.py`` ``_fused_stepper``). The rates, decays and
    the numbers derived from the update counts (Adam's bias corrections)
    live in device buffers written before each run, so a scheduler's
    boundary or ``set_learning_rate`` moves them; the gradients are
    copied into static buffers (they are new tensors every backward); the
    weights and states are updated where they lie. The parameters are
    stepped in groups of equal rate, decay and update count, each number
    one 0-d device tensor a group, so every ``torch._foreach_*`` op of a
    group is one multi-tensor launch (a list of per-parameter 0-d tensors
    would take a launch a parameter); a rate multiplier that joins or
    splits groups captures again. The rescale and the clip are fixed at
    capture: another value captures again, as does a weight or state
    given a new tensor. The warm-up runs on clones of the weights, states
    and gradients. On the CPU the same object runs the same step eagerly
    on the buffers. ``captures``, ``replays`` and ``recaptures`` count."""

    def __init__(self, optimizer):
        self.opt = optimizer
        self.graph = None
        self.key = None
        self.captures = self.replays = self.recaptures = 0
        self._addresses = None

    def run(self, params, grads, states, indices):
        from .capture import capture_graph
        from .util import map_state, tree_leaves

        opt = self.opt
        for i in indices:
            opt._update_count(i)
        lrs = [opt._get_lr(i) for i in indices]
        wds = [opt._get_wd(i) for i in indices]
        ts = [opt._index_update_count[i] for i in indices]
        dev = params[0].device
        groups = {}
        for j, v in enumerate(zip(lrs, wds, ts)):
            groups.setdefault(v, []).append(j)
        groups = tuple(tuple(g) for g in groups.values())
        lrs, wds, ts = ([v[g[0]] for g in groups] for v in (lrs, wds, ts))
        key = (tuple(indices), groups, opt.rescale_grad, opt.clip_gradient,
               tuple((tuple(g.shape), g.dtype) for g in grads))
        addresses = [t.data_ptr() for t in params + tree_leaves(states)]
        if key != self.key or addresses != self._addresses:
            self.recaptures += int(self.key is not None)
            self.key, self._addresses = key, addresses
            self.graph = None
            self._groups = groups
            self._scal = torch.zeros(2, len(groups), dtype=torch.float32,
                                     device=dev)
            self._counts = _DeviceCounts(ts, dev)
            self._grads = [torch.empty_like(g) for g in grads]
            body = self._body(params, states)
            self._write(lrs, wds, ts)
            if dev.type == "cuda":
                torch._foreach_copy_(self._grads, list(grads))
                ws = [w.clone() for w in params]
                ss = [map_state(x, torch.clone) for x in states]
                self.graph = capture_graph(
                    body, dev, torch.cuda.graph_pool_handle(),
                    warmup=self._body(ws, ss))
            self.captures += 1
        else:
            self._write(lrs, wds, ts)
        torch._foreach_copy_(self._grads, list(grads))
        self.replays += 1
        if self.graph is None:
            self._body(params, states)()
        else:
            self.graph.replay()
        return list(states)

    def _write(self, lrs, wds, ts):
        self._scal.copy_(torch.tensor([lrs, wds], dtype=torch.float32))
        self._counts.write(ts)

    def _body(self, params, states):
        lr, wd = (r.unbind() for r in self._scal)

        def step():
            for g, js in enumerate(self._groups):
                self.opt._apply([params[j] for j in js],
                                [self._grads[j] for j in js],
                                [states[j] for j in js], lr[g], wd[g],
                                _GroupCount(self._counts, g))

        return step


def sharded_step(step, params, grads, group, nshard, rank,
                 keep_sharded=False, full_shapes=None):
    """ZeRO-1 weight-update sharding (Xu et al., arXiv 2004.13336; the
    JAX package's ``_fused_stepper(mesh=, shard_axis=, keep_sharded=)``):
    ``step(weights, grads)`` updates each weight only in this rank's block
    along the first axis ``nshard`` divides (a weight no axis of which
    divides is updated whole, alike on every rank), then the blocks are
    all-gathered over ``group`` back into the weights. The states ``step``
    holds are the blocks' states. A gradient may come whole or as the block
    (ZeRO-2); with ``keep_sharded`` (ZeRO-3) the weights given are the
    blocks themselves and nothing is gathered. ``full_shapes``: the
    weights' whole shapes (default: their shapes). Returns what ``step``
    returns."""
    from .dist.zero import block, gather_block, shard_dim

    if full_shapes is None:
        full_shapes = [tuple(w.shape) for w in params]
    ws, gs, back = [], [], []
    for w, g, shape in zip(params, grads, full_shapes):
        d = shard_dim(shape, nshard)
        if d is None or keep_sharded:
            wb = w
        else:
            wb = block(w, d, rank, nshard)
            back.append((w, wb, d))
        gb = g if d is None or tuple(g.shape) != tuple(shape) \
            else block(g, d, rank, nshard)
        ws.append(wb)
        gs.append(gb)
    new = step(ws, gs)
    with torch.no_grad(), torch.profiler.record_function(
            "mxnet_tpu_torch::zero_gather"):
        works = [gather_block(w, wb, d, group, nshard, async_op=True)
                 for w, wb, d in back]
        for work in works:
            if work is not None:
                work.wait()
    return new


@register
class SGD(Optimizer):
    """(ref: src/operator/optimizer_op.cc:sgd_mom_update). The state is the
    momentum, or nothing without momentum."""

    graph_safe = True

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def init_state(self, weight):
        return _zeros(weight) if self.momentum else ()

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        lg = torch._foreach_mul(gs, lrs)
        if not self.momentum:
            torch._foreach_sub_(ws, lg)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, lg)
        torch._foreach_add_(ws, states)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (ref: optimizer.py:NAG)."""

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        lg = torch._foreach_mul(gs, lrs)
        if not self.momentum:
            torch._foreach_sub_(ws, lg)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, lg)
        upd = torch._foreach_mul(states, self.momentum)
        torch._foreach_sub_(upd, lg)
        torch._foreach_add_(ws, upd)


@register
class Adam(Optimizer):
    """(ref: src/operator/optimizer_op.cc:adam_update). Weight decay is added
    to the gradient, and the bias corrections are taken in fp32, as in the
    JAX package's ``Adam._step``. The state is (mean, variance)."""

    graph_safe = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        ms, vs = _adam_moments(self, states, gs)
        mhat = torch._foreach_div(ms, _bias_corrections(self.beta1, ts))
        upd = torch._foreach_mul(mhat, lrs)
        denom = torch._foreach_sqrt(torch._foreach_div(
            vs, _bias_corrections(self.beta2, ts)))
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ws, upd)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``lr * (mhat / (sqrt(vhat) + eps) +
    wd * w)``."""

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        ms, vs = _adam_moments(self, states, gs)
        upd = _adam_direction(self, ms, vs, ts)
        torch._foreach_add_(upd, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(upd, lrs)
        torch._foreach_sub_(ws, upd)


@register
class AdaGrad(Optimizer):
    """The state is the running sum of squared gradients."""

    graph_safe = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def init_state(self, weight):
        return _zeros(weight)

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_add_(states, torch._foreach_mul(gs, gs))
        denom = torch._foreach_sqrt(states)
        torch._foreach_add_(denom, self.float_stable_eps)
        upd = torch._foreach_mul(gs, lrs)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(ws, upd)


@register
class AdaDelta(Optimizer):
    """The state is (the running mean of g², that of the squared steps); the
    learning rate takes no part."""

    graph_safe = True

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        acc_g = [s[0] for s in states]
        acc_d = [s[1] for s in states]
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(acc_g, self.rho)
        torch._foreach_add_(acc_g, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self.rho))
        d = torch._foreach_sqrt(torch._foreach_add(acc_d, self.epsilon))
        torch._foreach_div_(d, torch._foreach_sqrt(
            torch._foreach_add(acc_g, self.epsilon)))
        torch._foreach_mul_(d, gs)
        torch._foreach_mul_(acc_d, self.rho)
        torch._foreach_add_(acc_d, torch._foreach_mul(
            torch._foreach_mul(d, d), 1 - self.rho))
        torch._foreach_sub_(ws, d)


@register
class RMSProp(Optimizer):
    """The state is (n,), or (n, mean g, momentum) when ``centered``."""

    graph_safe = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon, self.centered = epsilon, centered

    def init_state(self, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        ns = [s[0] for s in states]
        torch._foreach_mul_(ns, self.gamma1)
        torch._foreach_add_(ns, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self.gamma1))
        lg = torch._foreach_mul(gs, lrs)
        if not self.centered:
            denom = torch._foreach_sqrt(ns)
            torch._foreach_add_(denom, self.epsilon)
            torch._foreach_div_(lg, denom)
            torch._foreach_sub_(ws, lg)
            return
        mgs = [s[1] for s in states]
        moms = [s[2] for s in states]
        torch._foreach_mul_(mgs, self.gamma1)
        torch._foreach_add_(mgs, torch._foreach_mul(gs, 1 - self.gamma1))
        denom = torch._foreach_sub(ns, torch._foreach_mul(mgs, mgs))
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(lg, torch._foreach_sqrt(denom))
        torch._foreach_mul_(moms, self.gamma2)
        torch._foreach_sub_(moms, lg)
        torch._foreach_add_(ws, moms)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader; the state is (z, n). The weight decay
    joins the denominator, not the gradient."""

    graph_safe = True

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        zs = [s[0] for s in states]
        ns = [s[1] for s in states]
        g2 = torch._foreach_mul(gs, gs)
        sigma = torch._foreach_sqrt(torch._foreach_add(ns, g2))
        torch._foreach_sub_(sigma, torch._foreach_sqrt(ns))
        torch._foreach_div_(sigma, lrs)
        torch._foreach_add_(zs, gs)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        torch._foreach_add_(ns, g2)
        denom = torch._foreach_sqrt(ns)
        torch._foreach_add_(denom, self.beta)
        torch._foreach_div_(denom, lrs)
        torch._foreach_add_(denom, wds)
        shrunk = torch._foreach_sub(zs, torch._foreach_mul(
            torch._foreach_sign(zs), self.lamda1))
        torch._foreach_div_(shrunk, denom)
        for w, z, s in zip(ws, zs, shrunk):
            w.copy_(torch.where(z.abs() > self.lamda1, -s, 0.0))


def _trust_scales(wnorms, onorms, lrs, ratio_of, lower=None, upper=None):
    """``lr * ratio`` a tensor, on the device: ``ratio = ratio_of(||w||,
    ||other||)`` where both norms are positive and 1 elsewhere, then
    clipped to [``lower``, ``upper``]. (N,) norms in, N 0-d tensors out."""
    wn, on = torch.stack(wnorms), torch.stack(onorms)
    ratio = torch.where((wn > 0) & (on > 0), ratio_of(wn, on),
                        torch.ones_like(wn))
    if lower is not None:
        ratio = torch.clamp(ratio, min=lower)
    if upper is not None:
        ratio = torch.clamp(ratio, max=upper)
    return list((_as_tensor(lrs, wn) * ratio).unbind())


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT: the Adam direction
    plus decoupled weight decay, scaled per tensor by the trust ratio
    ``||w|| / ||r||`` (clipped to ``lower_bound``/``upper_bound``). The
    state is (mean, variance)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        ms, vs = _adam_moments(self, states, gs)
        if self.bias_correction:
            r = _adam_direction(self, ms, vs, ts)
        else:
            r = torch._foreach_sqrt(vs)
            torch._foreach_add_(r, self.epsilon)
            r = torch._foreach_div(ms, r)
        torch._foreach_add_(r, torch._foreach_mul(ws, wds))
        scales = _trust_scales(torch._foreach_norm(ws),
                               torch._foreach_norm(r), lrs,
                               lambda wn, rn: wn / rn,
                               self.lower_bound, self.upper_bound)
        torch._foreach_mul_(r, scales)
        torch._foreach_sub_(ws, r)


@register
class Signum(Optimizer):
    """Sign of the momentum, with decoupled decay ``wd_lh``; the state is
    the momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def init_state(self, weight):
        return _zeros(weight)

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_add_(states, torch._foreach_mul(gs, 1 - self.momentum))
        torch._foreach_mul_(ws, [float(_f32(1) - _f32(lr) * _f32(self.wd_lh))
                                 for lr in lrs])
        torch._foreach_sub_(ws, torch._foreach_mul(
            torch._foreach_sign(states), lrs))


@register
class AdaMax(Optimizer):
    """Adam with an infinity-norm second moment (ref:
    python/mxnet/optimizer/adamax.py); the state is (mean, u)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        ms = [s[0] for s in states]
        us = [s[1] for s in states]
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - self.beta1))
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        lr_t = [float(_f32(lr) / c) for lr, c in
                zip(lrs, _bias_corrections(self.beta1, ts))]
        upd = torch._foreach_mul(ms, lr_t)
        torch._foreach_div_(upd, torch._foreach_add(us, 1e-8))
        torch._foreach_sub_(ws, upd)


@register
class FTML(Optimizer):
    """Follow the moving leader (ref: python/mxnet/optimizer/ftml.py); the
    state is (d, v, z)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        ds = [s[0] for s in states]
        vs = [s[1] for s in states]
        zs = [s[2] for s in states]
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self.beta2))
        d_t = torch._foreach_sqrt(torch._foreach_div(
            vs, _bias_corrections(self.beta2, ts)))
        torch._foreach_add_(d_t, self.epsilon)
        torch._foreach_mul_(d_t, [float(_f32(c) / _f32(lr)) for c, lr in
                                  zip(_bias_corrections(self.beta1, ts),
                                      lrs)])
        sigma = torch._foreach_sub(d_t, torch._foreach_mul(ds, self.beta1))
        torch._foreach_mul_(zs, self.beta1)
        torch._foreach_add_(zs, torch._foreach_mul(gs, 1 - self.beta1))
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, ws))
        torch._foreach_copy_(ds, d_t)
        torch._foreach_copy_(ws, torch._foreach_neg(
            torch._foreach_div(zs, d_t)))


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (ref: python/mxnet/optimizer/dcasgd.py):
    a stale gradient corrected by ``lamda * g² * (w_now - w_then)``. The
    state is (momentum, the weight before the last update)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def init_state(self, weight):
        return (_zeros(weight), weight.detach().to(torch.float32).clone())

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        moms = [s[0] for s in states]
        prevs = [s[1] for s in states]
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        comp = torch._foreach_mul(torch._foreach_mul(gs, gs), self.lamda)
        torch._foreach_mul_(comp, torch._foreach_sub(ws, prevs))
        torch._foreach_add_(comp, gs)
        torch._foreach_mul_(comp, lrs)
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, comp)
        torch._foreach_copy_(prevs, ws)
        torch._foreach_add_(ws, moms)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (ref: python/mxnet/optimizer/
    lars.py): the SGD-momentum step scaled per tensor by the trust ratio
    ``eta * ||w|| / (||g|| + wd * ||w|| + eps)``. The state is the
    momentum."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def init_state(self, weight):
        return _zeros(weight)

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        wd_t = _as_tensor(wds, ws[0])
        scales = _trust_scales(
            torch._foreach_norm(ws), torch._foreach_norm(gs), lrs,
            lambda wn, gn: self.eta * wn / (gn + wd_t * wn + self.epsilon))
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_add_(states, torch._foreach_mul(gs, scales))
        torch._foreach_sub_(ws, states)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py:SGLD):
    ``w - lr / 2 * g + N(0, lr)``, the noise from ``random.generator``. The
    state is the JAX package's (2,) uint32 pseudo-state, kept as it is."""

    def init_state(self, weight):
        return torch.zeros(2, dtype=torch.uint32, device=weight.device)

    def _noise(self, w):
        return torch.randn(w.shape, dtype=torch.float32, device=w.device,
                           generator=_random.generator(w.device))

    def _foreach_step(self, ws, gs, states, lrs, wds, ts):
        torch._foreach_add_(gs, torch._foreach_mul(ws, wds))
        torch._foreach_sub_(ws, torch._foreach_mul(gs, [0.5 * lr
                                                        for lr in lrs]))
        noise = [self._noise(w) for w in ws]
        torch._foreach_mul_(noise, [math.sqrt(lr) for lr in lrs])
        torch._foreach_add_(ws, noise)


class Updater:
    """(ref: optimizer.py:Updater) The kvstore-side updater: per-index
    states, one update a call, or one multi-tensor step over a batch of
    keys (:meth:`batch_call`)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])

    def batch_call(self, indices, grads, weights):
        """Every key of the batch in one ``fused_update``."""
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
        new = self.optimizer.fused_update(
            list(weights), list(grads), [self.states[i] for i in indices],
            indices=list(indices))
        for i, s in zip(indices, new):
            self.states[i] = s


def get_updater(optimizer):
    return Updater(optimizer)
