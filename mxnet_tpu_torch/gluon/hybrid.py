"""``HybridBlock.hybridize()``: a block's forward, and under
``autograd.record`` its backward, as CUDA graphs (the counterpart of the
JAX package's one jitted program per ``_cached_execs[training]``,
``mxnet_tpu/gluon/block.py`` ``_get_exec``/``_call_compiled``).

A program's key is the JAX package's, the training flag, extended with
whether the call differentiates and the input signature (each input's
shape, dtype and whether it requires grad; a non-tensor input's value):
a CUDA graph is shape-static where ``jax.jit`` retraces, so a new shape is
a new key. On a CUDA device:

- a call that does not differentiate replays one forward graph;
- a call under ``autograd.record`` replays a forward graph and, at
  ``backward``, a backward graph (``torch.autograd.grad`` of the outputs
  with respect to the differentiable inputs and the parameters, captured
  with the forward in one memory pool, as
  ``torch.cuda.make_graphed_callables`` does). One
  ``torch.autograd.Function`` ties them into autograd: its backward
  returns the gradients, so ``autograd.backward`` stores them by each
  parameter's ``grad_req`` (``"write"`` replaces, ``"add"`` adds), as
  on the eager path.

The inputs are copied into the program's static buffers, the parameters
are read where they lie (``AddressBook``: a parameter given a new tensor
by ``set_data``, ``load_parameters`` or ``cast``, or a new generator
after ``random.seed``, drops every program; a write into the live
tensor, ``copy_data``, keeps them), and every output
is a fresh tensor, never a static buffer the next replay overwrites. The
warm-up runs on the live parameters but puts back the values of those
without a gradient (BatchNorm's running statistics). The dropout masks
come from ``random.generator`` of the device, which is registered with
the graphs, so each replay draws new ones, and the first draws what the
eager call would.

Each program captures into a memory pool of its own (its forward and
backward graphs share it), so the programs of other keys may replay
between a forward and its backward (a predict call mid-step, two shapes
forwarded under one ``record``): no graph of another key reuses the
saved activations. A forward graph's saved activations live until its
next replay: a backward after a later forward of the same key raises
rather than read the later activations. A captured backward is first
order only: a backward that records a graph
(``autograd.grad(create_graph=True)``) runs the block's eager forward
again on the saved inputs and differentiates that, counted in
``stats["eager_second_order"]``.

On the CPU the same object runs every call eagerly, with the same keys
and counts.
"""
from __future__ import annotations

import threading

import torch

from .. import autograd, engine
from .. import random as _random
from ..base import resolve_device
from ..capture import AddressBook, capture_graph
from ..observability import costs

_tls = threading.local()


def inside_program():
    """True while a hybridized block's program runs its body on this
    thread: its children run eagerly inside it."""
    return getattr(_tls, "depth", 0) > 0


class _Body:
    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1

    def __exit__(self, *a):
        _tls.depth -= 1


def _flatten(out):
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)) and all(
            isinstance(o, torch.Tensor) for o in out):
        return list(out), type(out)
    raise TypeError("a hybridized block returns a tensor or a tuple or list "
                    "of tensors, got %s" % type(out).__name__)


def _unflatten(flat, kind):
    return flat[0] if kind is None else kind(flat)


def _signature(args):
    sig = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), a.dtype, str(a.device),
                        bool(a.requires_grad)))
        elif a is None or isinstance(a, (bool, int, float, str)):
            sig.append(("value", a))
        else:
            raise TypeError("a hybridized block takes tensors, None and "
                            "scalars as inputs, got %s" % type(a).__name__)
    return tuple(sig)


class _Program:
    """One key's graphs: the static inputs, the forward graph and its
    outputs, and with ``grad`` the backward graph, its static output
    cotangents and the gradients it writes."""

    def __init__(self, training, grad, meter=None):
        self.training, self.grad = training, grad
        self.fwd = self.bwd = None
        self.inputs = self.outs = self.kind = None
        self.gouts = self.grads = None
        self.generation = 0
        self.meter = meter  # the forward's pending cost count


class _Replay(torch.autograd.Function):
    """The forward graph's replay as an autograd node; its backward is the
    backward graph's replay."""

    @staticmethod
    def forward(ctx, owner, prog, n_in, *tensors):
        outs = owner._replay_forward(prog, tensors[:n_in])
        ctx.owner, ctx.prog, ctx.n_in = owner, prog, n_in
        ctx.generation = prog.generation
        ctx.save_for_backward(*tensors)
        for o, s in zip(outs, prog.outs):
            if not s.requires_grad:
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        owner, prog = ctx.owner, ctx.prog
        tensors = ctx.saved_tensors
        if torch.is_grad_enabled():  # autograd.grad(create_graph=True)
            return (None, None, None) + owner._eager_grads(
                prog, tensors, ctx.n_in, gouts)
        if ctx.generation != prog.generation:
            raise RuntimeError(
                "backward through a hybridized block after a later forward "
                "of the same inputs' shapes replayed over its saved "
                "activations: call backward before the next forward")
        return (None, None, None) + owner._replay_backward(prog, gouts)


class _CountBackward(torch.autograd.Function):
    """The CPU's stand-in for a backward replay: the outputs as they are,
    a backward that counts."""

    @staticmethod
    def forward(ctx, owner, *outs):
        ctx.owner = owner
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *g):
        ctx.owner.stats["eager_second_order" if torch.is_grad_enabled()
                        else "backward_replays"] += 1
        return (None,) + g


class BlockPrograms:
    """The programs of one hybridized block. ``stats``: forward and
    backward captures (one a key), forward and backward replays,
    ``recaptures`` (a key captured again after a drop), ``drops``
    (parameters moved) and ``eager_second_order``."""

    def __init__(self, block):
        self.block = block
        self._programs = {}
        self._seen_keys = set()
        self._addresses = AddressBook()
        self._generator = None  # the generator the graphs draw from
        self.stats = {"forward_captures": 0, "backward_captures": 0,
                      "forward_replays": 0, "backward_replays": 0,
                      "recaptures": 0, "drops": 0,
                      "eager_second_order": 0}

    def drop(self):
        if self._programs:
            self._programs.clear()
            self.stats["drops"] += 1

    def __call__(self, args):
        block = self.block
        plist = list(block.collect_params().values())
        params = [p._tensor() for p in plist]
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), params[0].device
                      if params else torch.device("cpu"))
        if device.type not in ("cpu", "cuda"):
            raise ValueError("a hybridized block runs on a CUDA device or "
                             "the CPU, not %s" % device)
        resolve_device(device)  # a CUDA tensor without a card raises
        # random.seed makes a new generator, which the graphs do not read
        gen = _random.generator(device)
        moved = self._addresses.moved(
            {i: t.data_ptr() for i, t in enumerate(params)})
        if moved or (self._generator is not None
                      and gen is not self._generator):
            self.drop()
        self._generator = gen
        training = autograd.is_training()
        grad = autograd.is_recording() and (
            any(t.requires_grad for t in params) or any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args))
        key = (training, grad, _signature(args))
        prog = self._programs.get(key)
        if prog is None:
            note = "hybridize[%s train=%s grad=%s]" % (
                type(block).__name__, key[0], key[1])
            prog = _Program(training, grad,
                            costs.meter("hybrid_capture", note, device))
            if device.type == "cuda":
                self._capture(prog, args, params, device)
            self._programs[key] = prog
            self.stats["forward_captures"] += 1
            self.stats["backward_captures"] += int(grad)
            self.stats["recaptures"] += int(key in self._seen_keys)
            engine.hybrid_capture_counter.bump(note=note)
            self._seen_keys.add(key)
        self.stats["forward_replays"] += 1
        if prog.fwd is None:  # the CPU: the same call, eagerly
            with _Body():
                flat, kind = _flatten(costs.run_counted(
                    prog.meter, lambda: block._eager_forward(*args)))
            live = [i for i, o in enumerate(flat) if o.requires_grad]
            if live:
                counted = _CountBackward.apply(self, *[flat[i] for i in live])
                for i, o in zip(live, counted):
                    flat[i] = o
            return _unflatten(flat, kind)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not grad:
            return _unflatten(self._replay_forward(prog, tensors), prog.kind)
        outs = _Replay.apply(self, prog, len(tensors), *tensors, *params)
        return _unflatten(list(outs), prog.kind)

    # ------------------------------------------------------------ capture
    def _run(self, prog, args):
        with _Body(), autograd._Mode(prog.grad, prog.training):
            return _flatten(self.block._eager_forward(*args))

    def _capture(self, prog, args, params, device):
        block = self.block
        prog.inputs = [a.detach().clone().requires_grad_(a.requires_grad)
                       if isinstance(a, torch.Tensor) else a for a in args]
        ins = [a for a in prog.inputs if isinstance(a, torch.Tensor)]
        diff = [t for t in ins + params if t.requires_grad]
        fixed = [p._tensor() for p in block.collect_params().values()
                 if p.grad_req == "null" and p._data is not None]
        kept = [t.detach().clone() for t in fixed]
        gens = [_random.generator(device)]

        def warm():
            # the forward alone is the program counted
            with costs.counting(prog.meter) as box:
                flat, _ = self._run(prog, prog.inputs)
                if box is not None:
                    box["result"] = flat
            live = [o for o in flat if o.requires_grad]
            if prog.grad and live:
                torch.autograd.grad(live, diff, [torch.ones_like(o)
                                                 for o in live],
                                    allow_unused=True)

        def forward():
            flat, kind = self._run(prog, prog.inputs)
            prog.kind = kind
            return flat

        pool = torch.cuda.graph_pool_handle()  # the program's own
        try:
            prog.fwd = capture_graph(forward, device, pool,
                                     warmup=warm, generators=gens)
        finally:
            with torch.no_grad():
                for t, v in zip(fixed, kept):
                    t.copy_(v)
        prog.outs = prog.fwd.out
        if not prog.grad:
            return
        live = [o for o in prog.outs if o.requires_grad]
        prog.gouts = [torch.zeros_like(o) if o.requires_grad else None
                      for o in prog.outs]

        def backward():
            got = torch.autograd.grad(
                live, diff, [g for g in prog.gouts if g is not None],
                allow_unused=True)
            it = iter(got)
            return [next(it) if t.requires_grad else None
                    for t in ins + params]

        # the backward graph reads the forward's saved activations: no
        # warm-up (it would consume the forward's graph), same pool
        prog.bwd = capture_graph(backward, device, pool,
                                 warmup=lambda: None)
        prog.grads = prog.bwd.out

    # ------------------------------------------------------------ replay
    def _replay_forward(self, prog, tensors):
        with torch.no_grad():
            for s, t in zip([a for a in prog.inputs
                             if isinstance(a, torch.Tensor)], tensors):
                s.copy_(t)
        prog.fwd.replay()
        prog.generation += 1
        return [o.detach().clone() for o in prog.outs]

    def _replay_backward(self, prog, gouts):
        with torch.no_grad():
            for s, g in zip(prog.gouts, gouts):
                if s is not None:
                    if g is None:
                        s.zero_()
                    else:
                        s.copy_(g)
        prog.bwd.replay()
        self.stats["backward_replays"] += 1
        return tuple(None if g is None else g.clone() for g in prog.grads)

    def _eager_grads(self, prog, tensors, n_in, gouts):
        """The gradients with a graph of their own: the block's eager
        forward on the saved inputs, differentiated (first order is all a
        captured backward gives)."""
        self.stats["eager_second_order"] += 1
        ins = list(tensors[:n_in])
        args = [ins.pop(0) if isinstance(a, torch.Tensor) else a
                for a in prog.inputs]
        with _Body(), autograd._Mode(True, prog.training):
            flat, _ = _flatten(self.block._eager_forward(*args))
        pairs = [(o, g) for o, g in zip(flat, gouts)
                 if o.requires_grad and g is not None]
        diff = [t for t in tensors if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], diff, [g for _, g in pairs],
            create_graph=True, allow_unused=True))
        return tuple(next(got) if t.requires_grad else None
                     for t in tensors)
