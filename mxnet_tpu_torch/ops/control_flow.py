"""Control flow on arrays (counterpart of ``mxnet_tpu/ops/control_flow.py``;
ref: src/operator/control_flow.cc, python/mxnet/ndarray/contrib.py):
``foreach``, ``while_loop`` and ``cond`` over NDArrays or tensors, through
nested lists and tuples of them.

The JAX package lowers these onto ``lax.scan``, ``lax.while_loop`` and
``lax.cond``, which trace a body once; here the loops run eagerly, the body
called once a step, with the values and the gradients (under
``autograd.record``) of the JAX forms:

- ``foreach`` stacks the body's per-step outputs along a new axis 0;
- a bounded ``while_loop`` is the JAX package's masked scan of
  ``max_iterations`` steps with a sticky ``active`` flag: once the
  predicate is false the vars stay and the outputs are zeros (the body
  still runs, its results masked);
- an unbounded one (``max_iterations=None``) reads its predicate on the
  host each step (``engine.while_host_read_counter``) and returns
  ``(None, final vars)``;
- ``cond`` reads its predicate on the host (``engine.cond_host_read_counter``)
  and calls the chosen branch alone, which alone takes gradient.

A call under ``autograd.record`` is one opaque entry of the forward record
``autograd.get_symbol`` reads (it raises across it).
"""
from __future__ import annotations

import torch

from .. import autograd, engine

__all__ = ["foreach", "while_loop", "cond"]


def _map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def _any_nd(x):
    from ..ndarray import NDArray

    return any(isinstance(v, NDArray) for v in _leaves(x))


def _unwrap(x):
    from ..ndarray import NDArray, unwrap

    rec = autograd.is_recording()
    return _map(lambda v: unwrap(v, rec) if isinstance(v, NDArray) else
                v if isinstance(v, torch.Tensor) or v is None else
                torch.as_tensor(v), x)


def _wrap_like(is_nd, x):
    if not is_nd:
        return x
    from ..ndarray import NDArray

    return _map(lambda v: v if v is None or isinstance(v, NDArray)
                else NDArray(v), x)


def _scalar_bool(p):
    """A predicate as a 0-d bool tensor (no host read)."""
    p = _unwrap(p)
    if not isinstance(p, torch.Tensor):
        p = torch.as_tensor(p)
    return p.reshape(()).to(torch.bool)


def _record(ins, outs):
    if autograd.is_recording():
        autograd._record_entry(None, _leaves(ins), {}, _leaves(outs))


def foreach(body, data, init_states):
    """``body(slice, states) -> (out, new_states)`` once a step over axis 0
    of ``data``: (stacked outputs, final states)."""
    is_nd = _any_nd(data) or _any_nd(init_states)
    data_t = _unwrap(data)
    states = _unwrap(init_states)
    T = _leaves(data_t)[0].shape[0]
    outs = []
    with torch.set_grad_enabled(autograd.is_recording()):
        for t in range(T):
            xs = _map(lambda d: d[t], data_t)
            out, new = body(_wrap_like(is_nd, xs), _wrap_like(is_nd, states))
            outs.append(_unwrap(out))
            states = _unwrap(new)
        stacked = _stack(outs)
    _record([data_t, _unwrap(init_states)], [stacked, states])
    return _wrap_like(is_nd, stacked), _wrap_like(is_nd, states)


def _stack(steps):
    first = steps[0]
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([s[i] for s in steps])
                           for i in range(len(first)))
    return torch.stack(steps)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """(ref: ndarray/contrib.py:while_loop) ``func(vars) -> (out,
    new_vars)`` while ``cond(vars)``; bounded: (outputs stacked to
    ``max_iterations``, final vars), unbounded: (None, final vars)."""
    is_nd = _any_nd(loop_vars)
    vs = _unwrap(loop_vars)
    with torch.set_grad_enabled(autograd.is_recording()):
        if max_iterations is None:
            while True:
                engine.while_host_read_counter.count += 1
                if not bool(_scalar_bool(cond(_wrap_like(is_nd, vs)))):
                    break
                _, new = func(_wrap_like(is_nd, vs))
                vs = _unwrap(new)
            _record(_unwrap(loop_vars), vs)
            return None, _wrap_like(is_nd, vs)
        active = None
        outs = []
        for _ in range(int(max_iterations)):
            pred = _scalar_bool(cond(_wrap_like(is_nd, vs)))
            if active is not None:
                pred = pred & active
            out, new = func(_wrap_like(is_nd, vs))
            out, new = _unwrap(out), _unwrap(new)
            flat_new, flat_old = _leaves(new), _leaves(vs)
            mixed = iter([torch.where(pred, n, o)
                          for n, o in zip(flat_new, flat_old)])
            vs = _map(lambda _: next(mixed), new)
            outs.append(_map(lambda o: torch.where(pred, o,
                                                   torch.zeros_like(o)), out))
            active = pred
        stacked = _stack(outs)
    _record(_unwrap(loop_vars), [stacked, vs])
    return _wrap_like(is_nd, stacked), _wrap_like(is_nd, vs)


def cond(pred, then_func, else_func, inputs=()):
    """``then_func(*inputs)`` where the scalar ``pred`` is true, else
    ``else_func(*inputs)``: the predicate read on the host, the chosen
    branch alone run."""
    is_nd = _any_nd(inputs) or _any_nd(pred)
    engine.cond_host_read_counter.count += 1
    take = bool(_scalar_bool(pred))
    xs = _unwrap(tuple(inputs))
    with torch.set_grad_enabled(autograd.is_recording()):
        out = (then_func if take else else_func)(*_wrap_like(is_nd, xs))
    out = _unwrap(out)
    _record(list(xs), out)
    return _wrap_like(is_nd, out)
