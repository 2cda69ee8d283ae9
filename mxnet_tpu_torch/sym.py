"""``mx.sym`` (counterpart of ``mxnet_tpu/sym.py``): symbol builders
generated from the port's op registry (ref: python/mxnet/symbol/register.py).

``sym.<op>(*inputs, name=None, **attrs)`` makes an op node. As upstream,
an op's tensor inputs that the caller does not give become variables named
``<name>_<input>`` (``fc1_weight``, ``fc1_bias``; no bias with
``no_bias=True``), the first input may be given as ``data=``, and a
multi-output op comes back as a tuple of ``_item`` projections, except
BatchNorm, whose one visible output is returned (``_VISIBLE_SINGLE``).
"""
from __future__ import annotations

import inspect
import sys as _sys

from .base import OP_REGISTRY as _REG
from . import ops as _ops  # noqa: F401  (fills the registry)
from . import sym_contrib as contrib  # noqa: F401
from .symbol import (N_OUTPUTS, Symbol, var, Variable, Group,  # noqa: F401
                     _make, cond, load, loads)

_mod = _sys.modules[__name__]

# multi-output ops upstream shows as one visible output, by function
# identity, so an alias (batch_norm) behaves as its CamelCase twin
_VISIBLE_SINGLE = {n for n in _REG for v in ("BatchNorm",)
                   if v in _REG and _REG[n] is _REG[v]}

_TENSOR_SLOTS = {}  # op -> (positional tensor parameter names, required)
_NEVER_AUTO = {"key", "training", "out"}


def _n_outputs(opname):
    fn = _REG.get(opname)
    return next((n for o, n in N_OUTPUTS.items() if _REG.get(o) is fn), 1)


def _tensor_slots(opname):
    """The registry function's positional parameters, in order, and how
    many are required: the inputs that become auto-named variables."""
    got = _TENSOR_SLOTS.get(opname)
    if got is not None:
        return got
    try:
        sig = inspect.signature(_REG[opname])
        pos = [p for p in sig.parameters.values()
               if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
               and p.name not in _NEVER_AUTO]
        names = [p.name for p in pos]
        n_req = len([p for p in pos if p.default is inspect.Parameter.empty])
    except (TypeError, ValueError):
        names, n_req = [], 0
    _TENSOR_SLOTS[opname] = (names, n_req)
    return names, n_req


def _builder(opname):
    def f(*args, name=None, **kwargs):
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        slots, n_req = _tensor_slots(opname)
        if slots and "data" in sym_kwargs and "data" not in slots \
                and not args and slots[0] not in sym_kwargs:
            sym_kwargs[slots[0]] = sym_kwargs.pop("data")
        if slots and not sym_kwargs.keys() - set(slots) \
                and len(args) <= len(slots):
            filled = dict(zip(slots, args))
            filled.update(sym_kwargs)
            wanted = (set(slots[:n_req]) - set(attrs)) | set(filled)
            if "bias" in slots[n_req:] and not attrs.get("no_bias", False) \
                    and filled and "bias" not in attrs:
                wanted.add("bias")
            order = [s for s in slots if s in wanted]
            if order:
                order = slots[:slots.index(order[-1]) + 1]
            if any(s not in filled for s in order):
                from . import name as _name_mod

                name = _name_mod.current().get(name, opname.lower())
            inputs = []
            for s in order:
                if s in filled:
                    inputs.append(filled[s])
                elif s in attrs:
                    raise ValueError(
                        "%s: %r is given as a keyword scalar but a later "
                        "input is positional/Symbol — pass %r positionally "
                        "or as a Symbol" % (opname, s, s))
                else:
                    inputs.append(var("%s_%s" % (name, s)))
        else:
            inputs = list(args) + list(sym_kwargs.values())
        out = _make(opname, *inputs, name=name, **attrs)
        arity = _n_outputs(opname)
        if opname in _VISIBLE_SINGLE:
            return out[0] if arity > 1 else out
        if arity > 1:
            return tuple(out[i] for i in range(arity))
        return out

    f.__name__ = opname
    return f


for _name in list(_REG):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _builder(_name))


def sample_multinomial(data, *args, get_prob=False, name=None, **kwargs):
    """``get_prob`` changes the arity: the matching registry entry."""
    op = "_sample_multinomial_prob" if get_prob else "sample_multinomial"
    return _builder(op)(data, *args, name=name, **kwargs)


# creation ops: symbol forms over the graph's source ops
def zeros(shape, dtype="float32", ctx=None, name=None, **kwargs):
    return _make("_filled", name=name, shape=tuple(shape), value=0.0,
                 dtype=dtype)


def ones(shape, dtype="float32", ctx=None, name=None, **kwargs):
    return _make("_filled", name=name, shape=tuple(shape), value=1.0,
                 dtype=dtype)


def full(shape, val, dtype="float32", ctx=None, name=None, **kwargs):
    return _make("_filled", name=name, shape=tuple(shape), value=val,
                 dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", ctx=None,
           name=None, **kwargs):
    """``_arange``; ``ctx`` is accepted and unused (a graph has no device:
    its source ops make their values on the walk's device)."""
    if kwargs:
        raise TypeError("sym.arange got unsupported kwargs %s"
                        % sorted(kwargs))
    if stop is None:
        start, stop = 0, start
    return _make("_arange", name=name, start=float(start), stop=float(stop),
                 step=float(step), repeat=int(repeat),
                 dtype=dtype or "float32")


def __getattr__(name):
    if name in _REG:
        f = _builder(name)
        setattr(_mod, name, f)
        return f
    raise AttributeError(name)


class _SymRandom:
    """``mx.sym.random``: builders over the registry's random ops (ref:
    python/mxnet/symbol/random.py)."""

    @staticmethod
    def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", name=None):
        return _builder("random_uniform")(low=low, high=high,
                                          shape=tuple(shape), dtype=dtype,
                                          name=name)

    @staticmethod
    def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", name=None):
        return _builder("random_normal")(loc=loc, scale=scale,
                                         shape=tuple(shape), dtype=dtype,
                                         name=name)

    @staticmethod
    def randint(low, high, shape=(1,), dtype="int32", name=None):
        return _builder("random_randint")(low=low, high=high,
                                          shape=tuple(shape), dtype=dtype,
                                          name=name)

    @staticmethod
    def exponential(lam=1.0, shape=(1,), dtype="float32", name=None):
        return _builder("random_exponential")(lam=lam, shape=tuple(shape),
                                              dtype=dtype, name=name)

    @staticmethod
    def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", name=None):
        return _builder("random_gamma")(alpha=alpha, beta=beta,
                                        shape=tuple(shape), dtype=dtype,
                                        name=name)

    @staticmethod
    def poisson(lam=1.0, shape=(1,), dtype="float32", name=None):
        return _builder("random_poisson")(lam=lam, shape=tuple(shape),
                                          dtype=dtype, name=name)

    @staticmethod
    def negative_binomial(k=1, p=0.5, shape=(1,), dtype="float32",
                          name=None):
        return _builder("random_negative_binomial")(
            k=k, p=p, shape=tuple(shape), dtype=dtype, name=name)

    @staticmethod
    def multinomial(data, shape=(), get_prob=False, dtype="int32",
                    name=None):
        return sample_multinomial(data, shape=tuple(shape) if not
                                  isinstance(shape, int) else shape,
                                  get_prob=get_prob, dtype=dtype, name=name)


random = _SymRandom()
_sys.modules[__name__ + ".random"] = random
