"""Shared utilities of the PyTorch port: dtype names, the device rule, and the
op registry.

The registry mirrors the JAX package's (every functional op registers once by
name, and ``hybrid_forward(F, ...)`` reaches it as ``F.<name>``); in the port
there is only one front end, eager PyTorch, so an entry is just the function.

The device rule: every entry point runs on CUDA unless the caller asks for
the CPU. With no CUDA device and no explicit CPU request it raises — it never
carries on silently on the CPU.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Dict

import torch

_DTYPE_ALIASES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


class MXNetError(RuntimeError):
    """The framework's error (``mx.MXNetError``)."""


class DeviceError(MXNetError):
    """No CUDA device where one was required."""


def resolve_dtype(dtype):
    """A dtype name, numpy dtype or torch dtype → torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:  # a numpy scalar type such as np.float32
        import numpy as np

        name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise TypeError("unsupported dtype %r" % (dtype,))
    return _DTYPE_ALIASES[name]


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given (a string,
    ``torch.device`` or ``context.Context``), else the innermost ``with
    ctx:`` of this thread, else ``test_utils.set_default_context``'s, else
    the current CUDA device. Raises ``DeviceError`` when CUDA is needed and
    absent."""
    if device is None:
        from . import context

        stack = getattr(context._tls, "stack", None)
        device = stack[-1] if stack else context._default
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available; pass device='cpu' (or enter "
                "`with mx.cpu():`) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if hasattr(device, "torch_device"):
        device = device.torch_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("device %s requested but CUDA is not available"
                          % device)
    return device


def next_pow2(n):
    """Smallest power of two >= n: the bucket rounding of decode cache
    capacities and prompt lengths."""
    p = 1
    while p < n:
        p <<= 1
    return p


def cast_out(t, dtype):
    """``t`` in ``dtype``, for the return of an ``autograd.Function``'s
    forward: a new tensor only when the dtype differs, and never a no-op
    ``.to()``. ``torch.compile`` on torch 2.11 drops the backward of a
    Function whose forward returns a tensor an op handed back as it was
    (a ``.to()`` or ``.float()`` to the same dtype, an in-place op): the
    inputs then get no gradient through it."""
    return t if t.dtype == dtype else t.to(dtype)


OP_REGISTRY: Dict[str, Callable] = {}


def register_op(name=None, needs_training=False, nondiff=False):
    """Register a functional op under ``name`` (default: the function's).
    ``needs_training``: the op takes ``training=``, which ``nd`` fills from
    ``autograd.is_training()`` when the caller gives none. ``nondiff``:
    ``nd`` records no gradient through it, as the JAX package records none
    through its ``nondiff`` ops (``topk``'s values, the optimizer
    updates)."""
    def deco(fn):
        if needs_training:
            fn.needs_training = True
        if nondiff:
            fn.nondiff = True
        OP_REGISTRY[name or fn.__name__] = fn
        return fn

    return deco


def env_cap(name, default):
    """An integer cache cap from the environment (graphlint GL006's
    knobs), ``default`` when unset or not an integer."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class BoundedCache(dict):
    """A capped dict for module-level program and metadata caches (a copy
    of the JAX package's): insertion-order eviction on insert only, so a
    hit stays a plain dict read. Entries are pure caches: evicting one
    costs a rebuild, never correctness. ``evictions`` counts the drops
    (``observability.snapshot()`` shows them). Inserts take a lock, so two
    threads cannot evict twice or overfill."""

    __slots__ = ("cap", "evictions", "_lk")

    def __init__(self, cap):
        super().__init__()
        self.cap = max(int(cap), 1)
        self.evictions = 0
        self._lk = threading.Lock()

    def __setitem__(self, key, value):
        with self._lk:
            self._insert_locked(key, value)

    def _insert_locked(self, key, value):
        if key not in self and len(self) >= self.cap:
            del self[next(iter(self))]
            self.evictions += 1
        dict.__setitem__(self, key, value)


# the one canonical program cache (``ir.lower``): canonical graph key ->
# IREntry, the optimized graph and every program lowered from it. The bulk window's, Symbol.eval's, the Executor's inference and the
# tape's keys all land here; MXNET_IR_CACHE_CAP bounds it
_IR_CACHE: Dict = BoundedCache(env_cap("MXNET_IR_CACHE_CAP", 2048))
