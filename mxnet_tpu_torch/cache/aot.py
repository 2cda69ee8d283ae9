"""Explicit compiles with a persistent disk tier: ``AotFn`` (counterpart of
``mxnet_tpu/cache/aot.py``).

``torch.compile`` compiles lazily inside an opaque wrapper whose code can
be neither kept nor seeded. ``AotFn`` makes the compile explicit: one
``torch.compile(fn, backend=..., fullgraph=True, dynamic=False)`` for each
input signature (shapes, dtypes, strides, devices, whether a tensor
takes a gradient), so each program has a handle the store can key:

* before the compile it looks the program up in the compile store
  (``cache.active_store()``) and, on a hit, loads its Inductor artifacts
  (``torch.compiler.load_cache_artifacts``), so the compile reads
  Inductor's caches instead of generating code;
* the compile happens at the program's first call; Inductor compiles the
  backward at the first backward. :meth:`AotFn.persist` (or the next call)
  then saves what this program recorded, and only that: the artifact
  recorder is cleared before each compile.

A rejected entry (corrupt, foreign, wrong key, or artifacts that do not
load) warns once and the program compiles as if there were none. Each
compile bumps ``engine.aot_compile_counter`` (the retrace watchdog
watches it) with the program's key as the note, adds its seconds to
``observability.note_compile``, and records an uncounted
``aot_compile`` cost profile with its reason: a flop counter over a
compiled callable sees none of its ops.

AOTInductor is not taken: the port's captured programs must stay bit for
bit with eager (Inductor fuses bf16 chains in fp32), and the programs
that are compiled come from ``torch.compile``, whose own artifacts this
store carries.
"""
from __future__ import annotations

import time
import warnings

import torch

__all__ = ["AotFn"]

_UNCOUNTED = ("built by torch.compile (Inductor) at its first call, which "
              "that call consumes: there is no eager first run to count, "
              "and a FlopCounterMode over a compiled callable sees none of "
              "its ops")


def _arg_sig(args, kwargs):
    """A call's hashable signature: per tensor (shape, dtype, strides,
    device, requires_grad), per other value its type's name."""
    from torch.utils._pytree import tree_flatten

    leaves, spec = tree_flatten((args, kwargs))
    sig = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype),
                        tuple(leaf.stride()), str(leaf.device),
                        bool(leaf.requires_grad)))
        else:
            sig.append((type(leaf).__name__,))
    return str(spec), tuple(sig)


def _device_of(args, kwargs):
    from torch.utils._pytree import tree_flatten

    return next((x.device for x in tree_flatten((args, kwargs))[0]
                 if isinstance(x, torch.Tensor)), torch.device("cpu"))


def _clear_recorder():
    """Empty Inductor's artifact recorder, so a save holds one program."""
    from torch.compiler._cache import CacheArtifactManager

    CacheArtifactManager.clear()


class AotFn:
    """A per-signature compile of ``fn`` through ``torch.compile`` and the
    compile store (module docstring). ``tier`` is the store's
    subdirectory; ``hint`` names the program in its store key, notes and
    profiles (default: the function's module and qualified name; give one
    where two processes import the function under different module
    names)."""

    __slots__ = ("_fn", "backend", "_execs", "tier", "hint", "_warned",
                 "_pending", "last_compile_s", "last_loaded")

    def __init__(self, fn, backend="inductor", tier="aot", hint=""):
        self._fn = fn
        self.backend = backend
        self._execs = {}
        self.tier = tier
        self.hint = hint or "%s.%s" % (
            getattr(fn, "__module__", ""),
            getattr(fn, "__qualname__", type(fn).__name__))
        self._warned = False
        self._pending = None
        self.last_compile_s = None
        self.last_loaded = False

    def program_key(self, sig):
        """The text the store digests: backend, tier, the hint (by default
        the function's module and qualified name) and the signature. The
        artifacts are Inductor's own caches, keyed inside by the graphs'
        contents: an entry of another function under one key would only
        miss there, and compile."""
        return "|".join(("aotfn1", self.backend, self.tier, self.hint,
                         repr(sig)))

    def __call__(self, *args, **kwargs):
        if self._pending is not None:
            self.persist()
        sig = _arg_sig(args, kwargs)
        compiled = self._execs.get(sig)
        if compiled is not None:
            return compiled(*args, **kwargs)
        compiled = self._acquire(args, kwargs, sig)
        t0 = time.perf_counter()
        out = compiled(*args, **kwargs)
        self.last_compile_s = time.perf_counter() - t0
        from ..observability import note_compile

        note_compile(self.last_compile_s)
        return out

    def _reject(self, why):
        if not self._warned:
            self._warned = True
            warnings.warn("compile store entry for %s:%s rejected (%s); "
                          "compiling" % (self.tier, self.hint, why),
                          RuntimeWarning, stacklevel=4)

    def _acquire(self, args, kwargs, sig):
        """store lookup -> (load the artifacts) -> torch.compile; the
        compile itself runs at the caller's first call."""
        from .. import engine
        from ..observability import costs
        from . import active_store
        from .store import fingerprint

        store = active_store()
        key = self.program_key(sig)
        self.last_loaded = False
        digest = None
        if store is not None:
            fp = fingerprint(_device_of(args, kwargs))
            digest = store.digest(key, fp)
            # a rejected entry warned once in the store, and compiles
            payload = store.lookup(self.tier, key, fp)
            if payload is not None:
                # torch logs a bundle it cannot read and returns None
                if torch.compiler.load_cache_artifacts(payload) is None:
                    self._reject("torch.compiler.load_cache_artifacts "
                                 "could not read the artifacts")
                else:
                    engine.comp_cache_deserialize_counter.bump()
                    self.last_loaded = True
            _clear_recorder()
            self._pending = None if self.last_loaded else (key, fp)
        compiled = torch.compile(self._fn, backend=self.backend,
                                 fullgraph=True, dynamic=False)
        note = "aot:%s" % (digest or key)[:16]
        engine.aot_compile_counter.bump(note=note)
        costs.note_uncounted("aot_compile", self.hint, key, _UNCOUNTED,
                             key=digest[:16] if digest else None)
        self._execs[sig] = compiled
        return compiled

    def persist(self):
        """Save the artifacts the last compile recorded (call it after the
        first backward: Inductor compiles the backward then). Returns the
        entry's path, or None when there was nothing to save."""
        from . import active_store
        from .store import serialize_compiled

        pending, self._pending = self._pending, None
        store = active_store()
        if pending is None or store is None:
            return None
        data = serialize_compiled()
        if data is None:
            return None
        key, fp = pending
        return store.save(self.tier, key, data, fp)

    # ----------------------------------------------------- handles
    @property
    def traceable(self):
        """The plain function, for callers that trace through it."""
        return self._fn

    def sig_of(self, *args, **kwargs):
        return _arg_sig(args, kwargs)

    def compiled_for(self, sig):
        """The compiled callable of ``sig`` (:meth:`sig_of`), or None."""
        return self._execs.get(sig)

    def adopt(self, compiled, sig):
        """Install a compiled callable for ``sig`` without compiling."""
        self._execs[sig] = compiled

    def signatures(self):
        return list(self._execs)

    def num_compiled(self):
        return len(self._execs)
