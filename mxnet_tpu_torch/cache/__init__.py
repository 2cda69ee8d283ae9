"""The port's persistent compilation layer (counterpart of
``mxnet_tpu/cache``). Two tiers, as in the JAX package:

* the compile store (``store.py``, ``aot.py``): ``AotFn`` compiles
  explicitly once a signature through ``torch.compile`` and keeps each
  program's Inductor artifacts in ``MXNET_COMP_CACHE_DIR``, so a fresh
  process compiling the same program reads Inductor's caches instead of
  generating code (``phase_tape_replay``'s GPT-2 step on the card);
* serving snapshots (``snapshot.py``): the artifact a new serving replica
  starts warm from.

What the store cannot hold, and why (the JAX store persists every
compiled XLA executable): a CUDA graph holds one process's device
addresses, so the window's, the ``Executor``'s and the servers' captured
programs are not applicable, and neither are the tape's ``aot_eager``
programs nor the serving snapshots' programs, which generate no code to
keep. AOTInductor is not taken either: the captured programs must stay
bit for bit with eager, and the compiled ones come from
``torch.compile``, whose own artifacts the store carries.

The store is off unless ``MXNET_COMP_CACHE_DIR`` is set (cap
``MXNET_COMP_CACHE_CAP`` bytes) or :func:`configure` is called.
"""
from __future__ import annotations

import os

from .aot import AotFn  # noqa: F401
from .snapshot import (FORMAT, atomic_write, fingerprint,  # noqa: F401
                       load_manifest, load_snapshot, save_snapshot)
from .store import CompCacheStore  # noqa: F401

__all__ = ["AotFn", "CompCacheStore", "configure", "active_store",
           "enabled", "disable", "persistent_backed", "traceable", "stats",
           "FORMAT", "atomic_write", "fingerprint", "load_manifest",
           "load_snapshot", "save_snapshot"]

_STORE = None
_ENV_CHECKED = False


def configure(directory, cap_bytes=None):
    """Turn the compile store on at ``directory`` (made at the first
    write); returns it."""
    global _STORE, _ENV_CHECKED
    _STORE = CompCacheStore(directory, cap_bytes=cap_bytes)
    _ENV_CHECKED = True
    return _STORE


def disable():
    """Turn the store off; compiled programs in memory stay."""
    global _STORE, _ENV_CHECKED
    _STORE = None
    _ENV_CHECKED = True


def active_store():
    """The live store, configured from ``MXNET_COMP_CACHE_DIR`` at the
    first call; None when off."""
    global _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        d = os.environ.get("MXNET_COMP_CACHE_DIR")
        if d:
            configure(d)
    return _STORE


def enabled():
    return active_store() is not None


def traceable(fn):
    """The plain function behind an ``AotFn`` (anything else as it is)."""
    return fn.traceable if isinstance(fn, AotFn) else fn


def persistent_backed(fn, backend="inductor", tier="aot", hint=""):
    """An ``AotFn`` over ``fn`` when the store is on, else None (the caller
    keeps its own path)."""
    if active_store() is None:
        return None
    return AotFn(fn, backend=backend, tier=tier, hint=hint)


def stats():
    """The observability "comp_cache" section: the store's scan and the
    engine's counters; it says when the store is off."""
    from .. import engine

    st = active_store()
    out = {"enabled": st is not None,
           "hits": engine.comp_cache_hit_counter.count,
           "misses": engine.comp_cache_miss_counter.count,
           "deserializes": engine.comp_cache_deserialize_counter.count,
           "aot_compiles": engine.aot_compile_counter.count}
    if st is not None:
        out.update(st.scan())
    return out
