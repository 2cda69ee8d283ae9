"""Serving snapshots of the port (counterpart of ``mxnet_tpu/cache``): the
artifact a new serving replica starts warm from (``snapshot.py``). The
JAX package's compilation cache (``store.py``: serialized XLA
executables) has no counterpart: a CUDA graph holds one process's device
addresses and cannot be written to a file, so the port keeps only the two
helpers it needs from there, :func:`fingerprint` and :func:`atomic_write`,
as its own copies."""
from .snapshot import (FORMAT, atomic_write, fingerprint,  # noqa: F401
                       load_manifest, load_snapshot, save_snapshot)

__all__ = ["FORMAT", "atomic_write", "fingerprint", "load_manifest",
           "load_snapshot", "save_snapshot"]
