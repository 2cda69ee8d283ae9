"""The disk-backed cross-process compile store (counterpart of
``mxnet_tpu/cache/store.py``).

What the port can carry across processes. A CUDA graph holds one
process's device addresses and cannot leave it (``cache/snapshot.py``),
and the tape's ``aot_eager`` programs and the serving snapshots' programs
generate no code to keep: for them the store is not applicable. The one
compiled artifact that crosses processes is Inductor's: its FX-graph,
AOT-autograd and Triton caches, which ``torch.compiler.
save_cache_artifacts()`` serializes and ``load_cache_artifacts()`` puts
back. ``cache.AotFn`` saves one program's artifacts after its compile
and loads them before the next process's compile of the same program,
which then reads Inductor's caches instead of generating code.

Discipline (the JAX store's):

* entries are content-addressed by the sha256 of the program's key and
  the :func:`fingerprint` (the snapshot fingerprint: torch, CUDA, the
  device's name, the kernel sources; plus the device's capability and
  Triton's version), and written through ``cache.atomic_write``: a
  unique temporary file and a rename, so a reader never sees a torn entry
  and two processes racing on one key write the same bytes;
* a corrupt, foreign or wrong-key entry gives ONE warning and a
  recompile, and is removed;
* mtime GC under ``MXNET_COMP_CACHE_CAP`` bytes (a read refreshes the
  mtime);
* ``engine.comp_cache_hit_counter`` / ``comp_cache_miss_counter`` /
  ``comp_cache_deserialize_counter`` count the lookups.

The store is off unless ``MXNET_COMP_CACHE_DIR`` is set or
``cache.configure`` is called.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import threading
import warnings

import torch

from .snapshot import atomic_write as _atomic_write
from .snapshot import fingerprint as _snapshot_fingerprint

__all__ = ["CompCacheStore", "fingerprint", "pack_entry", "unpack_entry",
           "load_compiled_entry", "serialize_compiled", "SCHEMA",
           "ENTRY_MAGIC", "ENTRY_SUFFIX", "TIERS"]

SCHEMA = "mxct1"
ENTRY_MAGIC = "mxctinductor1"
ENTRY_SUFFIX = ".mxc"
# one subdirectory a build seam; the order of the tiers the JAX store also
# has is its order (a GC over equal mtimes then evicts the same files)
TIERS = ("jit", "tape", "aot")

# what an unreadable entry raises on its way in
_ENTRY_ERRORS = (pickle.UnpicklingError, EOFError, ValueError, TypeError,
                 AttributeError, IndexError, KeyError, ImportError)


def _warn(msg):
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _triton_version():
    from importlib import metadata

    try:
        return metadata.version("triton")
    except metadata.PackageNotFoundError:
        return "none"


def fingerprint(device=None):
    """What an entry's artifacts were made with: the snapshot fingerprint
    (torch, CUDA, the device's name, the kernel sources), the device's
    capability and Triton's version."""
    from ..base import resolve_device

    dev = resolve_device(device)
    cap = "sm_%d%d" % torch.cuda.get_device_capability(dev) \
        if dev.type == "cuda" else "none"
    return "|".join((SCHEMA, _snapshot_fingerprint(dev), "cap=" + cap,
                     "triton=" + _triton_version()))


def pack_entry(key, payload, fp):
    """One entry's bytes: its key (checked on read before the
    fingerprint), the fingerprint and the artifacts."""
    return pickle.dumps({"magic": ENTRY_MAGIC, "key": key,
                         "fingerprint": fp, "payload": bytes(payload)},
                        protocol=pickle.HIGHEST_PROTOCOL)


def unpack_entry(data, expect_key, fp, origin="compile store"):
    """``(blob, None)``, or ``(None, kind)`` with ONE warning: "corrupt"
    (unreadable), "wrong_key", "stale" (another fingerprint)."""
    try:
        blob = pickle.loads(data)
        if not isinstance(blob, dict) or blob.get("magic") != ENTRY_MAGIC:
            raise ValueError("bad magic")
    except _ENTRY_ERRORS as e:
        _warn("%s entry is corrupt (%s: %s); compiling again"
              % (origin, type(e).__name__, e))
        return None, "corrupt"
    if blob.get("key") != expect_key:
        _warn("%s entry key mismatch (found %r, wanted %r); compiling "
              "again" % (origin, blob.get("key"), expect_key))
        return None, "wrong_key"
    if blob.get("fingerprint") != fp:
        _warn("%s entry was built by %r but this process is %r; compiling "
              "again" % (origin, blob.get("fingerprint"), fp))
        return None, "stale"
    return blob, None


def load_compiled_entry(path, expect_key, fp, origin="compile store"):
    """``(artifact bytes, None)`` of an entry file, or ``(None, kind)``
    with one warning when it cannot be used."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        _warn("%s entry unreadable (%s); compiling again" % (origin, e))
        return None, "corrupt"
    blob, fail = unpack_entry(data, expect_key, fp, origin)
    return (None, fail) if blob is None else (blob["payload"], None)


def serialize_compiled():
    """The Inductor artifacts recorded since the recorder was last cleared
    (``torch.compiler.save_cache_artifacts``), or None when there are
    none."""
    got = torch.compiler.save_cache_artifacts()
    return None if got is None else got[0]


class CompCacheStore:
    """One directory of entries in tier subdirectories. Writes and GC take
    a lock; reads do not."""

    def __init__(self, directory, cap_bytes=None):
        self.directory = os.path.abspath(directory)
        if cap_bytes is None:
            try:
                cap_bytes = int(os.environ.get("MXNET_COMP_CACHE_CAP",
                                               2 << 30))
            except ValueError:
                cap_bytes = 2 << 30
        self.cap_bytes = int(cap_bytes)
        self._lock = threading.Lock()
        self.writes = 0
        self.evictions = 0
        self.stale = 0
        self.corrupt = 0
        self.wrong_key = 0

    def digest(self, key_text, fp=None):
        """sha256 of the fingerprint and the program's key."""
        h = hashlib.sha256()
        h.update((fp if fp is not None else fingerprint()).encode())
        h.update(b"\0")
        h.update(key_text.encode() if isinstance(key_text, str)
                 else key_text)
        return h.hexdigest()

    def entry_path(self, tier, digest):
        if tier not in TIERS:
            raise ValueError("unknown compile-store tier %r (one of %s)"
                             % (tier, ", ".join(TIERS)))
        return os.path.join(self.directory, tier, digest + ENTRY_SUFFIX)

    def lookup(self, tier, key_text, fp=None):
        """The entry's artifact bytes, or None (a miss, or an entry
        rejected with one warning and removed). Counts a hit or a miss."""
        from .. import engine

        fp = fp if fp is not None else fingerprint()
        digest = self.digest(key_text, fp)
        path = self.entry_path(tier, digest)
        if not os.path.exists(path):
            engine.comp_cache_miss_counter.bump()
            return None
        payload, fail = load_compiled_entry(path, digest, fp)
        if payload is None:
            with self._lock:
                setattr(self, fail, getattr(self, fail) + 1)
            # a bad entry never becomes good: the next process pays one
            # compile, not one warning a lookup
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            engine.comp_cache_miss_counter.bump()
            return None
        engine.comp_cache_hit_counter.bump()
        os.utime(path, None)  # the GC's recency signal
        return payload

    def save(self, tier, key_text, payload, fp=None):
        """Write one entry; returns its path."""
        fp = fp if fp is not None else fingerprint()
        digest = self.digest(key_text, fp)
        path = self.entry_path(tier, digest)
        self.atomic_write(path, pack_entry(digest, payload, fp))
        with self._lock:
            self.writes += 1
        self.gc()
        return path

    @staticmethod
    def atomic_write(path, data):
        """Unique temporary file + rename (``cache.atomic_write``)."""
        _atomic_write(path, data)

    def _entries(self):
        """[(path, mtime, size)] over the tiers."""
        out = []
        for tier in TIERS:
            d = os.path.join(self.directory, tier)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if not name.endswith(ENTRY_SUFFIX):
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except FileNotFoundError:
                    continue  # another process evicted it
                out.append((p, st.st_mtime, st.st_size))
        return out

    def gc(self):
        """Evict the oldest-mtime entries until the bytes fit the cap;
        returns how many went. An eviction costs at most a compile."""
        with self._lock:
            entries = self._entries()
            total = sum(s for _, _, s in entries)
            if total <= self.cap_bytes:
                return 0
            evicted = 0
            for p, _, s in sorted(entries, key=lambda e: e[1]):
                if total <= self.cap_bytes:
                    break
                try:
                    os.remove(p)
                except FileNotFoundError:
                    continue
                total -= s
                evicted += 1
            self.evictions += evicted
            return evicted

    def scan(self):
        """Per-tier {entries, bytes} and the totals."""
        tiers = {}
        total_n = total_b = 0
        for tier in TIERS:
            d = os.path.join(self.directory, tier)
            n = b = 0
            if os.path.isdir(d):
                for name in os.listdir(d):
                    if name.endswith(ENTRY_SUFFIX):
                        try:
                            b += os.path.getsize(os.path.join(d, name))
                            n += 1
                        except FileNotFoundError:
                            pass
            tiers[tier] = {"entries": n, "bytes": b}
            total_n += n
            total_b += b
        return {"dir": self.directory, "cap_bytes": self.cap_bytes,
                "entries": total_n, "bytes": total_b, "tiers": tiers,
                "writes": self.writes, "evictions": self.evictions,
                "stale": self.stale, "corrupt": self.corrupt,
                "wrong_key": self.wrong_key}
