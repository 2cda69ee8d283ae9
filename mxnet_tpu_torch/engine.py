"""Execution engine facade (counterpart of ``mxnet_tpu/engine.py``; ref:
src/engine/threaded_engine_perdevice.cc).

Device-side ordering and asynchrony are the CUDA stream's job. Two host-side
responsibilities remain, as in the JAX package:

* the host task engine: :class:`NativeEngine` over the prebuilt native
  dependency engine ``src/engine_cc/libmxtpu.so``, MXNet's
  ``Push(fn, const_vars, mutable_vars)``. The library is loaded read-only
  as it lies in the checkout; nothing here builds it, and a missing or
  unloadable library raises.
* the bulk window, the counterpart of ThreadedEngine's op bulking
  (``MXNET_ENGINE_BULK_SIZE``: default 0 here, where upstream's and the
  JAX package's is 15; ``ROADMAP.md`` C.2). With a size above 0, fusible
  imperative ops defer into a per-thread window instead of running one by
  one; the window
  flushes as ONE program at a sync point (``asnumpy``/``wait_to_read``, a
  scalar read, mutation, ``autograd.record`` entry, a non-fusible
  consumer, the watermark, ``waitall``). ``ndarray.py`` owns the node type
  and the flush; this module owns the window, the size knob and the
  counters. ``set_bulk_size(0)`` / ``bulk(0)`` restore per-op dispatch.

The counters are the JAX module's, with the same meanings where the port
has the thing they count: ``dispatch`` (an eager op, or a flushed window,
is one dispatch), ``bulk_compile`` (a window program built), ``tape_compile``
and ``tape_cache_hit`` (the compiled backward, ``autograd.py``),
``symbol_compile`` (an executor program captured, ``symbol.py``). The
port adds ``tape_eager``: backwards that took one of the counted eager
routes of the tape replay, and the capture counters in place of the JAX
module's serving and decode compile counters: ``serve_capture`` (a served
bucket's graph), ``decode_capture`` (a decode step program) and
``hybrid_capture`` (a hybridized block's key). Each build bumps its
counter with the key of what it built (``bump(note=...)``), which the
retrace watchdog names. The compile-cache and ``dist`` counters count
programs the port keeps elsewhere: the gradient buckets in
``dist.bucketer``'s counters.
"""
from __future__ import annotations

import ctypes
import os
import threading

__all__ = ["DispatchCounter", "bulk", "bulk_size", "set_bulk_size", "flush",
           "NativeEngine", "default_engine", "native_lib_path"]


class DispatchCounter:
    """A named host counter: ``bump()`` adds, ``reset()`` zeroes,
    ``count`` reads. Tests reset one before a region and read it after.
    ``bump(note=key)`` also calls the watch hook, when one is set
    (``observability.watchdog``), with the key of what was built."""

    __slots__ = ("count", "name", "_watch")

    def __init__(self, name=""):
        self.count = 0
        self.name = name
        self._watch = None

    def bump(self, n=1, note=None):
        self.count += n
        watch = self._watch
        if watch is not None:
            watch(self, n, note)

    def reset(self):
        self.count = 0


dispatch_counter = DispatchCounter("dispatch")
# one bump per window program BUILT (a new chain structure); a steady loop
# re-running an identical chain must not bump it
bulk_compile_counter = DispatchCounter("bulk_compile")
# compiled tape replay: one bump per backward graph torch's compiled
# autograd built, and one per backward that ran a built one
tape_compile_counter = DispatchCounter("tape_compile")
tape_cache_hit_counter = DispatchCounter("tape_cache_hit")
# backwards that took a counted eager route (the tape replay off, a tape
# holding an autograd.Function node, a parameter hook on the tape)
tape_eager_counter = DispatchCounter("tape_eager")
# symbolic executors: one bump per program captured
symbol_compile_counter = DispatchCounter("symbol_compile")
# control flow's host reads: a cond's predicate (an Executor keys its
# program on it; nd.contrib.cond reads it each call) and each step of an
# unbounded nd.contrib.while_loop
cond_host_read_counter = DispatchCounter("cond_host_read")
while_host_read_counter = DispatchCounter("while_host_read")
# an Executor's forward run again because a predicate its program computed
# picked another branch than the program was keyed on
cond_rerun_counter = DispatchCounter("cond_rerun")
# the port's CUDA-graph captures, one bump per program made: a served
# bucket (serve/executor_pool.py), a decode step program
# (serve/step_graph.py), a hybridized block's key (gluon/hybrid.py); the
# retrace watchdog watches them with the compile counters above
serve_capture_counter = DispatchCounter("serve_capture")
decode_capture_counter = DispatchCounter("decode_capture")
hybrid_capture_counter = DispatchCounter("hybrid_capture")

# off by default, where upstream's and the JAX package's window holds 15
# ops (ROADMAP.md C.2): on the card a window's program measured slower than
# its ops one by one (PERF.md section 6)
DEFAULT_BULK_SIZE = 0

try:
    _bulk_size = int(os.environ.get("MXNET_ENGINE_BULK_SIZE",
                                    str(DEFAULT_BULK_SIZE)))
except ValueError:
    _bulk_size = DEFAULT_BULK_SIZE

_bulk_tls = threading.local()

# set by ndarray at import: flushes the current thread's window
_flush_hook = None


class _BulkWindow:
    """One thread's deferred ops. The program's cache key is built as the
    nodes are made, so a flush is a lookup and one run.

    nodes:     the deferred nodes in creation (so topological) order
    leaves:    the program's inputs: tensors captured at invocation (a later
               rebind of an input array does not reach them) and scalars
    leaf_sigs: a hashable signature per leaf (shape, dtype, strides,
               device; or the scalar's type)
    leaf_ids:  id(tensor) or (type, value) -> leaf index
    versions:  each tensor leaf's version counter at invocation (a leaf
               written in place before the flush raises)
    key_parts: per node (op, static attrs, input wiring)
    """

    __slots__ = ("nodes", "leaves", "leaf_sigs", "leaf_ids", "versions",
                 "key_parts", "device")

    def __init__(self):
        self.reset()

    def reset(self):
        self.nodes = []
        self.leaves = []
        self.leaf_sigs = []
        self.leaf_ids = {}
        self.versions = {}
        self.key_parts = []
        self.device = None

    def __len__(self):
        return len(self.nodes)


def _window():
    """The current thread's window (thread-local, as MXNet's bulk state)."""
    w = getattr(_bulk_tls, "window", None)
    if w is None:
        w = _bulk_tls.window = _BulkWindow()
    return w


def bulk_size():
    return _bulk_size


def flush():
    """Run the current thread's pending window as one program (nothing when
    it is empty). Every sync point funnels here."""
    w = getattr(_bulk_tls, "window", None)
    if _flush_hook is not None and w is not None and w.nodes:
        _flush_hook()


def set_bulk_size(size):
    """Set the window size and return the previous one (ref:
    engine.cc:SetBulkSize). ``size > 0`` defers fusible ops, 0 runs each op
    as it comes. A change is a sync point: the pending window flushes
    first."""
    global _bulk_size
    flush()
    prev, _bulk_size = _bulk_size, int(size)
    return prev


class bulk:
    """``with bulk(n):`` runs the block with window size ``n`` and flushes
    at its exit (ref: python/mxnet/engine.py:bulk). ``bulk(0)`` is per-op
    dispatch."""

    def __init__(self, size):
        self._size = size

    def __enter__(self):
        self._prev = set_bulk_size(self._size)
        return self

    def __exit__(self, *a):
        set_bulk_size(self._prev)


def native_lib_path():
    """Where the prebuilt ``libmxtpu.so`` lies in the checkout."""
    return os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "src", "engine_cc", "libmxtpu.so"))


_lib = None
_lib_lock = threading.Lock()


def _native():
    """The loaded library, its entry points typed. Raises ``OSError`` when
    it is missing or does not load."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so = native_lib_path()
            if not os.path.exists(so):
                raise OSError("the native engine library %s is missing (it "
                              "is prebuilt and committed; the port does not "
                              "build it)" % so)
            lib = ctypes.CDLL(so)
            lib.mxtpu_engine_create.restype = ctypes.c_void_p
            lib.mxtpu_engine_create.argtypes = [ctypes.c_int]
            lib.mxtpu_engine_push.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                ctypes.POINTER(ctypes.c_long), ctypes.c_int]
            lib.mxtpu_engine_wait_all.argtypes = [ctypes.c_void_p]
            lib.mxtpu_engine_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class NativeEngine:
    """Dependency-tracked host task engine: ``push(fn, const_vars,
    mutable_vars)`` runs ``fn`` once every earlier write to a const var and
    every earlier access to a mutable var is done (ref:
    include/mxnet/engine.h:PushAsync)."""

    def __init__(self, num_threads=4):
        self._lib = _native()
        self._h = self._lib.mxtpu_engine_create(num_threads)
        self._keep = []
        self._guard = threading.Lock()
        self._next_var = 1000

    def new_variable(self):
        with self._guard:
            self._next_var += 1
            return self._next_var

    def push(self, fn, const_vars=(), mutable_vars=()):
        cb = _CALLBACK(lambda _: fn())
        with self._guard:
            self._keep.append(cb)
        cv = (ctypes.c_long * len(const_vars))(*const_vars)
        mv = (ctypes.c_long * len(mutable_vars))(*mutable_vars)
        self._lib.mxtpu_engine_push(self._h, ctypes.cast(cb, ctypes.c_void_p),
                                    cv, len(const_vars), mv,
                                    len(mutable_vars))

    def wait_all(self):
        self._lib.mxtpu_engine_wait_all(self._h)
        with self._guard:
            self._keep = []

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mxtpu_engine_destroy(h)


_default_engine = None


def default_engine():
    global _default_engine
    if _default_engine is None:
        _default_engine = NativeEngine()
    return _default_engine
