"""Per-program cost attribution (counterpart of ``mxnet_tpu/observability/
costs.py``): flops, bytes and peak device memory of every program the port
builds, as telemetry.

The JAX package reads XLA's ``cost_analysis`` of each compiled program. A
CUDA graph has no such analysis, and a counter sees nothing of a replay, so
the port counts a program on a RUN of it: the first warm-up run of each
key, before ``capture.capture_graph`` captures it (on the CPU, where the
programs run eagerly under the same keys, their first run). Never inside a
capture, and never over a ``torch.compile``d callable.

A counted run goes through two dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode`` gives ``flops``. It counts
  products only (mm, bmm, addmm, convolution, attention): an elementwise
  op counts zero flops here where XLA counts it. The port's flash-attention
  ``torch.library`` ops are taught torch's SDPA formulas
  (:func:`register_kernel_flops`: forward 4·B·H·Tq·Tk·D, backward 2.5x
  that); the LayerNorm and softmax-xent ops count zero flops, as aten's
  ``layer_norm`` does, and their bytes count.
* a recorder keeps every aten (or kernel) op's name, the shapes and dtypes
  of its tensor arguments and results, its scalar arguments and the value
  identities between ops: the program's op record. ``bytes`` is the sum
  over the ops that are not views of their inputs' and outputs' bytes (the
  unfused program's traffic; XLA's figure is of the fused one). The key is
  a sha256 over the record without the identities, so the same program
  gets the same key in every process. ``analysis.hlolint`` lints the
  record.

``peak_bytes`` is the device's allocation high-water mark over the counted
run (``torch.cuda.max_memory_allocated`` after a reset), ``None`` on the
CPU. The op histogram names the kernel ops a program launches.

Programs and their tiers (the build counters the watchdog watches):
``serve_capture`` (a served bucket), ``decode_capture`` (a decode, verify
or chunk step), ``bulk_compile`` (a bulk window), ``tape_compile`` (a tape
backward: counted on the CPU's eager route; the compiled route's backward
is consumed by the run that compiles it, so its profile says it was not
counted and why), ``symbol_compile`` (an ``Executor`` program),
``hybrid_capture`` (a hybridized block's forward), ``step_program``
(the optimizer's fused step) and ``aot_compile`` (a ``cache.AotFn``
compile: Inductor's, uncounted, with its reason). The data-parallel buckets are eager
collectives in the port, built into no program, so they have none.

Surfaced as ``observability.snapshot()["costs"]`` and, in the Prometheus
text, as ``program="tier:key"`` samples. Kill switch:
``MXNET_COST_ATTRIBUTION=0`` (or :func:`set_enabled`): nothing is counted.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import sys
import threading
import weakref

import torch


def _env_enabled():
    v = os.environ.get("MXNET_COST_ATTRIBUTION", "1").strip().lower()
    return v not in ("0", "false", "off", "no")


_enabled = _env_enabled()
_lock = threading.Lock()
# bounded, as every telemetry structure
_PROFILE_CAP = 512
_profiles = {}          # (tier, key) -> CostProfile, insertion-ordered
_records = {}           # (tier, key) -> the op record (hlolint's input)
_dropped = 0            # profiles evicted past the cap

TIERS = ("serve_capture", "decode_capture", "bulk_compile", "tape_compile",
         "symbol_compile", "hybrid_capture", "step_program", "aot_compile")

_FIELDS = ("flops", "bytes", "peak_bytes")


class CostProfile:
    """One program's cost columns. ``counted`` is False for a program that
    could not be counted, and ``reason`` says why (its columns are
    ``None`` then, never a silent zero)."""

    __slots__ = ("tier", "key", "hint", "builds", "ops", "counted",
                 "reason", "n_ops") + _FIELDS

    def __init__(self, tier, key, hint, flops=None, bytes=None,
                 peak_bytes=None, ops=None, counted=True, reason=None,
                 n_ops=0):
        self.tier = tier
        self.key = key
        self.hint = hint
        self.builds = 1
        self.flops = flops
        self.bytes = bytes
        self.peak_bytes = peak_bytes
        self.ops = dict(ops or {})
        self.counted = counted
        self.reason = reason
        self.n_ops = n_ops

    def as_dict(self):
        d = {f: getattr(self, f) for f in self.__slots__}
        d["ops"] = dict(self.ops)
        return d


# ----------------------------------------------------------- the op record
def _op_name(func):
    """``aten.mm.default`` / ``mxnet_tpu_torch.flash_fwd.default``."""
    return str(func)


def _scalar(v):
    """A JSON-able image of a non-tensor argument (part of the key); a
    float that is not finite as its name, so two records compare equal."""
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (torch.dtype, torch.device, torch.memory_format,
                      torch.layout)):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [_scalar(x) for x in v]
    return type(v).__name__


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each op of a run: name, tensor arguments and results (value
    id, then :meth:`_desc`), and the scalar arguments."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self._ids = {}      # id(tensor) -> (weakref, value id)
        self._args = 0
        self._made = 0      # values produced (a freed tensor's id is reused:
        #                     the count of ids would issue a value id twice)

    def _vid(self, t, produced):
        ent = self._ids.get(id(t))
        if ent is not None and ent[0]() is t:
            return ent[1]
        if produced:
            vid = "%%%d" % self._made
            self._made += 1
        else:
            vid = "arg%d" % self._args
            self._args += 1
        self._ids[id(t)] = (weakref.ref(t), vid)
        return vid

    @staticmethod
    def _desc(t):
        """(shape, dtype, device type, whether a stride is 0, the elements
        its memory holds)."""
        dense = 1
        for n, st in zip(t.shape, t.stride()):
            if st:
                dense *= n
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
                t.device.type, 0 in t.stride() and t.numel() > 1, dense)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in, _ = torch.utils._pytree.tree_flatten((args, kwargs))
        ins = [(self._vid(a, False),) + self._desc(a)
               for a in flat_in if isinstance(a, torch.Tensor)]
        scalars = [_scalar(a) for a in flat_in
                   if not isinstance(a, torch.Tensor)]
        out = func(*args, **kwargs)
        flat_out, _ = torch.utils._pytree.tree_flatten(out)
        outs = [(self._vid(o, True),) + self._desc(o)
                for o in flat_out if isinstance(o, torch.Tensor)]
        view = bool(getattr(func, "is_view", False))
        self.ops.append({"op": _op_name(func), "ins": ins, "outs": outs,
                         "scalars": scalars, "view": view})
        return out

    def result_ids(self, result):
        """The value ids of a run's returned tensors (arguments returned
        untouched keep their ``arg`` ids)."""
        flat, _ = torch.utils._pytree.tree_flatten(result)
        return [self._vid(t, False) for t in flat
                if isinstance(t, torch.Tensor)]


_ITEMSIZE = {}


def _nbytes(desc):
    shape, dtype = desc[1], desc[2]
    size = _ITEMSIZE.get(dtype)
    if size is None:
        size = _ITEMSIZE[dtype] = getattr(torch, dtype).itemsize
    n = 1
    for s in shape:
        n *= s
    return n * size


def program_key(ops):
    """sha256 over the op record (names, shapes, dtypes, scalar arguments;
    not the value ids), 16 hex characters: the same program has the same
    key in every process."""
    canon = [[o["op"], [d[1:3] for d in o["ins"]],
              [d[1:3] for d in o["outs"]], o["scalars"]] for o in ops]
    h = hashlib.sha256(json.dumps(canon, sort_keys=True,
                                  default=str).encode("utf-8"))
    return h.hexdigest()[:16]


def record_bytes(ops):
    """The per-op sum of input and output bytes over the ops that are not
    views."""
    total = 0
    for o in ops:
        if not o["view"]:
            total += sum(_nbytes(d) for d in o["ins"] + o["outs"])
    return total


# ------------------------------------------------------ the kernels' flops
_KERNEL_OPS = ("flash_fwd", "flash_fwd_f32", "flash_bwd")


def _flash_fwd_flops(q, k, v, *rest, out_shape=None, **kw):
    from torch.utils.flop_counter import sdpa_flop_count

    return sdpa_flop_count(q, k, v)


def _flash_bwd_flops(q, k, v, do, *rest, out_shape=None, **kw):
    from torch.utils.flop_counter import sdpa_backward_flop_count

    return sdpa_backward_flop_count(do, q, k, v)


def _kernel_targets():
    from ..ops.cuda import flash_attention  # noqa: F401 (defines the ops)

    ns = torch.ops.mxnet_tpu_torch
    return {ns.flash_fwd: _flash_fwd_flops,
            ns.flash_fwd_f32: _flash_fwd_flops,
            ns.flash_bwd: _flash_bwd_flops}


_formulas = [False]  # registered once, at the first counted run


def register_kernel_flops():
    """Teach ``FlopCounterMode`` the flash ops' flops (torch's SDPA
    formulas). Idempotent; returns the number newly registered. The first
    counted run does it; after :func:`unregister_kernel_flops` only this
    puts them back."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    _formulas[0] = True
    n = 0
    for target, formula in _kernel_targets().items():
        if target not in flop_registry:
            register_flop_formula(target)(formula)
            n += 1
    return n


def unregister_kernel_flops():
    """Take the flash ops' formulas out (a planted fault: they then count
    zero until :func:`register_kernel_flops`). Returns the number
    removed."""
    from torch.utils.flop_counter import flop_registry

    _formulas[0] = True
    n = 0
    for target in _kernel_targets():
        if flop_registry.pop(target, None) is not None:
            n += 1
    return n


# ---------------------------------------------------------------- counting
class Meter:
    """One program's pending count: :func:`counting` counts the first run
    it is given and records the profile."""

    __slots__ = ("tier", "hint", "device", "done")

    def __init__(self, tier, hint, device):
        if tier not in TIERS:
            raise ValueError("unknown cost tier %r (one of %s)"
                             % (tier, ", ".join(TIERS)))
        self.tier = tier
        self.hint = hint
        self.device = torch.device(device)
        self.done = False


def meter(tier, hint, device):
    """A :class:`Meter` for a new program, or None when attribution is
    off."""
    return Meter(tier, hint, device) if _enabled else None


@contextlib.contextmanager
def counting(m):
    """Count the ops run inside the block into ``m``'s program, the first
    time only (``m`` None or done: nothing). An error inside propagates and
    records nothing."""
    if m is None or m.done or not _enabled:
        yield None
        return
    from torch.utils.flop_counter import FlopCounterMode

    if not _formulas[0]:
        register_kernel_flops()
    cuda = m.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(m.device)
    rec = _Recorder()
    box = {}
    with FlopCounterMode(display=False) as fc:
        with rec:
            yield box
    m.done = True
    peak = int(torch.cuda.max_memory_allocated(m.device)) if cuda else None
    if "result" in box:
        rec.ops.append({"op": "return", "ins": [
            (vid, (), "", "", False, 0) for vid in rec.result_ids(
                box["result"])], "outs": [], "scalars": [], "view": True})
    _put(m.tier, m.hint, rec.ops, int(fc.get_total_flops()), peak)


def run_counted(m, fn):
    """``fn()``, counted into ``m`` when it is pending; returns what ``fn``
    returned."""
    if m is None or m.done or not _enabled:
        return fn()
    with counting(m) as box:
        out = fn()
        box["result"] = out
    return out


def measure(fn, device):
    """``(fn(), {"flops", "bytes", "peak_bytes"})``: one run counted as
    :func:`counting` counts a program's first run, recorded nowhere (the
    tuner's candidate probes, which are no program of the process);
    ``peak_bytes`` is the run's high-water mark above its start."""
    from torch.utils.flop_counter import FlopCounterMode

    if not _formulas[0]:
        register_kernel_flops()
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
    rec = _Recorder()
    with FlopCounterMode(display=False) as fc:
        with rec:
            out = fn()
    # the run's own high-water mark above what was allocated at its start
    # (the absolute mark moves with whatever earlier runs left cached)
    peak = int(torch.cuda.max_memory_allocated(device)) - start if cuda \
        else None
    return out, {"flops": int(fc.get_total_flops()),
                 "bytes": record_bytes(rec.ops), "peak_bytes": peak}


def _histogram(ops):
    hist = {}
    for o in ops:
        if o["op"] != "return":
            hist[o["op"]] = hist.get(o["op"], 0) + 1
    return dict(sorted(hist.items()))


def _put(tier, hint, ops, flops, peak):
    global _dropped
    key = program_key(ops)
    with _lock:
        prof = _profiles.get((tier, key))
        if prof is not None:
            prof.builds += 1
            return prof
        if len(_profiles) >= _PROFILE_CAP:
            old = next(iter(_profiles))
            _profiles.pop(old)
            _records.pop(old, None)
            _dropped += 1
        prof = CostProfile(tier, key, hint, flops=flops,
                           bytes=record_bytes(ops), peak_bytes=peak,
                           ops=_histogram(ops),
                           n_ops=sum(o["op"] != "return" for o in ops))
        _profiles[(tier, key)] = prof
        _records[(tier, key)] = ops
        return prof


def note_uncounted(tier, hint, what, reason, key=None):
    """Record a program that could not be counted: its key is ``key``, or
    one over ``what`` (the build site's own key), its columns are None and
    ``reason`` says why."""
    global _dropped
    if not _enabled:
        return None
    if key is None:
        key = hashlib.sha256(repr(what).encode("utf-8")).hexdigest()[:16]
    with _lock:
        prof = _profiles.get((tier, key))
        if prof is not None:
            prof.builds += 1
            return prof
        if len(_profiles) >= _PROFILE_CAP:
            old = next(iter(_profiles))
            _profiles.pop(old)
            _records.pop(old, None)
            _dropped += 1
        prof = _profiles[(tier, key)] = CostProfile(
            tier, key, hint, counted=False, reason=reason)
        return prof


def profiles():
    """Recorded profiles as ``{"tier:key": dict}`` (copies)."""
    with _lock:
        return {"%s:%s" % (t, k): p.as_dict()
                for (t, k), p in _profiles.items()}


def records():
    """{(tier, key): (hint, op record)} of the counted programs."""
    with _lock:
        return {tk: (_profiles[tk].hint, list(ops))
                for tk, ops in _records.items() if tk in _profiles}


# ------------------------------------------------------------- the ledgers
def _tensor_bytes(t):
    return int(t.numel() * t.element_size())


def _params_nbytes(block):
    return sum(_tensor_bytes(p._data) for p in block.collect_params().values()
               if p._data is not None)


def _peak_of(tiers):
    with _lock:
        peaks = [p.peak_bytes for (t, _k), p in _profiles.items()
                 if t in tiers and p.peak_bytes is not None]
    return int(max(peaks)) if peaks else None


def _server_ledger(s):
    row = {"params_bytes": _params_nbytes(s.model)}
    cache = getattr(s, "cache", None)
    if cache is not None and hasattr(cache, "nbytes"):
        row["kv_cache_bytes"] = int(cache.nbytes())
        row["kv_cache_bytes_unquantized"] = int(cache.nbytes_unquantized())
    row["program_peak_bytes"] = _peak_of(("serve_capture",
                                          "decode_capture"))
    row["total_bytes"] = (row["params_bytes"] + row.get("kv_cache_bytes", 0)
                          + (row["program_peak_bytes"] or 0))
    return row


def hbm_ledger():
    """Each live server's device bytes: its parameters, its paged KV cache
    (``PagedKVCache.nbytes()``, quantization-aware) and the peak of the
    serve and decode programs' counted runs (None on the CPU)."""
    out = {"servers": {}}
    serve = sys.modules.get("mxnet_tpu_torch.serve")
    if serve is None:
        out["subsystem"] = "not loaded"
        return out
    for s in list(getattr(serve, "_SERVERS", ())):
        out["servers"][s.name] = _server_ledger(s)
    return out


def trainer_ledger(trainer):
    """A ``gluon.Trainer``'s device bytes: parameters, gradients and
    optimizer states (every tensor leaf of its states), and the peak of the
    step programs' counted runs."""
    from ..util import tree_leaves

    params_b = grads_b = 0
    for p in trainer._params:
        if p._data is None:
            continue
        params_b += _tensor_bytes(p._data)
        if p._data.grad is not None:
            grads_b += _tensor_bytes(p._data.grad)
    states_b = sum(_tensor_bytes(t) for t in tree_leaves(
        dict(trainer._states)) if isinstance(t, torch.Tensor))
    peak = _peak_of(("step_program", "hybrid_capture", "tape_compile"))
    row = {"params_bytes": params_b, "grads_bytes": grads_b,
           "optimizer_state_bytes": states_b,
           "program_peak_bytes": peak}
    row["total_bytes"] = params_b + grads_b + states_b + (peak or 0)
    return row


# ---------------------------------------------------------------- snapshot
def snapshot_section():
    """The ``snapshot()["costs"]`` section: the profiles, per-tier totals,
    the ledger; bounded and JSON-able."""
    profs = profiles()
    with _lock:
        dropped = _dropped
    totals = {}
    for prof in profs.values():
        t = totals.setdefault(prof["tier"], {
            "programs": 0, "uncounted": 0, "flops": 0, "bytes": 0,
            "peak_bytes": None})
        t["programs"] += 1
        if not prof["counted"]:
            t["uncounted"] += 1
            continue
        t["flops"] += prof["flops"]
        t["bytes"] += prof["bytes"]
        if prof["peak_bytes"] is not None:
            t["peak_bytes"] = max(t["peak_bytes"] or 0, prof["peak_bytes"])
    return {"enabled": _enabled, "profiles": profs, "totals": totals,
            "dropped": dropped, "ledger": hbm_ledger()}


# ---------------------------------------------------------------- switches
def enabled():
    return _enabled


def set_enabled(on=True):
    """The kill switch (also ``MXNET_COST_ATTRIBUTION=0`` at import).
    Returns the previous state. A program built while it is off is never
    counted later."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def reset():
    """Drop every recorded profile."""
    global _dropped
    with _lock:
        _profiles.clear()
        _records.clear()
        _dropped = 0
