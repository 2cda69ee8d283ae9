"""Profiler (counterpart of ``mxnet_tpu/profiler.py``; ref:
src/profiler/profiler.cc, python/mxnet/profiler.py).

MXNet's ``set_config``/``start``/``stop``/``dump``/``dumps`` API over
``torch.profiler``. Two record streams:

* host records: ``scope`` and the fused, serve, decode and backward
  scopes, ``Task``, ``Counter`` and ``Marker`` events, and each served
  request's trace spans, kept in a bounded buffer
  (``MXNET_PROFILER_RECORD_CAP``; past it records are counted as dropped);
* device records: ``start()`` opens a ``torch.profiler`` session (CPU and,
  where a card is present, CUDA activities), and ``stop()`` adds each of
  its kernel events as a record of category ``kernel``.

``dump()`` writes both as Chrome trace-event JSON (chrome://tracing,
Perfetto); ``dumps()`` gives MXNet's aggregate table (count, total, min,
max, average a name) with ``aggregate_stats=True``, else the records. Every
scope is also a ``torch.profiler.record_function`` range, whether or not
this profiler runs, so a ``torch.profiler`` session of its own sees the
port's ranges (``mxnet_tpu_torch::prefill``, ``::decode_step``,
``::optimizer_step``) under their names.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

_config = {"profile_all": False, "profile_imperative": True,
           "filename": "profile.json", "aggregate_stats": False}
_running = False
_records = []          # {"name", "ts_us", "dur_ms", "cat", "ph", ...}
_lock = threading.Lock()
_epoch = time.perf_counter()
_session = None        # the torch.profiler session while running
EDGE_S = 0.05          # the idle margin at each end of a device session
_t_session = 0.0       # when it started (perf_counter)

try:
    _RECORD_CAP = int(os.environ.get("MXNET_PROFILER_RECORD_CAP", "1000000"))
except ValueError:
    _RECORD_CAP = 1000000
_dropped = 0


def record_cap():
    return _RECORD_CAP


def num_records():
    return len(_records)


def records_dropped():
    """Records discarded because the buffer was full: the trace is cut."""
    return _dropped


def set_config(profile_all=False, profile_symbolic=True,
               profile_imperative=True, profile_memory=True, profile_api=True,
               filename="profile.json", aggregate_stats=False, **kwargs):
    _config.update(profile_all=profile_all, filename=filename,
                   profile_imperative=profile_imperative,
                   aggregate_stats=aggregate_stats)


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def is_running():
    return _running


def _settle():
    """Let the device drain, then wait ``EDGE_S``. kineto keeps a kernel
    only if its timestamp, read from the device's clock into the host's,
    falls inside the session, and that reading can be off by more than the
    time between ``start()`` and the first launch: the session opens and
    closes this far from the work it holds."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(EDGE_S)


def start(profile_process="worker"):
    """Start recording: host scopes, and a ``torch.profiler`` session for
    the device's kernels."""
    global _running, _session, _t_session
    if _running:
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _session = torch.profiler.profile(activities=acts)
    _session.__enter__()
    _t_session = time.perf_counter()
    _settle()
    _running = True


def stop(profile_process="worker"):
    """Stop recording; the session's kernel events join the records."""
    global _running, _session
    if not _running:
        return
    _running = False
    session, _session = _session, None
    _settle()
    session.__exit__(None, None, None)
    base = (_t_session - _epoch) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    for ev in session.events():
        if ev.device_type == cuda:
            _record(ev.name, base + ev.time_range.start,
                    (ev.time_range.end - ev.time_range.start) / 1e3,
                    cat="kernel")


def pause(profile_process="worker"):
    stop()


def resume(profile_process="worker"):
    start()


def _record(name, ts_us, dur_ms=None, cat="host", ph="X", **extra):
    global _dropped
    rec = {"name": name, "ts_us": ts_us, "cat": cat, "ph": ph, **extra}
    if dur_ms is not None:
        rec["dur_ms"] = dur_ms
    with _lock:
        if len(_records) >= _RECORD_CAP:
            _dropped += 1
            return
        _records.append(rec)


def aggregate():
    """MXNet's aggregate stats: name -> count, total, min, max, avg (ms)."""
    stats = {}
    with _lock:
        recs = list(_records)
    for r in recs:
        if r.get("ph", "X") != "X":
            continue  # counters and markers have no duration
        s = stats.setdefault(r["name"], {"count": 0, "total_ms": 0.0,
                                         "min_ms": float("inf"),
                                         "max_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += r["dur_ms"]
        s["min_ms"] = min(s["min_ms"], r["dur_ms"])
        s["max_ms"] = max(s["max_ms"], r["dur_ms"])
    for s in stats.values():
        s["avg_ms"] = s["total_ms"] / s["count"]
    return stats


def dumps(reset=False):
    """The aggregate table with ``aggregate_stats=True``, else the records
    as JSON."""
    global _dropped
    if _config["aggregate_stats"]:
        stats = aggregate()
        lines = ["%-40s %8s %12s %10s %10s %10s" %
                 ("Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                  "Avg(ms)")]
        for name, s in sorted(stats.items(),
                              key=lambda kv: -kv[1]["total_ms"]):
            lines.append("%-40s %8d %12.3f %10.3f %10.3f %10.3f" %
                         (name, s["count"], s["total_ms"], s["min_ms"],
                          s["max_ms"], s["avg_ms"]))
        out = "\n".join(lines)
    else:
        with _lock:
            out = json.dumps(_records, indent=2)
    if reset:
        with _lock:
            _records.clear()
            _dropped = 0
    return out


def dump(finished=True, profile_process="worker"):
    """Write the records as Chrome trace-event JSON to the configured
    ``filename``; returns it."""
    events = []
    with _lock:
        for r in _records:
            ev = {"name": r["name"], "cat": r.get("cat", "host"),
                  "ph": r.get("ph", "X"), "ts": r["ts_us"],
                  "pid": os.getpid(),
                  "tid": 1 if r.get("cat") == "kernel" else 0}
            if ev["ph"] == "X":
                ev["dur"] = r["dur_ms"] * 1e3
                if "args" in r:
                    ev["args"] = r["args"]
            elif ev["ph"] == "C":
                ev["args"] = {r["name"]: r["value"]}
            elif ev["ph"] == "i":
                ev["s"] = r.get("s", "g")
            events.append(ev)
    with open(_config["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"droppedRecords": _dropped}}, f)
    return _config["filename"]


@contextlib.contextmanager
def _timed(name, cat, torch_name=None, args=None):
    with torch.profiler.record_function(torch_name or name):
        if not _running:
            yield
            return
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
    if args is None:
        _record(name, (t0 - _epoch) * 1e6, (t1 - t0) * 1e3, cat=cat)
    else:
        _record(name, (t0 - _epoch) * 1e6, (t1 - t0) * 1e3, cat=cat,
                args=args)


def scope(name="<unk>"):
    """A named host range (and a ``record_function`` range)."""
    return _timed(name, "host")


def op_scope(name):
    """One imperative op's dispatch as an ``operator`` event: host time
    only (the launch is asynchronous), as upstream's operator issue
    events."""
    return _timed(name, "operator")


def _fused_label(op_names):
    """``mul x5,add x5,tanh x5``: a fused program's constituents."""
    counts = {}
    for n in op_names:
        counts[n] = counts.get(n, 0) + 1
    label = ",".join("%s x%d" % (n, c) if c > 1 else n
                     for n, c in counts.items())
    if len(label) > 120:
        label = label[:117] + "..."
    return label


def _fused_scope(kind, op_names):
    return _timed("%s[%s]" % (kind, _fused_label(op_names)), "operator",
                  args={"ops": list(op_names)})


def bulk_scope(op_names):
    """One flushed bulk window, named after its ops: ``bulk[mul x5,...]``."""
    return _fused_scope("bulk", op_names)


def backward_scope(op_names):
    """One compiled tape replay, named after its ops: ``backward[...]``."""
    return _fused_scope("backward", op_names)


def serve_scope(bucket, n_real):
    """One served batch: ``serve[b32 fill=0.75]``, the bucket and how much
    of it the coalesced requests filled."""
    return _timed("serve[b%d fill=%.2f]" % (bucket, n_real / max(bucket, 1)),
                  "serve", args={"bucket": bucket, "rows": n_real})


def decode_scope(kind, slots, n_active, torch_name=None):
    """One generative dispatch: ``decode[step fill=0.75 b8]`` for a step of
    the in-flight batch, ``decode[prefill256 fill=...]`` for a prompt's
    fill; ``torch_name`` keeps the port's ``record_function`` name."""
    return _timed("decode[%s fill=%.2f b%d]" % (
        kind, n_active / max(slots, 1), slots), "serve",
        torch_name=torch_name, args={"slots": slots, "active": n_active})


class Domain:
    """A named group of profiler objects (the trace event's ``cat``)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class Task:
    def __init__(self, domain=None, name="task"):
        self.name = name
        self._cat = domain.name if isinstance(domain, Domain) else "host"
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            t1 = time.perf_counter()
            _record(self.name, (self._t0 - _epoch) * 1e6,
                    (t1 - self._t0) * 1e3, cat=self._cat)
            self._t0 = None


Frame = Task
Event = Task


class Counter:
    """A numeric counter, Chrome trace 'C' events."""

    def __init__(self, domain=None, name="counter", value=None):
        self.name = name
        self._cat = domain.name if isinstance(domain, Domain) else "host"
        self._value = 0
        self._vlock = threading.Lock()
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        with self._vlock:
            self._value = value
            _record(self.name, (time.perf_counter() - _epoch) * 1e6,
                    cat=self._cat, ph="C", value=value)

    def _add(self, delta):
        with self._vlock:
            self._value += delta
            _record(self.name, (time.perf_counter() - _epoch) * 1e6,
                    cat=self._cat, ph="C", value=self._value)

    def increment(self, delta=1):
        self._add(delta)

    def decrement(self, delta=1):
        self._add(-delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    """An instant event."""

    def __init__(self, domain=None, name="marker"):
        self.name = name
        self._cat = domain.name if isinstance(domain, Domain) else "host"

    def mark(self, scope="process"):
        _record(self.name, (time.perf_counter() - _epoch) * 1e6,
                cat=self._cat, ph="i",
                s={"process": "p", "thread": "t"}.get(scope, "g"))


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0").lower() in (
        "1", "true", "yes", "on"):
    _config["profile_all"] = True
    start()


def device_memory_summary(device=None):
    """The card's memory counters (``torch.cuda.memory_stats``) in the JAX
    package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "num_allocs": s.get("allocation.all.allocated", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                dev).total_memory}


def dump_memory(path=None, device=None):
    """The memory summary; with ``path``, also written there as JSON."""
    stats = device_memory_summary(device)
    if path:
        with open(path, "w") as f:
            f.write(json.dumps(stats, indent=1, sort_keys=True,
                               default=int) + "\n")
    return stats
