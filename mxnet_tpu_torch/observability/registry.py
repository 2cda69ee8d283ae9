"""Metrics registry — counters, gauges, bounded histograms (a copy of
``mxnet_tpu/observability/registry.py``, which imports nothing of JAX).

The one place runtime telemetry lives (ref: mxnet-model-server's
mms/metrics MetricsStore, here process-wide instead of per-worker).
Everything the repo already proves with ad-hoc state — the engine
dispatch/compile ``DispatchCounter``s, the serve latency rings, the
comp-cache tallies, the bounded program caches — is *absorbed* by
registered collectors (pull model: the existing objects stay the source
of truth and keep their names/APIs; the registry reads them at snapshot
time, so the hot paths pay nothing). New telemetry is created through
:class:`MetricsRegistry` — graphlint GL009 flags ad-hoc metric state
declared anywhere else.

Two export shapes, both derived from one ``snapshot()`` dict:

* stable JSON (``observability.snapshot()``) — what
  ``tools/diagnose.py --json`` emits verbatim;
* Prometheus text exposition (:func:`render_prometheus`) — what the
  opt-in ``/metrics`` HTTP endpoint serves.

Histograms are bounded rings (the ``ServeMetrics`` discipline — O(1) per
observation, no unbounded growth in long-running replicas; the GL006
concern applied to telemetry itself).
"""
from __future__ import annotations

import threading


class Counter:
    """Monotonic counter. ``inc()`` takes the metric's own lock — this is
    for control-plane events (compiles, sheds, HTTP scrapes), not the
    per-op hot loop; the hot loop keeps its lock-free ``DispatchCounter``s
    and the registry reads them through a collector."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Point-in-time value: ``set()`` stores one, or ``set_fn()`` installs
    a zero-arg callable evaluated lazily at snapshot time (how live sizes —
    cache entries, HBM bytes — are exposed without any push-site wiring)."""

    __slots__ = ("name", "help", "_value", "_fn")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._value = None
        self._fn = None

    def set(self, value):
        self._value = value

    def set_fn(self, fn):
        self._fn = fn
        return self

    @property
    def value(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return None
        return self._value


class Histogram:
    """Bounded-ring histogram with nearest-rank p50/p95/p99 — the same
    estimator and O(1)-per-observation ring as ``ServeMetrics``."""

    __slots__ = ("name", "help", "_window", "_ring", "_n", "_sum", "_lock")

    def __init__(self, name, help="", window=2048):
        self.name = name
        self.help = help
        self._window = int(window)
        self._ring = [0.0] * self._window
        self._n = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value):
        with self._lock:
            self._ring[self._n % self._window] = float(value)
            self._n += 1
            self._sum += float(value)

    @staticmethod
    def _pctiles(vals):
        # explicit empty guard: percentiles of nothing are None (rendered
        # as absent samples), never a silent 0.0 that reads as "fast"
        n = len(vals)
        if n == 0:
            return {"p50": None, "p95": None, "p99": None}
        pick = lambda q: vals[min(n - 1, int(q * (n - 1) + 0.5))]  # noqa: E731
        return {"p50": round(pick(0.50), 4), "p95": round(pick(0.95), 4),
                "p99": round(pick(0.99), 4)}

    def percentiles(self):
        with self._lock:
            vals = sorted(self._ring[:min(self._n, self._window)])
        return self._pctiles(vals)

    def snapshot(self):
        # count, sum, and the ring are read as ONE locked view — a
        # concurrent observe() can otherwise tear count from sum (count
        # incremented, sum not yet) and the snapshot lies about the mean
        with self._lock:
            count = self._n
            total = self._sum
            vals = sorted(self._ring[:min(self._n, self._window)])
        out = {"count": count, "sum": round(total, 4)}
        out.update(self._pctiles(vals))
        return out


class MetricsRegistry:
    """Named metrics + named collectors. ``counter``/``gauge``/``histogram``
    are get-or-create (idempotent across modules); ``register_collector``
    hooks a zero-arg callable whose dict return becomes a top-level section
    of :meth:`snapshot` — how the pre-existing signals (engine counters,
    serve rings, comp-cache) are absorbed without rewiring their owners."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        self._collectors = {}   # section name -> fn() -> dict

    # ------------------------------------------------------------ creation
    def counter(self, name, help=""):
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name, help)
            return m

    def gauge(self, name, help=""):
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name, help)
            return m

    def histogram(self, name, help="", window=2048):
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, help, window)
            return m

    def register_collector(self, section, fn):
        with self._lock:
            self._collectors[section] = fn

    # ------------------------------------------------------------ export
    def snapshot(self):
        """Stable JSON-able dict: one ``metrics`` section for registry-owned
        metrics plus one section per collector. Collector failures degrade
        to an ``error`` entry — a snapshot must never raise (it is the
        diagnose/HTTP surface)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            collectors = dict(self._collectors)
        out = {"schema": 1}
        metrics = {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(histograms.items())},
        }
        out["metrics"] = metrics
        for section in sorted(collectors):
            try:
                out[section] = collectors[section]()
            except Exception as e:  # snapshot never raises
                out[section] = {"error": "%s: %s" % (type(e).__name__, e)}
        return out


def _sanitize(name):
    out = []
    for ch in str(name):
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return "_" + s if s and s[0].isdigit() else (s or "_")


def _walk(prefix, value, labels, lines):
    """Flatten a snapshot subtree into Prometheus samples. Numeric leaves
    become gauges named by their path; the ``servers`` map becomes a
    ``server=\"name\"`` label instead of a path component (per-replica
    aggregation is the whole point of the label)."""
    if isinstance(value, bool):
        lines.append((prefix, labels, int(value)))
    elif isinstance(value, (int, float)):
        lines.append((prefix, labels, value))
    elif isinstance(value, dict):
        for k, v in sorted(value.items()):
            if k == "servers" and isinstance(v, dict):
                for sname, sval in sorted(v.items()):
                    _walk(prefix + "_server", sval,
                          labels + (("server", sname),), lines)
            elif k == "profiles" and isinstance(v, dict):
                # cost-attribution profiles: the "tier:key" map becomes a
                # program="..." label (same reasoning as servers — the
                # per-program aggregation is the point of the label)
                for pname, pval in sorted(v.items()):
                    _walk(prefix + "_program", pval,
                          labels + (("program", pname),), lines)
            elif k.endswith("_by_bucket") and isinstance(v, dict):
                # per-bucket splits (e.g. TTFT by pow2 prompt length):
                # the bucket key becomes a bucket="..." label so one
                # metric name carries the whole distribution family
                stem = k[:-len("_by_bucket")]
                for bname, bval in sorted(
                        v.items(), key=lambda it: str(it[0])):
                    _walk(prefix + "_" + _sanitize(stem) if prefix
                          else _sanitize(stem), bval,
                          labels + (("bucket", bname),), lines)
            else:
                _walk(prefix + "_" + _sanitize(k) if prefix
                      else _sanitize(k), v, labels, lines)
    # strings/None/lists are descriptive, not samples — skipped


def render_prometheus(snap, prefix="mxtpu"):
    """Prometheus text exposition (v0.0.4) of a snapshot dict. Counter-like
    sections (engine counters, registry counters) get ``# TYPE ... counter``;
    everything else is a gauge."""
    samples = []
    _walk("", snap, (), samples)
    counter_prefixes = ("engine_", "metrics_counters_")
    out = []
    seen_type = set()
    for name, labels, value in samples:
        if name in ("schema",):
            continue
        full = "%s_%s" % (prefix, name)
        if full not in seen_type:
            seen_type.add(full)
            # histogram _sum/_count are monotonic series (Prometheus
            # summary convention) — typing them gauge breaks rate()
            kind = "counter" if (
                name.startswith(counter_prefixes)
                or (name.startswith("metrics_histograms_")
                    and name.endswith(("_sum", "_count")))) else "gauge"
            out.append("# TYPE %s %s" % (full, kind))
        label_s = ""
        if labels:
            label_s = "{%s}" % ",".join(
                '%s="%s"' % (_sanitize(k), str(v).replace('"', "'"))
                for k, v in labels)
        if isinstance(value, float):
            out.append("%s%s %.6g" % (full, label_s, value))
        else:
            out.append("%s%s %d" % (full, label_s, value))
    return "\n".join(out) + "\n"
