"""mxnet_tpu_torch.observability — runtime telemetry (counterpart of
``mxnet_tpu/observability``).

One registry reads the signals the port already keeps — the engine
counters (dispatch, the bulk, tape and symbol builds, the capture
counters), the servers' ``stats()``, the program caches, the profiler's
record buffer — and exports them two ways from one ``snapshot()``:

* ``observability.snapshot()`` — stable JSON, the JAX package's key layout
  for the sections the port has;
* ``observability.prometheus()`` — Prometheus text exposition, served by
  the ``/metrics`` endpoint (``ModelServer``/``GenerativeServer``
  ``metrics_port=``, http.py).

Per-request tracing (tracing.py) threads a trace id from ``submit()``
through queue, coalesce, pad, dispatch and the decode steps; the retrace
watchdog (watchdog.py) reports every CUDA-graph capture or program build
after warmup. ``device_section()`` reads ``torch.cuda.memory_stats``.

The sections the port lacks are named in ``NOT_PORTED`` with their
``ROADMAP.md`` item, and ``snapshot()`` lists them under ``not_ported``.
"""
from __future__ import annotations

import sys

from . import watchdog  # noqa: F401
from .http import MetricsHTTPServer  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, render_prometheus)
from .tracing import (RequestTrace, new_trace, set_tracing,  # noqa: F401
                      tracing_enabled)

__all__ = ["registry", "snapshot", "prometheus", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "RequestTrace", "new_trace",
           "set_tracing", "tracing_enabled", "arm_watchdog",
           "disarm_watchdog", "MetricsHTTPServer", "enable_op_telemetry",
           "op_telemetry_enabled", "render_prometheus", "device_section",
           "NOT_PORTED"]

# the JAX package's sections the port does not have: section -> the
# ROADMAP.md item that brings it
NOT_PORTED = {
    "costs": "A.16 (observability/costs.py: a FLOP counter in place of "
             "XLA's cost_analysis)",
    "hlolint": "A.16 (analysis/: program lint)",
    "concurrency": "A.16 (analysis/: the lock-order checker)",
    "comp_cache": "A.16 (cache/aot.py and store.py: the compile cache)",
    "ir": "A.16 (ir/: the graph IR)",
}

# the process-wide registry
registry = MetricsRegistry()

arm_watchdog = watchdog.arm
disarm_watchdog = watchdog.disarm

def enable_op_telemetry(on=True):
    """Count imperative ``nd`` dispatches per op name
    (``snapshot()['ops']``). Returns the previous state."""
    from .. import ndarray as _nd

    prev = _nd._obs_on
    _nd._obs_on = bool(on)
    return prev


def op_telemetry_enabled():
    from .. import ndarray as _nd

    return _nd._obs_on


# ------------------------------------------------------------- collectors
def _collect_engine():
    from .. import engine

    return {
        "dispatch": engine.dispatch_counter.count,
        "bulk_compile": engine.bulk_compile_counter.count,
        "tape_compile": engine.tape_compile_counter.count,
        "tape_cache_hit": engine.tape_cache_hit_counter.count,
        "tape_eager": engine.tape_eager_counter.count,
        "symbol_compile": engine.symbol_compile_counter.count,
        "serve_capture": engine.serve_capture_counter.count,
        "decode_capture": engine.decode_capture_counter.count,
        "hybrid_capture": engine.hybrid_capture_counter.count,
    }


def _collect_caches():
    from .. import autograd, ndarray

    return {
        "bulk": {"entries": len(ndarray._PROGRAMS),
                 "cap": ndarray.PROGRAM_CAP},
        "tape": {"entries": len(autograd._TAPE_KEYS),
                 "cap": autograd._TAPE_KEY_CAP,
                 "compile_enabled": autograd.tape_compile_enabled()},
    }


def _collect_serve():
    from .. import serve

    return serve.stats()


def _collect_profiler():
    from .. import profiler

    return {
        "running": profiler.is_running(),
        "records": profiler.num_records(),
        "records_cap": profiler.record_cap(),
        "records_dropped": profiler.records_dropped(),
    }


def _collect_ops():
    from .. import ndarray as _nd

    return {"enabled": _nd._obs_on, "dispatches": dict(_nd._obs_counts)}


def _collect_dist():
    # the subsystem's detail only once something imported it: a collector
    # never loads the package it observes
    d = sys.modules.get("mxnet_tpu_torch.dist")
    if d is None:
        return {"subsystem": "not loaded"}
    return d.stats()


def _collect_quant():
    q = sys.modules.get("mxnet_tpu_torch.quantization")
    if q is None:
        return {"subsystem": "not loaded"}
    return q.stats()


def _collect_tune():
    t = sys.modules.get("mxnet_tpu_torch.ir.tune")
    if t is None or not hasattr(t, "stats"):
        return {"subsystem": "not loaded"}
    return t.stats()


registry.register_collector("engine", _collect_engine)
registry.register_collector("dist", _collect_dist)
registry.register_collector("quant", _collect_quant)
registry.register_collector("caches", _collect_caches)
registry.register_collector("serve", _collect_serve)
registry.register_collector("profiler", _collect_profiler)
registry.register_collector("ops", _collect_ops)
registry.register_collector("tune", _collect_tune)
registry.register_collector("watchdog", watchdog.snapshot)
registry.register_collector(
    "tracing", lambda: {"enabled": tracing_enabled()})
registry.register_collector("not_ported", lambda: dict(NOT_PORTED))


def device_section():
    """The card's memory gauges from ``torch.cuda.memory_stats`` (the JAX
    package's keys: bytes in use, peak, limit)."""
    from .. import profiler

    try:
        stats = profiler.device_memory_summary()
    except Exception as e:
        return {"error": "%s: %s" % (type(e).__name__, e)}
    return {"hbm_bytes_in_use": stats.get("bytes_in_use"),
            "hbm_peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "hbm_bytes_limit": stats.get("bytes_limit")}


def snapshot(device=False):
    """The JSON telemetry snapshot: registry metrics and every collector's
    section; ``device=True`` adds the card's memory gauges."""
    snap = registry.snapshot()
    if device:
        snap["device"] = device_section()
    return snap


def prometheus(device=False):
    """Prometheus text exposition of :func:`snapshot`, the ``/metrics``
    payload."""
    return render_prometheus(snapshot(device=device))
