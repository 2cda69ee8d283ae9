"""Retrace watchdog (counterpart of ``mxnet_tpu/observability/
watchdog.py``): anomaly detection on the port's build counters.

The JAX package watches its ``*_compile_counter``s; the port's programs
are CUDA graphs and compiled backwards, so it watches their counters
(``engine``): ``serve_capture`` (a served bucket's graph), ``decode_capture``
(a decode, verify or chunk step program), ``bulk_compile`` (a bulk window
program), ``tape_compile`` (a compiled backward built), ``symbol_compile``
(an ``Executor`` program captured), ``hybrid_capture`` (a hybridized
block's key captured) and ``aot_compile`` (a ``cache.AotFn`` compile).
After warmup (``arm()``), every bump logs ONE structured warning naming the key the build site passed
(``bump(note=...)``, e.g. ``serve[serve:bertmodel bucket=8]``), through the
stdlib ``logging`` module (logger ``mxnet_tpu_torch.observability.
watchdog``), and goes into a bounded ``events`` ring that the registry
snapshot reads.

Arming is explicit (``observability.arm_watchdog()`` or
``MXNET_RETRACE_WATCHDOG=1``): warmup builds are expected, and deliberate
later builds (a retune's new buckets, a capacity growth) are events the
operator opts into watching.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

logger = logging.getLogger("mxnet_tpu_torch.observability.watchdog")

_EVENT_CAP = 256
events = []                 # bounded ring of structured event dicts
_armed = False
_lock = threading.Lock()


def _on_compile(counter, n, note):
    """The counters' watch hook: one structured warning an event after
    warmup, naming the key."""
    key = note
    evt = {
        "event": "retrace_after_warmup",
        "counter": counter.name or "compile",
        "key": str(key) if key is not None else "<unattributed build>",
        "count": counter.count,
        "ts": time.time(),
    }
    with _lock:
        if len(events) >= _EVENT_CAP:
            del events[0]
        events.append(evt)
    logger.warning("retrace after warmup: %s",
                   json.dumps(evt, sort_keys=True))


def _compile_counters():
    from .. import engine

    return (engine.serve_capture_counter, engine.decode_capture_counter,
            engine.bulk_compile_counter, engine.tape_compile_counter,
            engine.symbol_compile_counter, engine.hybrid_capture_counter,
            engine.aot_compile_counter)


def arm():
    """Start watching: from now until :func:`disarm`, every build counter's
    bump is an anomaly event. Idempotent."""
    global _armed
    for c in _compile_counters():
        c._watch = _on_compile
    _armed = True


def disarm():
    global _armed
    for c in _compile_counters():
        c._watch = None
    _armed = False


def armed():
    return _armed


def reset_events():
    with _lock:
        del events[:]


def snapshot():
    with _lock:
        last = events[-1] if events else None
    return {"armed": _armed, "events": len(events), "last_event": last}


if os.environ.get("MXNET_RETRACE_WATCHDOG", "0").lower() in (
        "1", "true", "yes", "on"):
    arm()
