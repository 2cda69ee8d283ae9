"""Per-request tracing — a trace-id/span-id context threaded through the
serving stack (counterpart of ``mxnet_tpu/observability/tracing.py``).

A ``RequestTrace`` is created at ``submit()`` (ModelServer and
GenerativeServer) and rides on the request/stream handle through admission
queue → batcher coalesce → bucket pad → executor dispatch (a bucket's
CUDA-graph replay and its copies) → (decode) per-token steps. Each phase closes a named span; the response handle's
``.trace.timing()`` returns the per-request breakdown
(``queue_ms/pad_ms/dispatch_ms/tokens``), and when the profiler is
running every span is also emitted into the Chrome-trace record stream
(category ``request``, name ``req[<id8>] <span>``, ``args.trace_id``
carrying the full id) — so one Perfetto timeline shows request lifecycle,
host scopes (``bulk[...]``/``serve[...]``/``decode[...]``), and the
card's kernels together.

Cost discipline: a trace is a uuid + a handful of (name, t0, t1) tuples
per REQUEST (never per token — decode steps accumulate into one float).
``set_tracing(False)`` (or ``MXNET_REQUEST_TRACING=0``) makes
``new_trace`` return None and every call site is ``if trace is not
None``-guarded, so the off-state costs one attribute test. ``timing()``
adds ``coalesce_ms``, the port's span for a batch's inputs joined.
"""
from __future__ import annotations

import os
import time
import uuid

_enabled = os.environ.get("MXNET_REQUEST_TRACING", "1").lower() \
    not in ("0", "false", "off", "no")


def set_tracing(on):
    """Toggle request-trace creation; returns the previous state. On by
    default."""
    global _enabled
    prev, _enabled = _enabled, bool(on)
    return prev


def tracing_enabled():
    return _enabled


def new_trace(name="request"):
    """A fresh RequestTrace with a process-unique trace id, or None when
    tracing is disabled (call sites guard on None)."""
    if not _enabled:
        return None
    return RequestTrace(name)


class RequestTrace:
    __slots__ = ("trace_id", "name", "t_start", "spans", "tokens",
                 "_acc_dispatch_ms", "_decode_t0")

    def __init__(self, name="request"):
        self.trace_id = uuid.uuid4().hex[:16]
        self.name = name
        self.t_start = time.perf_counter()
        self.spans = []            # (name, t0, t1, args) perf_counter secs
        self.tokens = 0            # generated tokens (decode requests)
        self._acc_dispatch_ms = 0.0  # per-token step time, accumulated
        self._decode_t0 = None

    # ------------------------------------------------------------ recording
    def add_span(self, span, t0, t1, **args):
        """Close one named child span [t0, t1] (perf_counter seconds) and
        mirror it into the profiler's Chrome-trace records when running."""
        self.spans.append((span, t0, t1, args or None))
        from .. import profiler

        if profiler.is_running():
            a = {"trace_id": self.trace_id}
            if args:
                a.update(args)
            profiler._record("req[%s] %s" % (self.trace_id[:8], span),
                             (t0 - profiler._epoch) * 1e6,
                             (t1 - t0) * 1e3, cat="request", args=a)

    def note_decode_step(self, step_s, t_now=None):
        """Attribute one shared decode-step dispatch to this request:
        O(1) per token — a float add and a token count, never a span."""
        if self._decode_t0 is None:
            self._decode_t0 = (t_now or time.perf_counter()) - step_s
        self.tokens += 1
        self._acc_dispatch_ms += step_s * 1e3

    def close_decode(self, t_now=None):
        """Emit the aggregate ``decode`` span (first step → now) once, at
        request retire — per-token spans would grow with the stream."""
        if self._decode_t0 is not None:
            self.add_span("decode", self._decode_t0,
                          t_now or time.perf_counter(), tokens=self.tokens)
            self._decode_t0 = None

    # ------------------------------------------------------------- reading
    def span_ms(self, span):
        return sum((t1 - t0) for n, t0, t1, _ in self.spans if n == span) \
            * 1e3

    def timing(self):
        """The per-request breakdown the response object carries:
        queue/pad/dispatch wall-clock (ms) + generated token count (0 for
        non-generative requests). ``dispatch_ms`` includes decode-step
        time attributed via :meth:`note_decode_step`."""
        return {
            "trace_id": self.trace_id,
            "queue_ms": round(self.span_ms("queue"), 3),
            "coalesce_ms": round(self.span_ms("coalesce"), 3),
            "pad_ms": round(self.span_ms("pad"), 3),
            "dispatch_ms": round(self.span_ms("dispatch")
                                 + self._acc_dispatch_ms, 3),
            "tokens": self.tokens,
            "total_ms": round((time.perf_counter() - self.t_start) * 1e3, 3),
        }
