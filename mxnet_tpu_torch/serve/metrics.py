"""Serving metrics (the latency/queue/shed/fill subset of
``mxnet_tpu/serve/metrics.py`` ``ServeMetrics``).

Latency percentiles come from a bounded ring of the most recent ``window``
request latencies, so a long-running server does not grow.
"""
from __future__ import annotations

import threading


class ServeMetrics:
    def __init__(self, name="serve", window=2048):
        self.name = name
        self._lock = threading.Lock()
        self._window = int(window)
        self._lat = [0.0] * self._window  # ring buffer, ms
        self._lat_n = 0                   # latencies ever recorded
        self.requests = 0                 # admitted requests
        self.completed = 0
        self.shed = 0                     # rejected at admission (ServerBusy)
        self.timeouts = 0                 # expired before a result arrived
        self.errors = 0                   # model failures propagated
        self.batches = 0                  # dispatched batches
        self.batched_rows = 0             # real rows across batches
        self.bucket_rows = 0              # padded bucket rows across batches
        self._queue_depth = 0

    def record_admit(self, n=1):
        with self._lock:
            self.requests += n

    def record_queue_depth(self, depth):
        with self._lock:
            self._queue_depth = depth

    def record_shed(self, n=1):
        with self._lock:
            self.shed += n

    def record_timeout(self, n=1):
        with self._lock:
            self.timeouts += n

    def record_error(self, n=1):
        with self._lock:
            self.errors += n

    def record_batch(self, n_real, bucket):
        with self._lock:
            self.batches += 1
            self.batched_rows += int(n_real)
            self.bucket_rows += int(bucket)

    def record_latency(self, ms):
        with self._lock:
            self._lat[self._lat_n % self._window] = float(ms)
            self._lat_n += 1
            self.completed += 1

    def _percentiles(self):
        n = min(self._lat_n, self._window)
        if n == 0:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
        vals = sorted(self._lat[:n])

        def pick(q):  # nearest rank on the retained window
            return vals[min(n - 1, int(q * (n - 1) + 0.5))]

        return {"p50_ms": pick(0.50), "p95_ms": pick(0.95),
                "p99_ms": pick(0.99)}

    def snapshot(self):
        with self._lock:
            snap = {
                "name": self.name,
                "requests": self.requests,
                "completed": self.completed,
                "shed": self.shed,
                "timeouts": self.timeouts,
                "errors": self.errors,
                "batches": self.batches,
                "queue_depth": self._queue_depth,
                "batch_fill_ratio": (self.batched_rows / self.bucket_rows
                                     if self.bucket_rows else None),
                "mean_batch_size": (self.batched_rows / self.batches
                                    if self.batches else None),
                "latency_window": min(self._lat_n, self._window),
            }
            snap.update(self._percentiles())
        return snap
