"""Serving metrics (``mxnet_tpu/serve/metrics.py`` ``ServeMetrics`` without
its profiler counter tracks, and ``GenerativeMetrics`` for token-level
serving).

Latency percentiles come from a bounded ring of the most recent ``window``
request latencies, so a long-running server does not grow. The measured
request-size histogram (``request_rows``) and the per-bucket
``{batches, rows, pad_rows}`` histograms are bounded too: request sizes are
capped by the largest bucket and batches land on configured buckets only.
``ModelServer.retune_buckets`` fits a bucket set to the first, ``health``
reads the two load gauges.
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
        self.pad_rows = 0                 # bucket_rows - batched_rows
        self.row_bytes = None             # bytes per input row (server-set)
        self._request_rows = {}           # rows -> admitted requests
        self._bucket_hist = {}            # bucket -> {batches, rows, pad_rows}
        self._queue_depth = 0
        # admitted but not yet delivered (tokens, or rows for batch
        # serving): with queue_depth, the load a router reads
        self._tokens_in_flight = 0

    def record_admit(self, n=1, rows=None):
        with self._lock:
            self.requests += n
            if rows is not None:
                r = int(rows)
                self._request_rows[r] = self._request_rows.get(r, 0) + 1

    def record_tokens_in_flight(self, n):
        with self._lock:
            self._tokens_in_flight = int(n)

    def load_gauges(self):
        """``{"queue_depth", "tokens_in_flight"}``, the gauges ``health``
        reports."""
        with self._lock:
            return {"queue_depth": self._queue_depth,
                    "tokens_in_flight": self._tokens_in_flight}

    def request_rows(self):
        """The measured request-size histogram ``{rows: count}``."""
        with self._lock:
            return dict(self._request_rows)

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
            pad = max(0, int(bucket) - int(n_real))
            self.pad_rows += pad
            h = self._bucket_hist.setdefault(
                int(bucket), {"batches": 0, "rows": 0, "pad_rows": 0})
            h["batches"] += 1
            h["rows"] += int(n_real)
            h["pad_rows"] += pad

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
                "tokens_in_flight": self._tokens_in_flight,
                "batch_fill_ratio": (self.batched_rows / self.bucket_rows
                                     if self.bucket_rows else None),
                "mean_batch_size": (self.batched_rows / self.batches
                                    if self.batches else None),
                "latency_window": min(self._lat_n, self._window),
                "pad_rows_total": self.pad_rows,
                "pad_waste_bytes": (self.pad_rows * self.row_bytes
                                    if self.row_bytes else None),
                "request_rows": {str(r): c for r, c in
                                 sorted(self._request_rows.items())},
                "bucket_hist": {str(b): dict(h) for b, h in
                                sorted(self._bucket_hist.items())},
            }
            snap.update(self._percentiles())
        return snap


def _ring_percentiles(ring, n, prefix):
    """Nearest-rank p50/p95/p99 over the retained window of a ring (the
    estimator of ServeMetrics), rounded to the microsecond."""
    out = {"%s_p50_ms" % prefix: None, "%s_p95_ms" % prefix: None,
           "%s_p99_ms" % prefix: None}
    if n == 0:
        return out
    vals = sorted(ring[:n])
    for q in (50, 95, 99):
        out["%s_p%d_ms" % (prefix, q)] = round(
            vals[min(n - 1, int(q / 100 * (n - 1) + 0.5))], 3)
    return out


class GenerativeMetrics(ServeMetrics):
    """ServeMetrics plus the token-level counters generative serving is
    judged by (counterpart of the JAX package's ``GenerativeMetrics``):
    tokens/s over decode-active wall time, time to first token (admission
    to the first sampled token, by pow2 prompt bucket too), inter-token
    latency (one decode step of the shared batch; the steps taken while a
    chunked prefill is in flight also in their own ``itl_prefill`` ring),
    prefill and prefill-chunk counts, in-flight fill (live slots over
    padded slots a step) and the speculative rounds' drafted and accepted
    tokens."""

    def __init__(self, name="serve", window=2048):
        super().__init__(name, window)
        self._ttft = [0.0] * self._window   # admission -> first token, ms
        self._ttft_n = 0
        self._itl = [0.0] * self._window    # per decode step, ms
        self._itl_n = 0
        self._itl_pf = [0.0] * self._window  # steps under chunked prefill
        self._itl_pf_n = 0
        self.tokens = 0                     # generated tokens, all requests
        self.steps = 0                      # decode steps
        self.prefills = 0                   # whole-prompt forwards
        self.prefill_chunks = 0             # chunked-prefill steps
        # speculative decode: drafted = proposals offered to a verify step
        # (live slots x (spec_k - 1) a round), accepted = those the target
        # kept; their ratio is the accept rate
        self.spec_rounds = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self._decode_s = 0.0                # decode-active wall time
        self._active_slot_steps = 0         # live slots summed over steps
        self._slot_steps = 0                # padded slots summed over steps
        self._ttft_by_bucket = {}           # pow2 bucket -> [ring, n]

    def record_first_token(self, ms, prompt_len=None):
        with self._lock:
            self._ttft[self._ttft_n % self._window] = float(ms)
            self._ttft_n += 1
            self.tokens += 1   # the first token is sampled by prefill
            if prompt_len is not None:
                b = 1
                while b < int(prompt_len):
                    b <<= 1
                ent = self._ttft_by_bucket.setdefault(
                    b, [[0.0] * self._window, 0])
                ent[0][ent[1] % self._window] = float(ms)
                ent[1] += 1

    def record_prefill(self, n=1):
        with self._lock:
            self.prefills += n

    def record_chunk(self, n=1):
        with self._lock:
            self.prefill_chunks += n

    def record_step(self, step_s, n_tokens, n_active, slots,
                    under_prefill=False):
        """One decode (or verify) step: ``n_tokens`` emitted across
        ``n_active`` live slots of ``slots``. ``under_prefill`` marks a step
        taken while a chunked prefill was in flight: its ITL also lands in
        the ``itl_prefill`` ring, the stall chunking bounds."""
        with self._lock:
            self._itl[self._itl_n % self._window] = float(step_s) * 1e3
            self._itl_n += 1
            if under_prefill:
                self._itl_pf[self._itl_pf_n % self._window] = \
                    float(step_s) * 1e3
                self._itl_pf_n += 1
            self.steps += 1
            self.tokens += int(n_tokens)
            self._decode_s += float(step_s)
            self._active_slot_steps += int(n_active)
            self._slot_steps += int(slots)

    def record_spec_round(self, drafted, accepted):
        with self._lock:
            self.spec_rounds += 1
            self.drafted_tokens += int(drafted)
            self.accepted_tokens += int(accepted)

    def snapshot(self):
        snap = super().snapshot()
        with self._lock:
            snap.update({
                "tokens": self.tokens,
                "decode_steps": self.steps,
                "prefills": self.prefills,
                "prefill_chunks": self.prefill_chunks,
                "tokens_per_s": (round(self.tokens / self._decode_s, 1)
                                 if self._decode_s > 0 else None),
                "inflight_fill": (round(self._active_slot_steps
                                        / self._slot_steps, 4)
                                  if self._slot_steps else None),
                "spec_rounds": self.spec_rounds,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "accept_rate": (round(self.accepted_tokens
                                      / self.drafted_tokens, 4)
                                if self.drafted_tokens else None),
            })
            snap["ttft_count"] = self._ttft_n
            snap.update(_ring_percentiles(
                self._ttft, min(self._ttft_n, self._window), "ttft"))
            snap.update(_ring_percentiles(
                self._itl, min(self._itl_n, self._window), "itl"))
            snap.update(_ring_percentiles(
                self._itl_pf, min(self._itl_pf_n, self._window),
                "itl_prefill"))
            snap["ttft_by_bucket"] = {
                str(b): {k[2:]: v for k, v in _ring_percentiles(
                    ring, min(n, self._window), "b").items()}
                for b, (ring, n) in sorted(self._ttft_by_bucket.items())}
        return snap
