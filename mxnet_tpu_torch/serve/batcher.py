"""Dynamic request batcher (counterpart of ``mxnet_tpu/serve/batcher.py``
``DynamicBatcher``, without request tracing).

Single requests land in a bounded thread-safe queue; a worker coalesces
them into the largest batch that fits under a ``max_wait_ms`` deadline: the
first request in a window starts the clock, late arrivals ride along until
the batch fills or the deadline passes. Admission control sheds load at
enqueue time (``ServerBusy``), by priority class: a full queue makes room
for a request by shedding a queued one of a lower class. Each request
carries its own timeout and fails with ``ServeTimeout`` if it expires in
the queue. Dispatch is the callable the server wires in, run on a small
dispatcher pool.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor


class ServeError(RuntimeError):
    """Base class for typed serving failures."""


class ServerBusy(ServeError):
    """Admission control: the request queue is full (load shedding)."""


class ServeTimeout(ServeError):
    """The per-request deadline passed before a result arrived."""


class _Request:
    __slots__ = ("inputs", "n", "t_submit", "t_dequeue", "deadline",
                 "priority", "trace", "_event", "_result", "_error", "_done",
                 "_lock")

    def __init__(self, inputs, n, timeout_ms, priority=0):
        self.inputs = inputs
        self.n = n  # rows this request contributes to a batch
        self.t_submit = time.perf_counter()
        self.t_dequeue = None  # stamped when a batch claims the request
        # observability.RequestTrace: the queue, coalesce, pad and
        # dispatch spans as the request moves through
        self.trace = None
        self.deadline = (self.t_submit + timeout_ms / 1e3
                         if timeout_ms else None)
        self.priority = int(priority)  # higher = more urgent
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._done = False
        self._lock = threading.Lock()

    @property
    def trace_id(self):
        return self.trace.trace_id if self.trace is not None else None

    def timing(self):
        """The request's breakdown (``queue_ms``, ``pad_ms``,
        ``dispatch_ms``, ``tokens``); None with tracing off."""
        return self.trace.timing() if self.trace is not None else None

    def finish(self, result=None, error=None):
        """First writer wins (a result racing the timeout sweep); returns
        whether this call finished the request."""
        with self._lock:
            if self._done:
                return False
            self._done = True
        self._result = result
        self._error = error
        self._event.set()
        return True

    def expired(self, now=None):
        return self.deadline is not None \
            and (now or time.perf_counter()) > self.deadline

    def result(self, timeout_s=None):
        if not self._event.wait(timeout_s):
            raise ServeTimeout("no result within %.1fs" % (timeout_s or 0))
        if self._error is not None:
            raise self._error
        return self._result

    def done(self):
        return self._done


class DynamicBatcher:
    """Coalesces requests and hands batches to ``dispatch_fn(requests,
    total_rows)`` on a dispatcher thread; it must finish() every request."""

    def __init__(self, dispatch_fn, max_batch, max_wait_ms=2.0,
                 max_queue=256, num_dispatchers=1, metrics=None):
        self._dispatch_fn = dispatch_fn
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._max_queue = int(max_queue)
        self._metrics = metrics
        self._queue = deque()
        self._queued_rows = 0
        self._cond = threading.Condition()
        self._stop = False
        self._worker = None
        # in-flight bound: requests wait in the bounded queue (and shed)
        # while every dispatcher is busy, instead of piling up in the pool
        self._num_dispatchers = max(1, int(num_dispatchers))
        self._inflight = None
        self._pool = None

    def start(self):
        if self._worker is None or not self._worker.is_alive():
            self._stop = False
            self._inflight = threading.Semaphore(self._num_dispatchers)
            self._pool = ThreadPoolExecutor(
                self._num_dispatchers, thread_name_prefix="serve-dispatch")
            self._worker = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-batcher")
            self._worker.start()
        return self

    def stop(self, drain=True, timeout_s=5.0, reason="server stopped"):
        """Stop the worker and the dispatcher pool. drain=True dispatches
        what is queued first; whatever is left after the bounded join is
        rejected with ServeError(reason), so no caller is left waiting."""
        with self._cond:
            self._stop = True
            pending = [] if drain else list(self._queue)
            if not drain:
                self._queue.clear()
                self._queued_rows = 0
            self._cond.notify_all()
        err = ServeError(reason)
        for r in pending:
            r.finish(error=err)
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout=timeout_s)
        with self._cond:
            leftover = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
        for r in leftover:
            r.finish(error=err)
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def submit(self, inputs, n_rows, timeout_ms=None, priority=0,
               trace=None):
        """Enqueue one request of ``n_rows`` rows.

        ``priority`` (higher = more urgent) orders the queue: dispatch
        drains the highest class first, FIFO within a class. When the queue
        is full and a request of a strictly lower class is waiting, the
        lowest-class queued request with the least deadline slack (the one
        most likely to miss its deadline anyway) is shed with ServerBusy
        and the new request takes its place; otherwise the new request is
        shed (ServerBusy raised here)."""
        req = _Request(inputs, int(n_rows), timeout_ms, priority)
        req.trace = trace
        evicted = []
        with self._cond:
            if self._stop:
                raise ServeError("server stopped")
            while self._queued_rows + req.n > self._max_queue:
                victim = min(
                    self._queue,
                    key=lambda r: (r.priority,
                                   r.deadline if r.deadline is not None
                                   else float("inf")),
                    default=None)
                if victim is None or victim.priority >= req.priority:
                    if self._metrics:
                        self._metrics.record_shed()
                    raise ServerBusy("queue full (%d rows queued, max %d)"
                                     % (self._queued_rows, self._max_queue))
                self._queue.remove(victim)
                self._queued_rows -= victim.n
                evicted.append(victim)
            # before the first request of a strictly lower class
            idx = next((i for i, r in enumerate(self._queue)
                        if r.priority < req.priority), len(self._queue))
            self._queue.insert(idx, req)
            self._queued_rows += req.n
            if self._metrics:
                self._metrics.record_admit(rows=req.n)
                self._metrics.record_queue_depth(self._queued_rows)
            self._cond.notify()
        for v in evicted:
            if v.finish(error=ServerBusy(
                    "shed from the queue by a priority-%d arrival"
                    % req.priority)) and self._metrics:
                self._metrics.record_shed()
        return req

    def queue_depth(self):
        with self._cond:
            return self._queued_rows

    def _take_batch(self):
        """Block until a deadline-ripe batch is ready; None on stop."""
        with self._cond:
            while True:
                if self._stop and not self._queue:
                    return None
                now = time.perf_counter()
                for req in [r for r in self._queue if r.expired(now)]:
                    self._queue.remove(req)
                    self._queued_rows -= req.n
                    if req.finish(error=ServeTimeout(
                            "timed out after %.1fms in queue"
                            % ((now - req.t_submit) * 1e3))) and self._metrics:
                        self._metrics.record_timeout()
                if not self._queue:
                    self._cond.wait(0.05)
                    continue
                head = self._queue[0]
                batch_deadline = head.t_submit + self._max_wait_s
                if self._queued_rows >= self._max_batch \
                        or now >= batch_deadline or self._stop:
                    batch, rows = [], 0
                    while self._queue and rows + self._queue[0].n \
                            <= self._max_batch:
                        req = self._queue.popleft()
                        self._queued_rows -= req.n
                        batch.append(req)
                        rows += req.n
                    if self._metrics:
                        self._metrics.record_queue_depth(self._queued_rows)
                    if batch:
                        t_deq = time.perf_counter()  # the queue spans end
                        for req in batch:
                            req.t_dequeue = t_deq
                        return batch, rows
                    # the head alone exceeds max_batch: fail it
                    req = self._queue.popleft()
                    self._queued_rows -= req.n
                    req.finish(error=ServeError(
                        "request of %d rows exceeds max batch %d"
                        % (req.n, self._max_batch)))
                    continue
                self._cond.wait(min(0.05, batch_deadline - now))

    def _run_dispatch(self, batch, rows):
        try:
            self._dispatch_fn(batch, rows)
        finally:
            self._inflight.release()

    def _loop(self):
        while True:
            # claim a dispatcher slot before popping a batch, so requests
            # keep aging (and shedding) in the bounded queue when saturated
            while not self._inflight.acquire(timeout=0.05):
                with self._cond:
                    if self._stop and not self._queue:
                        return
            got = self._take_batch()
            pool = self._pool
            if got is None or pool is None:
                # stopped (a stop whose join timed out has torn the pool
                # down: reject rather than dispatch into nothing)
                for req in (got[0] if got else ()):
                    req.finish(error=ServeError("server stopped"))
                self._inflight.release()
                return
            pool.submit(self._run_dispatch, *got)
