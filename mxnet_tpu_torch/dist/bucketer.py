"""Gradient bucketing (counterpart of ``mxnet_tpu/dist/bucketer.py``):
size-capped buckets whose exchanges start as the backward produces the
gradients, so the exchange overlaps the rest of the backward.

The plan partitions the gradients, in reverse-tape order (the order the
backward produces them), into ``MXNET_DIST_BUCKET_MB``-capped buckets:
the same greedy partition as the JAX package's, so the same shapes and cap
give the same buckets. A bucket is one flatten-concat to fp32 and one
exchange through the strategy (``HierarchicalAllreduce`` /
``FlatAllreduce``), split back into the members.

:class:`BackwardExchanger` is torch's idiom of the overlap: a
``register_post_accumulate_grad_hook`` on each parameter marks its
gradient landed, and when a bucket's last member lands its exchange is
launched (``async_op``; on CUDA the bucket's flatten-concat runs on the
backward's stream and its collectives on a stream of their own, which
never holds up the backward). Buckets launch in plan order on every rank,
so the collectives pair up across ranks. ``finish()`` launches what the
hooks did not (a parameter the backward did not reach), waits, and writes
the results into the gradients. A second backward before ``finish()``
(gradient accumulation) re-arms the exchanger (see
:class:`BackwardExchanger`).

Counters: ``bucket_counter`` counts bucket launches, ``plan_counter``
plans made (one a layout: a steady loop makes none), and
``overlap_window_ms`` is the span from the first bucket's launch to
``finish()``. The profiler ranges ``mxnet_tpu_torch::dist_bucket_launch``
and ``::dist_finish`` hold the exchange's host time.
"""
from __future__ import annotations

import os
import threading
import time

import torch

__all__ = ["GradientBucketer", "BackwardExchanger", "default_bucket_mb",
           "bucket_counter", "plan_counter"]


class Counter:
    """A host counter of events (thread-safe)."""

    def __init__(self, name):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def bump(self, n=1):
        with self._lock:
            self.count += n


bucket_counter = Counter("dist_bucket_launches")
plan_counter = Counter("dist_bucket_plans")


def default_bucket_mb():
    try:
        return float(os.environ.get("MXNET_DIST_BUCKET_MB", "4"))
    except ValueError:
        return 4.0


def _itemsize(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    import numpy as np

    return np.dtype(dtype).itemsize


def _nbytes(shape, dtype):
    n = 1
    for s in shape:
        n *= int(s)
    return n * _itemsize(dtype)


class GradientBucketer:
    """Partition and exchange this rank's gradients through a strategy.

    strategy:   ``HierarchicalAllreduce`` / ``FlatAllreduce``
    bucket_mb:  a bucket's payload cap (default ``MXNET_DIST_BUCKET_MB``=4)

    Each rank's gradients are its own (the JAX package's stacked mode): the
    exchange sums them over the ranks (or averages, as the strategy says).
    """

    def __init__(self, strategy, bucket_mb=None):
        self.strategy = strategy
        self.bucket_bytes = int((default_bucket_mb() if bucket_mb is None
                                 else float(bucket_mb)) * (1 << 20))
        self._plans = {}
        self._residuals = {}
        self._sigs = set()
        self._exchanges = 0

    def plan(self, avals):
        """Greedy size-capped partition of ``avals`` ((shape, dtype) in
        launch order) into tuples of indices; made once a layout."""
        key = (tuple((tuple(s), str(d)) for s, d in avals), self.bucket_bytes)
        p = self._plans.get(key)
        if p is not None:
            return p
        plan_counter.bump()
        buckets, cur, cur_bytes = [], [], 0
        for i, (shape, dtype) in enumerate(avals):
            b = _nbytes(shape, dtype)
            if cur and cur_bytes + b > self.bucket_bytes:
                buckets.append(tuple(cur))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += b
        if cur:
            buckets.append(tuple(cur))
        p = self._plans[key] = tuple(buckets)
        return p

    def _sig(self, grads):
        return (self.strategy.key, tuple((tuple(g.shape), g.dtype)
                                         for g in grads))

    def flatten(self, grads):
        """One bucket's gradients as one fp32 vector, padded for the
        strategy."""
        n = sum(g.numel() for g in grads)
        n_pad = self.strategy.pad_to(n)
        if all(g.dtype == grads[0].dtype for g in grads):
            flat = torch.cat([g.reshape(-1) for g in grads]).to(
                torch.float32)
        else:
            flat = torch.cat([g.reshape(-1).to(torch.float32)
                              for g in grads])
        if n_pad != n:
            flat = torch.nn.functional.pad(flat, (0, n_pad - n))
        return flat

    def launch(self, grads, flat=None):
        """Start one bucket's exchange (of ``flat``, default
        ``flatten(grads)``): returns ``finish()``, which waits and gives
        the reduced fp32 flat vector (its padding cut)."""
        n = sum(g.numel() for g in grads)
        if flat is None:
            flat = self.flatten(grads)
        n_pad = flat.numel()
        sig = self._sig(grads)
        self._sigs.add(sig)
        res = self._residuals.get(sig)
        if res is None and self.strategy._codec is not None:
            res = self.strategy.residual_init(n_pad, flat.device)
        bucket_counter.bump()
        finish, new_res = self.strategy.launch(flat, res)
        if new_res is not None:
            self._residuals[sig] = new_res
        return lambda: finish()[:n]

    @staticmethod
    def split(vec, like):
        """The reduced flat vector cut into views of ``like``'s shapes
        (fp32; the caller casts as it copies)."""
        return [v.view(g.shape) for v, g in zip(
            torch.split(vec, [g.numel() for g in like]), like)]

    def exchange(self, grads):
        """Reduce ``grads`` (launch order), one exchange a bucket, every
        bucket launched before the first is waited on; returns the reduced
        tensors in the same order."""
        plan = self.plan([(tuple(g.shape), g.dtype) for g in grads])
        pending = [(b, self.launch([grads[i] for i in b])) for b in plan]
        out = [None] * len(grads)
        for b, finish in pending:
            for i, r in zip(b, self.split(finish(), [grads[i] for i in b])):
                out[i] = r.to(grads[i].dtype)
        self._exchanges += 1
        return out

    def stats(self):
        return {"bucket_mb": self.bucket_bytes / float(1 << 20),
                "layouts": len(self._plans),
                "programs": len(self._sigs),
                "exchanges": self._exchanges}


class BackwardExchanger:
    """Exchanges the registered parameters' gradients bucket by bucket as
    the backward produces them (see the module docstring), then lets
    ``Trainer.allreduce_grads`` finish the step.

    With ``record_events`` each bucket's finished exchange and each landed
    gradient record a CUDA event (``events``), so a reader can show on the
    device that a bucket's whole exchange ran before the backward's last
    gradient.

    Gradient accumulation (several backwards before ``finish()``, e.g. at
    ``grad_req="add"``): a gradient that lands a second time re-arms the
    exchanger. The buckets launched so far held only part of the sum:
    their results are dropped (``finish()`` still waits for them), the
    error-feedback residuals they moved are put back, and the buckets
    launch again as the accumulated gradients land. Every rank runs the
    same backwards, so the dropped exchanges pair up across ranks too. On
    CUDA a bucket is flattened on the backward's stream, so a later
    backward's in-place accumulation cannot overtake the copy the exchange
    reads."""

    def __init__(self, bucketer, record_events=False):
        self.bucketer = bucketer
        self.record_events = record_events
        self.overlap_window_ms = None
        self.windows_ms = []
        self.events = None
        self._params = []
        self._plan = ()
        self._bucket_of = {}
        self._hooks = []
        self._stream = None
        self._reset()

    def _reset(self):
        self._rearm()
        self._stale = []
        self._residuals0 = None
        self._window_t0 = None

    def _rearm(self):
        self._left = [len(b) for b in self._plan]
        self._landed = [False] * len(self._params)
        self._next = 0
        self._pending = {}
        if self.record_events:
            self.events = {"bucket_done": [], "grad_landed": []}

    def register_params(self, params):
        """Plan the buckets over ``params`` (those with a gradient, in
        reverse order: the order the backward produces them) and hook each
        parameter's tensor; a second call with the same tensors keeps
        everything."""
        params = [p for p in params
                  if p.grad_req != "null" and p._data is not None]
        tensors = [p._data for p in reversed(params)]
        if [id(t) for t in tensors] == [id(p._data) for p in self._params]:
            return
        self.remove_hooks()
        self._params = list(reversed(params))
        self._plan = self.bucketer.plan(
            [(tuple(t.shape), t.dtype) for t in tensors])
        self._bucket_of = {}
        for b, members in enumerate(self._plan):
            for i in members:
                self._bucket_of[i] = b
        for i, t in enumerate(tensors):
            self._hooks.append(t.register_post_accumulate_grad_hook(
                self._hook(i)))
        self._reset()

    def remove_hooks(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def _hook(self, i):
        def landed(t):
            if self._landed[i]:  # a further backward: accumulation
                self._stale += self._pending.values()
                if self._residuals0 is not None:
                    self.bucketer._residuals = dict(self._residuals0)
                self._rearm()
            self._landed[i] = True
            if self.record_events and t.is_cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events["grad_landed"].append(ev)
            b = self._bucket_of[i]
            self._left[b] -= 1
            while self._next < len(self._plan) and \
                    self._left[self._next] <= 0:
                self._launch(self._next)
                self._next += 1

        return landed

    def _comm_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _launch(self, b):
        # a profiler range, so a trace can sum the exchange's host time
        with torch.profiler.record_function(
                "mxnet_tpu_torch::dist_bucket_launch"):
            self._launch_bucket(b)

    def _launch_bucket(self, b):
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        if self._residuals0 is None:
            self._residuals0 = dict(self.bucketer._residuals)
        grads = []
        for i in self._plan[b]:
            t = self._params[i]._data
            if t.grad is None:  # not reached by this backward
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        if grads[0].is_cuda:
            flat = self.bucketer.flatten(grads)
            s = self._comm_stream(grads[0].device)
            s.wait_stream(torch.cuda.current_stream(grads[0].device))
            flat.record_stream(s)
            with torch.cuda.stream(s):
                fin = self.bucketer.launch(grads, flat)
                # NCCL's wait only orders this stream after the
                # collectives, so the whole exchange is queued here
                out = fin()
                finish = lambda: out  # noqa: E731
                if self.record_events:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(s)
                    self.events["bucket_done"].append(ev)
        else:
            finish = self.bucketer.launch(grads)
        self._pending[b] = (finish, grads)

    def finish(self):
        """Launch the buckets the hooks did not, wait for every exchange,
        and write the results into the gradients (on CUDA on the exchange
        stream, which the current stream then waits for). Returns the
        parameters and their reduced gradients, in plan order."""
        with torch.profiler.record_function("mxnet_tpu_torch::dist_finish"):
            return self._finish()

    def _finish(self):
        while self._next < len(self._plan):
            self._launch(self._next)
            self._next += 1
        s = self._stream
        cur = None
        if s is not None and self._pending:
            cur = torch.cuda.current_stream(s.device)
            s.wait_stream(cur)
        out = []
        ctx = torch.cuda.stream(s) if cur is not None else _nullcontext()
        with ctx, torch.no_grad():
            for fin, _ in self._stale:   # dropped by a re-arm
                fin()
            for b in range(len(self._plan)):
                fin, grads = self._pending[b]
                # one multi-tensor copy a bucket, cast to each gradient's
                # dtype as it writes
                torch._foreach_copy_(grads, GradientBucketer.split(fin(),
                                                                   grads))
                out += [(self._params[i], g)
                        for i, g in zip(self._plan[b], grads)]
        if cur is not None:
            cur.wait_stream(s)
        if self._window_t0 is not None:
            self.overlap_window_ms = \
                (time.perf_counter() - self._window_t0) * 1e3
            self.windows_ms.append(self.overlap_window_ms)
        self.bucketer._exchanges += 1
        events = self.events
        self._reset()
        if events is not None:
            self.last_events = events
        return out


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False
