"""ModelServer — dynamic-batching inference serving (counterpart of
``mxnet_tpu/serve/server.py``).

    net = bert_base(); net.initialize(); amp.convert_hybrid_block(net)
    srv = ModelServer(net, [((512,), "int32"), ((512,), "int32"),
                            ((), "int32")], buckets=(1, 4, 8))
    with srv:
        seq, pooled, nsp = srv.predict(tokens, types, valid_len)
        handle = srv.submit(tokens, types, valid_len)   # .result(timeout_s)
        srv.stats(); srv.health()
    srv.swap_parameters("new.params")   # copies into the live weights
    srv.retune_buckets()                # fit to the measured request sizes

Single requests coalesce into the smallest fitting batch-size bucket under
a deadline (batcher), run as one padded forward on the device
(executor_pool: on a CUDA device each bucket is one CUDA graph, captured
at warmup and replayed at every dispatch), and are scattered back per
request. The server runs on the current CUDA device unless ``device``
says otherwise; without CUDA and without ``device="cpu"`` it raises.
``quantize="int8"`` (or an fp8 mode) serves the model with quantized
Dense and Conv2D layers, optionally calibrated.

``swap_parameters`` copies a checked file into the live parameter tensors
(quantized ``qweight``/``w_scale`` too) under the dispatch lock, so the
captured graphs serve the new weights and no batch sees a mix.
``retune_buckets`` rebuilds the pool and the batcher on a new bucket set
(by default fit to ``metrics.request_rows()``) and captures exactly it.
Fault drills assign ``srv.inject_fault = lambda batch_idx: ...``, which
may raise on chosen batches: their requests get the error, the server
keeps serving. ``devices=[...]`` serves one replica a listed device, each with its own
bucket graphs: the first runs on the model's parameters, the others on
copies on their devices (made again if a parameter is given a new
tensor); batches go round-robin over the replicas, one dispatcher thread
a replica, ``swap_parameters`` copies into every replica and ``stats()``
counts each (``replicas``). ``serve.snapshot(srv, prefix)`` writes the
model's export layout and the server's config, and ``serve.load(prefix,
snapshot=True)`` builds the server again from it (``cache/snapshot.py``).
``metrics_port=`` serves ``/metrics`` (the Prometheus text of
``observability.snapshot()``), ``/snapshot`` and ``/health`` from a
background thread while the server runs (0 takes a free port, read back
from ``srv.metrics_http.port``). Each request carries a
``RequestTrace`` (``handle.trace``, ``handle.timing()``) with its queue,
coalesce, pad and dispatch spans, unless ``observability.set_tracing(False)``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import resolve_device
from ..checkpoint import validate_swap
from ..ir.tune import fit_buckets
from ..observability import MetricsHTTPServer, new_trace
from ..quantization import quantize_model
from .batcher import DynamicBatcher, ServeError, ServeTimeout
from .executor_pool import BucketedExecutor
from .metrics import ServeMetrics

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class ModelServer:
    """Dynamic-batching server over a bucketed executor.

    Parameters
    ----------
    model : HybridBlock
        Initialized block; its parameters are moved to ``device``.
    input_specs : list of ((sample_shape), dtype)
        Per model input, the per-sample shape (no batch dim) and dtype;
        requests are cast to these.
    buckets : tuple of int
        Padded batch sizes; the largest is also the coalescing limit.
    max_wait_ms : float
        How long the first request of a window waits for company.
    max_queue : int
        Admission bound in rows; beyond it submit() sheds with ServerBusy.
    timeout_ms : float
        Default per-request deadline.
    device : str | torch.device | Context | None
        Where the model runs; None is the current CUDA device.
    devices : list or None
        Replica devices (the JAX server's ``devices``): one replica each,
        batches round-robin over them; the first is where the model's own
        parameters go (``device`` is ignored then).
    quantize : None or 'int8' / 'e4m3' / 'e5m2'
        Serve with quantized weights: ``quantization.quantize_model`` swaps
        every Dense and Conv2D for its quantized twin before the executor
        pool is built.
    calib_mode, calib_data
        Activation-scale calibration of the quantized layers (``"naive"``
        or ``"entropy"``) against ``calib_data`` (batches of the model's
        inputs, e.g. a warm-up batch shaped like real traffic); ignored
        unless ``quantize`` is set.
    metrics_port : int or None
        Serve the observability endpoint on this loopback port while the
        server runs (0: a free one).
    """

    def __init__(self, model, input_specs, buckets=DEFAULT_BUCKETS,
                 max_wait_ms=2.0, max_queue=256, timeout_ms=1000.0,
                 device=None, name=None, warmup=True, quantize=None,
                 calib_mode="none", calib_data=None, devices=None,
                 metrics_port=None):
        self.devices = [resolve_device(d) for d in devices] if devices \
            else [resolve_device(device)]
        self.device = self.devices[0]
        self.name = name or ("serve:%s" % type(model).__name__.lower())
        self.model = model
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._specs = [(tuple(shape), np.dtype(dt))
                       for shape, dt in input_specs]
        self.timeout_ms = float(timeout_ms)
        self._max_wait_ms = max_wait_ms
        self._max_queue = max_queue
        self.metrics = ServeMetrics(self.name)
        # bytes one request row holds over all inputs: pad rows -> bytes
        self.metrics.row_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            for shape, dt in self._specs)
        model.collect_params().reset_device(self.device)
        self.quantize = quantize or None
        if self.quantize is not None:
            quantize_model(model, mode=self.quantize, calib_mode=calib_mode,
                           calib_data=calib_data)
        # the dispatch locks, one a replica: a dispatch holds its replica's
        # from the input copy to the output copy-out, a swap holds them all
        # while it copies the new weights in
        self._params_lock = threading.Lock()
        self._replica_locks = [self._params_lock] + [
            threading.Lock() for _ in self.devices[1:]]
        self._swap_epoch = 0
        self._batch_idx = 0
        self._batch_lock = threading.Lock()
        self.inject_fault = None  # drill hook: callable(batch_idx) may raise
        self._metrics_port = metrics_port
        self.metrics_http = None
        self._build()
        self._started = False
        self._start_lock = threading.Lock()
        from . import _register

        _register(self)
        if warmup:
            self.warmup()

    def _build(self):
        """The executor pools (one a replica) and the batcher for
        ``self.buckets``."""
        fn, _ = self.model.serving_fn()
        plist = list(self.model.collect_params().values())
        self._plist = plist
        self._copies = {}
        self._pools = [BucketedExecutor(
            fn, lambda: [p._tensor() for p in plist], self.buckets,
            self.device, name=self.name)]
        for r, dev in enumerate(self.devices[1:], 1):
            self._pools.append(BucketedExecutor(
                fn, self._replica_params_fn(r), self.buckets, dev,
                name="%s:r%d" % (self.name, r)))
        self._pool = self._pools[0]
        self._replica_batches = [0] * len(self._pools)
        self._batcher = DynamicBatcher(
            self._dispatch, max_batch=self.buckets[-1],
            max_wait_ms=self._max_wait_ms, max_queue=self._max_queue,
            metrics=self.metrics, num_dispatchers=len(self._pools))

    def _replica_params_fn(self, r):
        """Replica ``r``'s parameters: copies of the model's on its device,
        made again when a parameter was given a new tensor."""
        dev = self.devices[r]

        def params_fn():
            live = [p._tensor() for p in self._plist]
            ptrs = [t.data_ptr() for t in live]
            held = self._copies.get(r)
            if held is None or held[0] != ptrs:
                with torch.no_grad():
                    held = self._copies[r] = (
                        ptrs, [t.detach().to(dev, copy=True) for t in live])
            return held[1]

        return params_fn

    def warmup(self):
        """Make every bucket's program (on CUDA: capture its graph) before
        taking traffic; also proves the outputs are row-aligned (padding is
        sound only when each output carries the batch on axis 0)."""
        for pool, lock in zip(self._pools, self._replica_locks):
            with lock:
                pool.warmup(self._specs)
        if not all(pool.row_aligned for pool in self._pools):
            raise ServeError("model outputs do not all carry the batch on "
                             "axis 0 — padded serving cannot slice rows")
        return self

    def snapshot(self, prefix, input_names=None, epoch=0):
        """Write this server's serving artifact (its export layout and
        config); ``serve.load(prefix, snapshot=True)`` rebuilds it with
        every bucket captured before the first request
        (``mxnet_tpu_torch.cache.snapshot``). Returns the manifest path."""
        from ..cache.snapshot import save_snapshot

        return save_snapshot(self, prefix, input_names=input_names,
                             epoch=epoch)

    def start(self):
        with self._start_lock:
            self._batcher.start()
            if self._metrics_port is not None and self.metrics_http is None:
                self.metrics_http = MetricsHTTPServer(
                    self._metrics_port, health_fn=self.health)
            self._started = True
        return self

    def stop(self, drain=True, timeout_s=5.0, reason="server stopped"):
        """Stop serving. ``drain=True`` dispatches what is queued first;
        whatever is left after the bounded join is rejected with
        ``ServeError(reason)``. start() after stop() starts afresh."""
        with self._start_lock:
            self._started = False
            self._batcher.stop(drain=drain, timeout_s=timeout_s,
                               reason=reason)
            if self.metrics_http is not None:
                self.metrics_http.close()
                self.metrics_http = None

    def health(self):
        """Cheap liveness payload, the JAX server's keys: warm flag, the
        two load gauges (queued rows) and the swap epoch."""
        queue = self._batcher.queue_depth()
        self.metrics.record_tokens_in_flight(queue)
        return {"warm": bool(self._pool.row_aligned),
                "running": self._started,
                "kind": "model",
                "queue_depth": queue,
                "tokens_in_flight": queue,
                "swap_epoch": self._swap_epoch}

    def swap_parameters(self, params_file):
        """Weight hot-swap: the file is checked against the live model
        (``checkpoint.validate_swap``: missing, extra, reshaped or another
        dtype, quantized ``qweight``/``w_scale`` pages included, raises
        ``SwapError`` and the old weights keep serving), copied to the
        device, then copied into the live parameter tensors under the
        dispatch lock, so the bucket graphs, which hold those tensors'
        storage, serve the new weights without a capture, and a batch runs
        on all-old or all-new weights. Returns the new swap epoch."""
        picked = validate_swap(self.model, params_file)
        params = self.model._collect_params_with_prefix()
        staged = {n: a.to(self.device) for n, a in picked.items()}
        index = {id(p): i for i, p in enumerate(self._plist)}
        for lock in self._replica_locks:
            lock.acquire()
        try:
            with torch.no_grad():
                for name, arr in staged.items():
                    params[name].copy_data(arr)
                # every replica's copies take the same values
                for r in range(1, len(self._pools)):
                    self._pools[r]._params_fn()
                    for name, arr in staged.items():
                        i = index[id(params[name])]
                        self._copies[r][1][i].copy_(arr)
            self._swap_epoch += 1
        finally:
            for lock in reversed(self._replica_locks):
                lock.release()
        return self._swap_epoch

    def retune_buckets(self, buckets=None, max_buckets=6):
        """Rebuild the server on a new bucket set. ``buckets=None`` fits
        one to the measured request-size histogram (``ir.tune.fit_buckets``
        over ``metrics.request_rows()``, covering the current largest
        bucket). Drains in-flight work, builds a new pool and batcher,
        warms them up (capturing exactly the new buckets) and resumes if
        the server was running; the metrics carry over."""
        if buckets is None:
            hist = self.metrics.request_rows()
            if not hist:
                raise ServeError(
                    "no request-size history to fit buckets to: serve "
                    "traffic first or pass buckets= explicitly")
            buckets = fit_buckets(hist, max_buckets=max_buckets,
                                  max_size=self.buckets[-1])
        new = tuple(sorted(set(int(b) for b in buckets)))
        if not new:
            raise ServeError("retune_buckets needs a non-empty bucket set")
        if new == self.buckets:
            return self
        was_started = self._started
        if was_started:
            self.stop()
        self.buckets = new
        self._build()
        self.warmup()
        if was_started:
            self.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()

    def _coerce(self, xs):
        """One request's inputs → numpy with a leading batch dim; returns
        (arrays, n_rows, was_sample)."""
        if len(xs) != len(self._specs):
            raise ServeError("model takes %d inputs, got %d"
                             % (len(self._specs), len(xs)))
        out, n, was_sample = [], None, False
        for x, (shape, dt) in zip(xs, self._specs):
            x = np.asarray(x, dtype=dt)
            if x.shape == shape:
                x = x[None]
                was_sample = True
            elif x.shape[1:] != shape:
                raise ServeError("input shape %s matches neither sample %s "
                                 "nor batch (n,)+%s" % (x.shape, shape, shape))
            if n is None:
                n = x.shape[0]
            elif x.shape[0] != n:
                raise ServeError("inputs disagree on batch size")
            out.append(x)
        return out, n, was_sample

    def _submit_arrays(self, arrays, n, timeout_ms):
        if not self._started:
            self.start()
        if n > self.buckets[-1]:
            raise ServeError("request of %d rows exceeds the largest bucket "
                             "%d" % (n, self.buckets[-1]))
        return self._batcher.submit(arrays, n, timeout_ms=timeout_ms,
                                    trace=new_trace(self.name))

    def submit(self, *xs, timeout_ms=None):
        """Asynchronous enqueue; returns a handle with ``.result(timeout_s)``
        giving one numpy array per model output. Raises ServerBusy when
        admission control sheds."""
        arrays, n, _ = self._coerce(xs)
        tmo = self.timeout_ms if timeout_ms is None else float(timeout_ms)
        return self._submit_arrays(arrays, n, tmo)

    def predict(self, *xs, timeout_ms=None):
        """Synchronous inference through the batcher. Returns one numpy
        array per model output (batch dim dropped for a bare sample)."""
        tmo = self.timeout_ms if timeout_ms is None else float(timeout_ms)
        arrays, n, was_sample = self._coerce(xs)
        req = self._submit_arrays(arrays, n, tmo)
        try:
            outs = req.result(timeout_s=tmo / 1e3 + 5.0)
        except ServeTimeout:
            if req.finish(error=ServeTimeout("result wait expired")):
                self.metrics.record_timeout()
            raise
        if was_sample and n == 1:
            outs = [o[0] for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def _dispatch(self, requests, total_rows):
        """Batcher callback: coalesce, one bucket forward, scatter results;
        finishes every request."""
        with self._batch_lock:
            idx = self._batch_idx
            self._batch_idx += 1
        replica = idx % len(self._pools)  # round-robin over the replicas
        try:
            if self.inject_fault is not None:
                self.inject_fault(idx)
            traces = []
            t_co = time.perf_counter()
            for r in requests:
                if r.trace is not None:
                    r.trace.add_span("queue", r.t_submit, r.t_dequeue or t_co)
                    traces.append(r)
            ins = [np.concatenate([r.inputs[i] for r in requests], axis=0)
                   for i in range(len(self._specs))]
            if traces:
                t_co1 = time.perf_counter()
                for r in traces:
                    r.trace.add_span("coalesce", r.t_dequeue or t_co, t_co1,
                                     rows=total_rows)
                traces = [r.trace for r in traces]
            pool = self._pools[replica]
            with self._replica_locks[replica]:
                outs = pool.run(ins, n_real=total_rows, traces=traces)
                self._replica_batches[replica] += 1
            self.metrics.record_batch(total_rows,
                                      pool.pick_bucket(total_rows))
            now = time.perf_counter()
            off = 0
            for r in requests:
                per = [o[off:off + r.n] for o in outs]
                off += r.n
                if r.finish(result=per):
                    self.metrics.record_latency((now - r.t_submit) * 1e3)
        except Exception as e:  # keep serving: the error goes to the callers
            self.metrics.record_error()
            for r in requests:
                r.finish(error=e)

    def stats(self):
        """Snapshot: batcher/latency metrics, the bucket set, the pools'
        program counters (``captures``, ``replays``, ``drops``: summed over
        the replicas; ``programs``: the first replica's) and ``replicas``,
        each replica's device, batches and counters."""
        snap = self.metrics.snapshot()
        per = [dict(pool.stats(), device=str(dev), batches=n)
               for pool, dev, n in zip(self._pools, self.devices,
                                       self._replica_batches)]
        snap.update(buckets=list(self.buckets), device=str(self.device),
                    quantize=self.quantize, running=self._started,
                    swap_epoch=self._swap_epoch, replicas=per,
                    programs=per[0]["programs"],
                    **{k: sum(r[k] for r in per)
                       for k in ("captures", "replays", "drops")})
        return snap
