"""ModelServer — dynamic-batching inference serving (counterpart of
``mxnet_tpu/serve/server.py``).

    net = bert_base(); net.initialize(); amp.convert_hybrid_block(net)
    srv = ModelServer(net, [((512,), "int32"), ((512,), "int32"),
                            ((), "int32")], buckets=(1, 4, 8))
    with srv:
        seq, pooled, nsp = srv.predict(tokens, types, valid_len)
        handle = srv.submit(tokens, types, valid_len)   # .result(timeout_s)
        srv.stats()

Single requests coalesce into the smallest fitting batch-size bucket under
a deadline (batcher), run as one padded forward on the device
(executor_pool), and are scattered back per request. The server runs on the
current CUDA device unless ``device`` says otherwise; without CUDA and
without ``device="cpu"`` it raises. ``quantize="int8"`` (or an fp8 mode)
serves the model with quantized Dense layers, optionally calibrated.
Snapshots, bucket retuning, the metrics endpoint and a per-bucket CUDA
graph are not ported yet, nor is this server's weight hot-swap; the
generative server's is (``GenerativeServer.swap_parameters`` over
``checkpoint.validate_swap``).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..base import resolve_device
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
    quantize : None or 'int8' / 'e4m3' / 'e5m2'
        Serve with quantized weights: ``quantization.quantize_model`` swaps
        every Dense for its quantized twin before the executor pool is
        built.
    calib_mode, calib_data
        Activation-scale calibration of the quantized layers (``"naive"``
        or ``"entropy"``) against ``calib_data`` (batches of the model's
        inputs, e.g. a warm-up batch shaped like real traffic); ignored
        unless ``quantize`` is set.
    """

    def __init__(self, model, input_specs, buckets=DEFAULT_BUCKETS,
                 max_wait_ms=2.0, max_queue=256, timeout_ms=1000.0,
                 device=None, name=None, warmup=True, quantize=None,
                 calib_mode="none", calib_data=None):
        self.device = resolve_device(device)
        self.name = name or ("serve:%s" % type(model).__name__.lower())
        self.model = model
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._specs = [(tuple(shape), np.dtype(dt))
                       for shape, dt in input_specs]
        self.timeout_ms = float(timeout_ms)
        self.metrics = ServeMetrics(self.name)
        model.collect_params().reset_device(self.device)
        self.quantize = quantize or None
        if self.quantize is not None:
            quantize_model(model, mode=self.quantize, calib_mode=calib_mode,
                           calib_data=calib_data)
        fn, _ = model.serving_fn()
        plist = list(model.collect_params().values())
        self._pool = BucketedExecutor(
            fn, lambda: [p.data() for p in plist], self.buckets, self.device)
        self._batcher = DynamicBatcher(
            self._dispatch, max_batch=self.buckets[-1],
            max_wait_ms=max_wait_ms, max_queue=max_queue, metrics=self.metrics)
        self._started = False
        self._start_lock = threading.Lock()
        from . import _register

        _register(self)
        if warmup:
            self.warmup()

    def warmup(self):
        """Run every bucket once before taking traffic; also proves the
        outputs are row-aligned (padding is sound only when each output
        carries the batch on axis 0)."""
        self._pool.warmup(self._specs)
        if not self._pool.row_aligned:
            raise ServeError("model outputs do not all carry the batch on "
                             "axis 0 — padded serving cannot slice rows")
        return self

    def start(self):
        with self._start_lock:
            self._batcher.start()
            self._started = True
        return self

    def stop(self, drain=True, timeout_s=5.0):
        with self._start_lock:
            self._started = False
            self._batcher.stop(drain=drain, timeout_s=timeout_s)

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
        return self._batcher.submit(arrays, n, timeout_ms=timeout_ms)

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
        try:
            ins = [np.concatenate([r.inputs[i] for r in requests], axis=0)
                   for i in range(len(self._specs))]
            outs = self._pool.run(ins, n_real=total_rows)
            self.metrics.record_batch(total_rows,
                                      self._pool.pick_bucket(total_rows))
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
        """Snapshot: batcher/latency metrics plus the bucket set."""
        snap = self.metrics.snapshot()
        snap.update(buckets=list(self.buckets), device=str(self.device),
                    quantize=self.quantize, running=self._started)
        return snap
