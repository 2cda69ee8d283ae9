"""Bucketed executor (counterpart of ``mxnet_tpu/serve/executor_pool.py``
``BucketedExecutor``).

A batch is padded to the smallest configured batch-size bucket, run through
the model's eval function under ``torch.inference_mode()``, copied back,
and the pad rows (zeros) are sliced off. The JAX package compiles one
program per bucket; here each bucket is one ``torch.cuda.CUDAGraph`` on a
CUDA device, captured at warmup (the largest bucket first) or at the
bucket's first use, and replayed at every dispatch after.

A bucket's program reads static buffers: per model input, a pinned host
staging buffer and a device buffer at the bucket's shape. A dispatch writes
the batch into the staging buffer (its pad rows zeroed), copies it to the
device buffer, replays, and copies the outputs out before it returns, so
the next replay, of this bucket or another (all share one graph memory
pool), may overwrite them. The caller serialises dispatches (the server's
dispatch lock). The valid lengths are one of those inputs, so they reach
the kernels as device data, never as a host value baked at capture.

A graph holds the parameters' storage: every dispatch compares the
addresses ``params_fn`` gives with those the programs were captured on,
and drops every program if one moved (a parameter given a new tensor);
each bucket is captured again at its next use. A weight swap that copies
into the live parameters keeps them. The kernels' launch counters are
host integers that a replay does not tick: the counts at capture are
recorded per bucket and added back at every replay (the warm-up runs and
the capture's own counts are taken out), as ``capture.py`` does.

On the CPU the same object runs each dispatch eagerly on the static
buffers, with the same programs, counters and address checks, so they can
be tested there.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import engine
from ..base import resolve_dtype
from ..capture import add_launches, capture_graph


class PoolError(RuntimeError):
    """Misuse of the executor pool (shape/bucket mismatch, a failed
    capture)."""


def to_numpy(t):
    """Device tensor → numpy on the host. bfloat16, which numpy cannot
    hold, comes back as float32 (exact)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _Bucket:
    """One bucket's program: its static input buffers (``host`` staging,
    pinned, on CUDA only; ``dev``), the graph and its outputs (CUDA only)
    and the launch counts its replay adds back."""

    __slots__ = ("host", "dev", "graph", "outs", "deltas")

    def __init__(self, host, dev):
        self.host = host
        self.dev = dev
        self.graph = None
        self.outs = None
        self.deltas = {}


class BucketedExecutor:
    """Eval-mode executor over a fixed bucket set, one program a bucket.

    Parameters
    ----------
    fn : callable
        ``fn(param_tensors, *inputs) -> output or tuple`` (eval mode).
    params_fn : callable
        Zero-argument callable returning the live parameter tensors.
    buckets : tuple of int
        Allowed padded batch sizes.
    device : torch.device
        Where inputs go and the model runs.

    ``captures`` counts programs made (graphs captured on CUDA, set up on
    the CPU), ``replays`` dispatches run through a program, ``drops`` the
    times a parameter moved and every program was dropped.
    """

    def __init__(self, fn, params_fn, buckets, device, name="pool"):
        if not buckets:
            raise PoolError("BucketedExecutor needs at least one bucket")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.name = name
        self._fn = fn
        self._params_fn = params_fn
        self._in_specs = None    # [(sample shape, dtype)], pinned at first use
        self._row_outputs = None  # per output: does axis 0 carry the batch?
        self._programs = {}
        self._param_addresses = None
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.drops = 0

    def pick_bucket(self, n):
        """Smallest bucket that fits ``n`` rows."""
        if n <= 0:
            raise PoolError("empty batch")
        for b in self.buckets:
            if n <= b:
                return b
        raise PoolError("batch of %d rows exceeds the largest bucket %d"
                        % (n, self.buckets[-1]))

    def _pin_specs(self, inputs):
        if self._in_specs is None:
            self._in_specs = [
                (tuple(x.shape[1:]), x.dtype) if isinstance(x, torch.Tensor)
                else (tuple(np.shape(x)[1:]), np.asarray(x).dtype)
                for x in inputs]
        return self._in_specs

    def _forward(self, params, xs):
        with torch.inference_mode():
            outs = self._fn(params, *xs)
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    def _check_params(self, params):
        """Drop every program when a parameter tensor moved."""
        addresses = [p.data_ptr() for p in params]
        if addresses != self._param_addresses:
            if self._programs:
                self._programs.clear()
                self._pool = None
                self.drops += 1
            self._param_addresses = addresses

    def _program(self, bucket, params):
        prog = self._programs.get(bucket)
        if prog is None:
            dev = [torch.zeros((bucket,) + shape, dtype=resolve_dtype(dt),
                               device=self.device)
                   for shape, dt in self._in_specs]
            host = [torch.zeros_like(d, device="cpu").pin_memory()
                    for d in dev] if self.graphed else None
            prog = _Bucket(host, dev)
            if self.graphed:
                self._capture(prog, bucket, params)
            self._programs[bucket] = prog
            self.captures += 1
            engine.serve_capture_counter.bump(
                note="serve[%s bucket=%d]" % (self.name, bucket))
        return prog

    def _capture(self, prog, bucket, params):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            # thread_local: the server's admission thread does host work
            # while the dispatcher captures
            got = capture_graph(lambda: self._forward(params, prog.dev),
                                self.device, self._pool)
        except RuntimeError as e:
            raise PoolError("capturing bucket %d failed: %s" % (bucket, e)) \
                from e
        prog.graph, prog.outs, prog.deltas = got.graph, got.out, got.deltas

    def _replay(self, prog, params, inputs, n):
        for i, (x, (_, dt)) in enumerate(zip(inputs, self._in_specs)):
            if isinstance(x, torch.Tensor):  # already on the device
                prog.dev[i][:n].copy_(x)
                prog.dev[i][n:].zero_()
                continue
            buf = prog.host[i] if self.graphed else prog.dev[i]
            buf[:n].copy_(torch.from_numpy(np.asarray(x, dtype=dt)))
            buf[n:].zero_()
            if self.graphed:
                prog.dev[i].copy_(buf, non_blocking=True)
        self.replays += 1
        if prog.graph is None:
            return self._forward(params, prog.dev)
        prog.graph.replay()
        add_launches(prog.deltas)
        return prog.outs

    def run(self, inputs, n_real=None, eager=False, to_host=True,
            traces=None):
        """Pad to the bucket, one forward through the bucket's program (or
        eagerly, on new tensors, with ``eager``), copy back, slice off the
        pad rows. ``inputs`` share the leading batch dim: numpy arrays, or
        tensors on the device, copied into the program's inputs there.
        Returns numpy outputs with ``n_real`` rows each (outputs without a
        batch axis come back whole); with ``to_host=False``, copies on the
        device in the outputs' own dtype. ``traces``: the batch's
        RequestTraces, each given the ``pad`` span (the bucket's program
        found, its inputs' shapes pinned) and the ``dispatch`` span (the
        copy in, the forward, the copy out)."""
        from .. import profiler

        t_pad0 = time.perf_counter() if traces else None
        n = int(np.shape(inputs[0])[0])
        n_real = n if n_real is None else int(n_real)
        bucket = self.pick_bucket(n)
        specs = self._pin_specs(inputs)
        params = self._params_fn()
        if eager:
            xs = []
            for x, (shape, dt) in zip(inputs, specs):
                padded = np.zeros((bucket,) + shape, dtype=dt)
                padded[:n] = x
                xs.append(torch.from_numpy(padded).to(self.device))
            outs = self._forward(params, xs)
        else:
            self._check_params(params)
            prog = self._program(bucket, params)
            t_disp0 = time.perf_counter() if traces else None
            if profiler.is_running():
                with profiler.serve_scope(bucket, n_real):
                    outs = self._replay(prog, params, inputs, n)
            else:
                outs = self._replay(prog, params, inputs, n)
        outs = [to_numpy(o) if to_host else o.detach().clone()
                for o in outs]
        if traces and not eager:
            t_done = time.perf_counter()
            for tr in traces:
                tr.add_span("pad", t_pad0, t_disp0, bucket=bucket)
                tr.add_span("dispatch", t_disp0, t_done, bucket=bucket,
                            rows=n_real)
        if self._row_outputs is None:
            self._row_outputs = [o.ndim >= 1 and o.shape[0] == bucket
                                 for o in outs]
        return [o[:n_real] if row else o
                for o, row in zip(outs, self._row_outputs)]

    @property
    def row_aligned(self):
        """True when every output carries the batch on axis 0 (known after
        the first dispatch)."""
        return self._row_outputs is not None and all(self._row_outputs)

    def warmup(self, input_specs):
        """Make every bucket's program, the largest first (its graph sizes
        the shared memory pool), and run each once on zero inputs.
        ``input_specs``: per input, (sample_shape, dtype)."""
        self._in_specs = [(tuple(shape), np.dtype(dt))
                          for shape, dt in input_specs]
        for b in reversed(self.buckets):
            self.run([np.zeros((b,) + shape, dtype=dt)
                      for shape, dt in self._in_specs])
        return self

    def stats(self):
        return {"captures": self.captures, "replays": self.replays,
                "drops": self.drops, "programs": sorted(self._programs)}
