"""Bucketed executor (counterpart of ``mxnet_tpu/serve/executor_pool.py``
``BucketedExecutor``).

A batch is padded on the host to the smallest configured batch-size bucket,
copied to the device, run through the model's eval function under
``torch.inference_mode()``, copied back, and the pad rows are sliced off.
Bucketing keeps the set of shapes the model sees small; the JAX package
compiles one program per bucket, the port runs eagerly (capturing one CUDA
graph per bucket is later work).
"""
from __future__ import annotations

import numpy as np
import torch


class PoolError(RuntimeError):
    """Misuse of the executor pool (shape/bucket mismatch)."""


def to_numpy(t):
    """Device tensor → numpy on the host. bfloat16, which numpy cannot
    hold, comes back as float32 (exact)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class BucketedExecutor:
    """Eval-mode executor over a fixed bucket set.

    Parameters
    ----------
    fn : callable
        ``fn(param_tensors, *inputs) -> output or tuple`` (eval mode).
    params_fn : callable
        Zero-argument callable returning the current parameter tensors, read
        per dispatch.
    buckets : tuple of int
        Allowed padded batch sizes.
    device : torch.device
        Where inputs go and the model runs.
    """

    def __init__(self, fn, params_fn, buckets, device):
        if not buckets:
            raise PoolError("BucketedExecutor needs at least one bucket")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.device = torch.device(device)
        self._fn = fn
        self._params_fn = params_fn
        self._in_dtypes = None   # pinned at warmup / first dispatch
        self._row_outputs = None  # per output: does axis 0 carry the batch?

    def pick_bucket(self, n):
        """Smallest bucket that fits ``n`` rows."""
        if n <= 0:
            raise PoolError("empty batch")
        for b in self.buckets:
            if n <= b:
                return b
        raise PoolError("batch of %d rows exceeds the largest bucket %d"
                        % (n, self.buckets[-1]))

    def _prepare(self, inputs, bucket):
        """Host-side pad-to-bucket with zero rows, dtypes pinned to the
        first signature seen."""
        if self._in_dtypes is None:
            self._in_dtypes = [np.asarray(x).dtype for x in inputs]
        prepped = []
        for x, dt in zip(inputs, self._in_dtypes):
            x = np.asarray(x, dtype=dt)
            if x.shape[0] != bucket:
                pad = np.zeros((bucket - x.shape[0],) + x.shape[1:], dtype=dt)
                x = np.concatenate([x, pad], axis=0)
            prepped.append(x)
        return prepped

    def run(self, inputs, n_real=None):
        """Pad to the bucket, one forward, copy back, slice off the pad rows.
        ``inputs`` share the leading batch dim; returns numpy outputs with
        ``n_real`` rows each (outputs without a batch axis come back
        whole)."""
        n = int(np.asarray(inputs[0]).shape[0])
        n_real = n if n_real is None else int(n_real)
        bucket = self.pick_bucket(n)
        xs = [torch.from_numpy(x).to(self.device)
              for x in self._prepare(inputs, bucket)]
        with torch.inference_mode():
            outs = self._fn(self._params_fn(), *xs)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            outs = [to_numpy(o) for o in outs]
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
        """Run every bucket once with zero inputs. ``input_specs``: per
        input, (sample_shape, dtype)."""
        self._in_dtypes = [np.dtype(dt) for _, dt in input_specs]
        for b in self.buckets:
            self.run([np.zeros((b,) + tuple(shape), dtype=dt)
                      for shape, dt in input_specs])
        return self
