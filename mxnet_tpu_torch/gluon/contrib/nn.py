"""contrib layers (ref: python/mxnet/gluon/contrib/nn/basic_layers.py;
counterpart of ``mxnet_tpu/gluon/contrib/nn.py``): the sub-pixel
upsamplers ``PixelShuffle1D/2D/3D`` (a reshape and a transpose),
``Identity``, ``SparseEmbedding`` (an ``Embedding`` whose gradient takes
the Trainer's lazy row update), ``HybridConcurrent``/``Concurrent``
(branches concatenated) and ``SyncBatchNorm`` (batch statistics
all-reduced over a process group)."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ... import autograd
from ...base import cast_out
from ..block import HybridBlock
from ..nn import BatchNorm

__all__ = ["Identity", "SparseEmbedding", "SyncBatchNorm", "HybridConcurrent",
           "Concurrent", "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D"]


def _factors(factor, n):
    f = tuple(factor) if isinstance(factor, (tuple, list)) else (factor,) * n
    if len(f) != n or not all(isinstance(x, (int, np.integer)) and x > 0
                              for x in f):
        raise ValueError("factor must be a positive int or a tuple of %d "
                         "positive ints, got %r" % (n, factor))
    return tuple(int(x) for x in f)


class PixelShuffle1D(HybridBlock):
    """(N, C·f, W) → (N, C, W·f) sub-pixel upsampling (ref: contrib/nn
    basic_layers.py:PixelShuffle1D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        (self._f,) = _factors(factor, 1)

    def hybrid_forward(self, F, x):
        f = self._f
        n, c, w = x.shape
        y = F.reshape(x, shape=(n, c // f, f, w))
        y = F.transpose(y, axes=(0, 1, 3, 2))        # (N, C, W, f)
        return F.reshape(y, shape=(n, c // f, w * f))

    def __repr__(self):
        return "%s(factor=%d)" % (type(self).__name__, self._f)


class PixelShuffle2D(HybridBlock):
    """(N, C·f1·f2, H, W) → (N, C, H·f1, W·f2); ``factor`` an int or (f1,
    f2) (ref: contrib/nn basic_layers.py:PixelShuffle2D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._fs = _factors(factor, 2)

    def hybrid_forward(self, F, x):
        f1, f2 = self._fs
        n, c, h, w = x.shape
        cc = c // (f1 * f2)
        y = F.reshape(x, shape=(n, cc, f1, f2, h, w))
        y = F.transpose(y, axes=(0, 1, 4, 2, 5, 3))  # (N, C, H, f1, W, f2)
        return F.reshape(y, shape=(n, cc, h * f1, w * f2))

    def __repr__(self):
        return "%s(factor=%s)" % (type(self).__name__, self._fs)


class PixelShuffle3D(HybridBlock):
    """(N, C·f1·f2·f3, D, H, W) → (N, C, D·f1, H·f2, W·f3) (ref: contrib/nn
    basic_layers.py:PixelShuffle3D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._fs = _factors(factor, 3)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._fs
        n, c, d, h, w = x.shape
        cc = c // (f1 * f2 * f3)
        y = F.reshape(x, shape=(n, cc, f1, f2, f3, d, h, w))
        y = F.transpose(y, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(y, shape=(n, cc, d * f1, h * f2, w * f3))

    def __repr__(self):
        return "%s(factor=%s)" % (type(self).__name__, self._fs)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """An embedding with a row-sparse gradient (ref:
    contrib/nn:SparseEmbedding): ``Embedding(sparse_grad=True)``, whose
    weight the Trainer steps by the optimizer's lazy row update, reading
    and writing only the rows a batch touched."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        from ..nn import Embedding

        with self.name_scope():
            self.embed = Embedding(input_dim, output_dim, dtype=dtype,
                                   sparse_grad=True)

    def hybrid_forward(self, F, x):
        return self.embed(x)


class HybridConcurrent(HybridBlock):
    """Parallel branches on one input, their outputs concatenated along
    ``axis`` (ref: contrib/nn:HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._children.values()],
                        dim=self._axis)


Concurrent = HybridConcurrent


def _channel_dims(x):
    return [0] + list(range(2, x.dim()))


def _all_reduce(t, group, n):
    if n > 1:
        dist.all_reduce(t, group=group)
    return t


def _global_stats(x, group, n):
    """The (count, mean, biased variance) of x's channels over the
    group's global batch, in fp32: one all-reduce of each channel's sum
    and the count, then one of its sum of squared deviations from the
    global mean (two passes: no cancellation)."""
    with torch.no_grad():
        xf = x.float()
        dims = _channel_dims(x)
        shape = [1, -1] + [1] * (x.dim() - 2)
        s = _all_reduce(torch.cat([xf.sum(dims), xf.new_full(
            (1,), xf.numel() // xf.shape[1])]), group, n)
        count = s[-1]
        mean = s[:-1] / count
        dev = _all_reduce(((xf - mean.reshape(shape)) ** 2).sum(dims),
                          group, n)
        return count, mean, dev / count


class _SyncBatchNormFn(torch.autograd.Function):
    """BatchNorm over the global batch of a process group from its
    statistics (:func:`_global_stats`), channels on axis 1, in fp32. The
    backward all-reduces the two gradient sums, sum(dy) and
    sum(dy * xhat); gamma's and beta's gradients are this rank's
    (averaged over the ranks with the rest of its gradients)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, count, mean, var, eps, group, n):
        shape = [1, -1] + [1] * (x.dim() - 2)
        invstd = torch.rsqrt(var + eps)
        xhat = (x.float() - mean.reshape(shape)) * invstd.reshape(shape)
        y = xhat * gamma.float().reshape(shape) + beta.float().reshape(shape)
        ctx.save_for_backward(xhat, invstd, gamma, count)
        ctx.args = (group, n, x.dtype, beta.dtype)
        return cast_out(y, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, invstd, gamma, count = ctx.saved_tensors
        group, n, xdtype, bdtype = ctx.args
        dims = _channel_dims(xhat)
        shape = [1, -1] + [1] * (xhat.dim() - 2)
        dyf = dy.float()
        local = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dbeta, dgamma = local[0].clone(), local[1].clone()
        tot = _all_reduce(local, group, n)
        dx = (gamma.float() * invstd).reshape(shape) * (
            dyf - (tot[0] / count).reshape(shape)
            - xhat * (tot[1] / count).reshape(shape))
        return (dx.to(xdtype), dgamma.to(gamma.dtype), dbeta.to(bdtype),
                None, None, None, None, None, None)


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (ref: contrib/nn:SyncBatchNorm). In the JAX
    package it is the plain BatchNorm under a sharded jit, whose batch
    statistics are the global batch's. Here each rank is a process: in
    training the statistics are all-reduced over ``axis_name``'s group of
    ``mesh`` (default: the entered mesh, else every rank of the default
    group), the moving statistics move by the global moments, and the
    backward all-reduces its two sums. With one rank it is ``BatchNorm``
    itself. ``num_devices``, when given, must be the group's size.
    Channels on axis 1."""

    def __init__(self, in_channels=0, num_devices=None, mesh=None,
                 axis_name="dp", **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
        self._mesh = mesh
        self._axis_name = axis_name

    def _group(self):
        from ...parallel.mesh import current_mesh

        mesh = self._mesh if self._mesh is not None else current_mesh()
        if mesh is not None:
            group, n = mesh.group(self._axis_name), int(
                mesh.shape[self._axis_name])
        elif dist.is_initialized():
            group, n = None, dist.get_world_size()
        else:
            group, n = None, 1
        if self._num_devices is not None and self._num_devices != n:
            raise ValueError("SyncBatchNorm(num_devices=%d) in a group of %d"
                             % (self._num_devices, n))
        return group, n

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        group, n = self._group()
        kw = self._kwargs
        if (n == 1 or not autograd.is_training() or kw["use_global_stats"]):
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)
        if self._axis != 1:
            raise ValueError("SyncBatchNorm takes its channels on axis 1")
        g = torch.ones_like(gamma) if kw["fix_gamma"] else gamma
        count, mean, var = _global_stats(x, group, n)
        out = _SyncBatchNormFn.apply(x, g, beta, count, mean, var,
                                     float(kw["eps"]), group, n)
        m = kw["momentum"]
        with torch.no_grad():
            new_mean = m * running_mean.float() + (1 - m) * mean
            new_var = m * running_var.float() + (1 - m) * var
        self._store_stats(running_mean, running_var, new_mean, new_var)
        return out
