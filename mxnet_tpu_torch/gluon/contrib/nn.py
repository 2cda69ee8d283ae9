"""contrib layers (ref: python/mxnet/gluon/contrib/nn/basic_layers.py;
counterpart of ``mxnet_tpu/gluon/contrib/nn.py``). Only
:class:`SyncBatchNorm` so far: ``Identity``, ``SparseEmbedding``,
``HybridConcurrent``/``Concurrent`` and ``PixelShuffle*`` are ROADMAP.md
A.17."""
from __future__ import annotations

import torch
import torch.distributed as dist

from ... import autograd
from ...base import cast_out
from ..nn import BatchNorm

__all__ = ["SyncBatchNorm"]


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
