"""ZeRO-2/3 sharded training state (counterpart of
``mxnet_tpu/dist/zero.py``; Rajbhandari et al., arXiv 1910.02054;
cross-replica weight-update sharding per Xu et al., arXiv 2004.13336).

* stage 1: ``Trainer.set_weight_update_sharding(mesh, axis)``: each rank
  updates its 1/N block of every weight and the weights are all-gathered;
  the optimizer state holds only the rank's blocks.
* stage 2: the exchanged gradients are kept as the rank's blocks from the
  exchange to the update (the whole gradient is released).
* stage 3: the weights themselves live as blocks between steps;
  :class:`Zero3ParamManager` all-gathers them, bucket by bucket, before a
  forward (``gather``) and drops the whole values again (``release``).

A block is the rank's slice along the first axis that the group size
divides (:func:`shard_spec`); a tensor no axis of which divides stays
whole on every rank. Block tensors carry their whole shape as
``_full_shape``, which :func:`global_bytes` reads. Sharding is placement,
not math: a run at any stage matches the unsharded run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import P, spec_axes
from .bucketer import _nbytes, default_bucket_mb
from .hierarchical import _all_gather

__all__ = ["shard_spec", "shard_dim", "block", "gather_block", "gather_spec",
           "per_device_bytes", "global_bytes", "Zero3ParamManager"]


def shard_dim(shape, nshard):
    """The first axis of ``shape`` that ``nshard`` divides (None: none)."""
    for d, s in enumerate(shape):
        if s >= nshard and s % nshard == 0:
            return d
    return None


def shard_spec(shape, nshard, axis):
    """The placement of a tensor of ``shape``: split along its first axis
    that ``nshard`` divides, else whole (the JAX package's rule, which its
    fused optimizer step shares)."""
    d = shard_dim(shape, nshard)
    return P() if d is None else P(*([None] * d + [axis]))


def block(t, d, r, n):
    """Rank ``r``'s block of ``t`` along axis ``d`` (a view)."""
    s = t.shape[d] // n
    return t.narrow(d, r * s, s)


def gather_block(full, blk, d, group, n, async_op=False):
    """All-gather every rank's ``blk`` (its block along ``d``) into
    ``full``; returns the work with ``async_op`` (``full`` is complete
    once it is waited on). A group of one launches it too."""
    shape = tuple(blk.shape)
    tmp = torch.empty((n * shape[0],) + shape[1:], dtype=blk.dtype,
                      device=blk.device)
    work = _all_gather(tmp, blk.contiguous(), group=group, async_op=True)

    def done():
        work.wait()
        if d == 0:
            full.copy_(tmp)
        else:
            full.copy_(torch.cat(tmp.view((n,) + shape).unbind(0), dim=d))

    if async_op:
        return _Work(done)
    done()
    return None


def _steps(spec):
    """(dimension, axis) of each all-gather that rebuilds a value placed by
    ``spec``, in order: a dimension's axes innermost first."""
    return [(d, a) for d, entry in enumerate(spec)
            for a in reversed(spec_axes(entry))]


def _whole_shape(blk, spec, mesh):
    shape = list(blk.shape)
    for d, a in _steps(spec):
        shape[d] *= int(mesh.shape[a])
    return tuple(shape)


def gather_spec(full, blk, spec, mesh, async_op=False):
    """All-gather every rank's ``blk`` (its block of a value placed by
    ``spec`` over ``mesh``'s axes) into ``full``: :func:`gather_block`
    over each named axis's group in turn. Only a value split over one
    axis is gathered asynchronously."""
    steps = _steps(spec)
    if len(steps) == 1:
        d, a = steps[0]
        return gather_block(full, blk, d, mesh.group(a), int(mesh.shape[a]),
                            async_op=async_op)
    cur = blk
    for i, (d, a) in enumerate(steps):
        n = int(mesh.shape[a])
        shape = list(cur.shape)
        shape[d] *= n
        nxt = full if i == len(steps) - 1 else torch.empty(
            shape, dtype=cur.dtype, device=cur.device)
        gather_block(nxt, cur, d, mesh.group(a), n)
        cur = nxt
    return _Work(None) if async_op else None


class _Work:
    def __init__(self, fn):
        self._fn = fn

    def wait(self):
        if self._fn is not None:
            self._fn()
            self._fn = None


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return []


def per_device_bytes(tree):
    """Bytes this rank holds for the tensors of ``tree``."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def global_bytes(tree):
    """Bytes of the whole values of ``tree``'s tensors (a block counts as
    its whole tensor)."""
    total = 0
    for t in _leaves(tree):
        shape = getattr(t, "_full_shape", None) or tuple(t.shape)
        n = 1
        for s in shape:
            n *= int(s)
        total += n * t.element_size()
    return total


class Zero3ParamManager:
    """ZeRO-3 parameter residency over gluon ``Parameter``s: between steps
    each parameter keeps only this rank's block (``shards``; the
    parameter's tensor is emptied, so a forward without :meth:`gather`
    fails loudly); :meth:`gather` rebuilds the whole values bucket by
    bucket (one all-gather a member, every bucket launched before the
    first is waited on) into the same tensors, and :meth:`release` drops
    them again. The optimizer steps the blocks. A parameter is placed by
    :func:`shard_spec` over ``shard_axis``."""

    def __init__(self, params, mesh, shard_axis="dp", bucket_mb=None):
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.nshard = int(mesh.shape.get(shard_axis, 1))
        self.params = [p for p in params
                       if getattr(p, "_data", None) is not None]
        self.gathers = 0
        self.shards = {}
        self.full_shapes = {id(p): tuple(p._data.shape) for p in self.params}
        self.specs = {id(p): shard_spec(self.full_shapes[id(p)], self.nshard,
                                        shard_axis) for p in self.params}
        cap = int((default_bucket_mb() if bucket_mb is None
                   else float(bucket_mb)) * (1 << 20))
        # the gradient bucketer's greedy partition over the parameters
        self.buckets, cur, cur_b = [], [], 0
        for p in self.params:
            b = _nbytes(self.full_shapes[id(p)], p._data.dtype)
            if cur and cur_b + b > cap:
                self.buckets.append(cur)
                cur, cur_b = [], 0
            cur.append(p)
            cur_b += b
        if cur:
            self.buckets.append(cur)
        for p in self.params:
            blk = self._cut(p)
            blk._full_shape = self.full_shapes[id(p)]
            self.shards[id(p)] = blk
        self.gathered = True

    def _cut(self, p):
        from ..parallel.mesh import shard_array

        return shard_array(p._data.detach(), self.mesh,
                           *self.specs[id(p)]).clone()

    def shard(self, p):
        """This rank's block of ``p`` (the tensor the optimizer steps)."""
        return self.shards[id(p)]

    def gather_bucket(self, i, async_op=False):
        """Rebuild one bucket's whole weights from every rank's blocks."""
        works = []
        with torch.no_grad():
            for p in self.buckets[i]:
                blk = self.shards[id(p)]
                full = torch.empty(self.full_shapes[id(p)], dtype=blk.dtype,
                                   device=blk.device)
                spec = self.specs[id(p)]
                if not any(spec_axes(a) for a in spec):
                    full.copy_(blk)
                else:
                    works.append(gather_spec(full, blk, spec, self.mesh,
                                             async_op=True))
                p._data.data = full
        self.gathers += 1
        if async_op:
            return works
        for w in works:
            w.wait()
        return []

    def gather(self):
        """Every bucket's gather, all launched before any is waited on."""
        works = []
        for i in range(len(self.buckets)):
            works += self.gather_bucket(i, async_op=True)
        for w in works:
            w.wait()
        self.gathered = True

    def release(self):
        """Drop the whole weights: each parameter keeps its block only."""
        for p in self.params:
            p._data.data = torch.empty(0, dtype=p._data.dtype,
                                       device=p._data.device)
        self.gathered = False

    def param_bytes(self):
        """(bytes this rank holds for the parameters, their whole bytes):
        the whole values while gathered, the blocks while released."""
        per, glob = 0, 0
        for p in self.params:
            full = _nbytes(self.full_shapes[id(p)], p._data.dtype)
            glob += full
            per += full if p._data.numel() else \
                self.shards[id(p)].numel() * self.shards[id(p)].element_size()
        return per, glob
