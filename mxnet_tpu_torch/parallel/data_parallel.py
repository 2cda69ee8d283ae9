"""Data-parallel train steps over tensors (counterpart of
``mxnet_tpu/parallel/data_parallel.py``).

The JAX package compiles one program for a step over a device mesh; here
every rank runs the step on its own block of the batch
(:func:`shard_batch`) and the gradients are averaged over the mesh's
``dp`` group before one multi-tensor optimizer step, so every rank ends
the step with the same weights, those of the whole batch's step.
``shard_weight_update`` shards the update (ZeRO-1). Tensor-parallel and
fully sharded parameters (``param_spec``) are the model-parallel half of
ROADMAP.md A.12, not ported yet.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..util import map_state, tree_leaves
from .mesh import P

__all__ = ["tree_optimizer_step", "weight_update_spec", "build_train_step",
           "replicate_params", "shard_batch", "block_loss_fn"]


def _rebuild(like, leaves):
    """A structure shaped as ``like`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        return type(node)(build(x) for x in node)

    return build(like)


def tree_optimizer_step(optimizer):
    """``(init_states, apply)`` of ``optimizer`` over a nested structure of
    tensors. ``init_states(params)`` gives each leaf's state;
    ``apply(params, grads, states, lr, wd, t)`` runs one multi-tensor step
    over every leaf with the same rate, decay and update count (no
    multipliers, no update counting), updating the weights and states in
    place, and returns ``(params, states)``."""

    def init_states(params):
        return _rebuild(params, [optimizer.create_state(0, p)
                                 for p in tree_leaves(params)])

    def apply(params, grads, states, lr, wd, t):
        ws = tree_leaves(params)
        n = len(ws)
        optimizer._apply(ws, tree_leaves(grads, params),
                         tree_leaves(states, params),
                         [float(lr)] * n, [float(wd)] * n, [int(t)] * n)
        return params, states

    return init_states, apply


def weight_update_spec(shape, mesh, axis="dp"):
    """The spec sharding the first axis of ``shape`` that the group size
    divides (ZeRO-1); whole when none does."""
    from ..dist.zero import shard_spec

    return shard_spec(shape, mesh.shape[axis], axis)


def _batch_axis(batch_spec):
    spec = batch_spec
    while isinstance(spec, (list, tuple)) and spec and \
            isinstance(spec[0], (list, tuple)) and \
            not isinstance(spec, P):
        spec = spec[0]
    axis = spec[0] if isinstance(spec, (list, tuple)) and spec else spec
    return axis or "dp"


def build_train_step(loss_fn, optimizer, mesh=None, param_spec=None,
                     batch_spec=None, donate=True, remat=False,
                     shard_weight_update=False, shard_axis="dp"):
    """``step(params, states, t, key, batch) -> (params, states, loss)``.

    - ``loss_fn(params, batch, key)``: a scalar loss, the mean over the
      batch it is given;
    - ``mesh``: None for one process; else ``batch`` is this rank's block
      (:func:`shard_batch`) over the axis ``batch_spec`` names (default
      ``dp``), the gradients and the loss are averaged over that axis's
      group, and the returned loss is the whole batch's;
    - ``remat``: recompute the forward in the backward
      (``torch.utils.checkpoint``);
    - ``shard_weight_update``: each rank updates its block of every leaf
      along the first axis the ``shard_axis`` group divides, then the
      leaves are all-gathered (ZeRO-1, ``optimizer.sharded_step``); the
      states returned hold only the rank's blocks (whole states given to
      the first call are cut).

    The parameters and states are updated in place (``donate`` is the JAX
    package's buffer donation; here nothing is copied either way)."""
    if shard_weight_update and mesh is None:
        raise ValueError("shard_weight_update=True requires a mesh")
    if param_spec is not None and any(
            tuple(s) for s in tree_leaves(param_spec)
            if isinstance(s, tuple)):
        raise NotImplementedError(
            "sharded parameters (fsdp / tensor parallel) are the "
            "model-parallel half of ROADMAP.md A.12, not ported yet")
    _, apply = tree_optimizer_step(optimizer)
    axis = _batch_axis(batch_spec)

    def forward(params, batch, key):
        if remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(loss_fn, params, batch, key,
                              use_reentrant=False)
        return loss_fn(params, batch, key)

    def step(params, states, t, key, batch):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = forward(_rebuild(params, live), batch, key)
            grads = list(torch.autograd.grad(loss, live, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss = loss.detach()
        if mesh is not None and mesh.shape[axis] > 1:
            group, n = mesh.group(axis), mesh.shape[axis]
            flat = torch.cat([g.reshape(-1).float() for g in grads]
                             + [loss.reshape(1).float()])
            dist.all_reduce(flat, group=group)
            flat /= n
            off = 0
            for i, g in enumerate(grads):
                grads[i] = flat[off:off + g.numel()].reshape(g.shape).to(
                    g.dtype)
                off += g.numel()
            loss = flat[-1].to(loss.dtype)
        lr = optimizer.learning_rate
        if shard_weight_update:
            from ..dist.zero import block, shard_dim
            from ..optimizer import sharded_step

            group, n = mesh.group(shard_axis), mesh.shape[shard_axis]
            r = mesh.local_rank(shard_axis)
            sb = []
            for w, s in zip(leaves, tree_leaves(states, params)):
                d = shard_dim(tuple(w.shape), n)
                # a whole state leaf (the first call's) becomes its block
                sb.append(s if d is None else map_state(
                    s, lambda x, d=d, shape=tuple(w.shape):
                    block(x, d, r, n).clone() if tuple(x.shape) == shape
                    else x))
            k = len(leaves)
            sharded_step(lambda wb, gb: optimizer._apply(
                wb, gb, sb, [float(lr)] * k, [float(optimizer.wd)] * k,
                [int(t)] * k), leaves, grads, group, n, r)
            states = _rebuild(params, sb)
        else:
            apply(params, _rebuild(params, grads), states, lr, optimizer.wd,
                  t)
        return params, states, loss

    return step


def replicate_params(params, mesh, axis=None):
    """Every rank of ``mesh`` (or of its ``axis`` group) takes the first
    rank's values of the tensors of ``params``, in place."""
    group = mesh.group(axis) if axis else None
    src = int(mesh.devices.ravel()[0]) if axis is None else \
        dist.get_process_group_ranks(group)[0]
    if dist.get_world_size() > 1:
        with torch.no_grad():
            for t in tree_leaves(params):
                dist.broadcast(t, src=src, group=group)
    return params


def shard_batch(batch, mesh, axis="dp"):
    """This rank's block of each tensor of ``batch`` (the whole batch on
    every rank), split along its first axis over ``axis``."""
    from .mesh import shard_array

    def cut(x):
        return shard_array(x, mesh, axis)

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(cut(x) for x in batch)
    return cut(batch)


def block_loss_fn(block, loss_block, training=True):
    """A Gluon block and loss as ``loss_fn(param_tensors, (x, y), key)``
    for :func:`build_train_step`, the mean of the loss over the batch;
    ``param_tensors`` in ``block.collect_params()`` order (returned as
    the second value). ``key`` is unused: dropout draws from the port's
    generators."""
    from .. import autograd
    from ..gluon.block import _param_store

    plist = list(block.collect_params().values())

    def loss_fn(param_arrays, batch, key=None):
        x, y = batch
        prev = getattr(_param_store, "params", None)
        _param_store.params = {id(p): a for p, a in zip(plist, param_arrays)}
        try:
            with autograd.record(train_mode=training):
                out = block(x)
                loss = loss_block(out, y)
        finally:
            _param_store.params = prev
        return loss.mean()

    return loss_fn, plist
