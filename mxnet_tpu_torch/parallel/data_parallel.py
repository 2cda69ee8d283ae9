"""Data-parallel train steps over tensors (counterpart of
``mxnet_tpu/parallel/data_parallel.py``).

The JAX package compiles one program for a step over a device mesh; here
every rank runs the step on its own block of the batch
(:func:`shard_batch`) and the gradients are averaged over the mesh's
``dp`` group before one multi-tensor optimizer step, so every rank ends
the step with the same weights, those of the whole batch's step.
``shard_weight_update`` shards the update (ZeRO-1). A parameter whose
``param_spec`` splits it over mesh axes (tensor parallel, fully sharded)
is held as this rank's block between steps, and the step runs the model
inside a ``tensor_parallel.tp_scope`` that names the blocks. A loss from
:func:`block_loss_fn` hands the model the blocks: the port's GPT and BERT
blocks split their math over ``tp`` on them (a leaf a split layer
consumes is never gathered, and its gradient is this rank's block,
exact), and any other read of a block all-gathers it, its gradient
reduce-scattered back and divided by the ranks it was summed over. Any
other loss function gets every split leaf gathered so.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..util import map_state, tree_leaves
from .mesh import P, spec_axes
from .tensor_parallel import step_seed, tp_scope

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
    - ``param_spec``: one spec for every leaf, or a structure of specs
      shaped as ``params``; a leaf a spec splits over mesh axes is this
      rank's block (``tensor_parallel.shard_params``), consumed as a
      block by a split layer or all-gathered for its reader, as the
      module docstring says (a spec naming no axis of ``mesh`` raises);
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
    if param_spec is not None and mesh is None:
        raise ValueError("param_spec places parameters on a mesh: pass "
                         "mesh=")
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
        specs = _leaf_specs(param_spec, params, leaves, mesh)
        split = [i for i, sp in enumerate(specs) if _axes(sp)]
        live = [p.detach().requires_grad_(True) for p in leaves]
        scope = tp_scope(mesh, [(live[i], specs[i]) for i in split])
        with torch.enable_grad(), scope, _dropout_stream(mesh, t, leaves):
            args = live
            if not getattr(loss_fn, "_reads_param_blocks", False):
                # a plain loss function reads whole tensors
                args = [scope.whole(a) for a in live]
            loss = forward(_rebuild(params, args), batch, key)
            grads = list(torch.autograd.grad(loss, live, allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        del live, args
        loss = loss.detach()
        if mesh is not None and mesh.shape.get(axis, 1) > 1:
            # each rank's gradient is its batch block's: the mean over the
            # batch axis, but for a leaf split over that axis, which its
            # reduce-scatter already averaged
            group, n = mesh.group(axis), mesh.shape[axis]
            mean = [i for i in range(len(grads)) if axis not in _axes(
                specs[i])]
            flat = torch.cat([grads[i].reshape(-1).float() for i in mean]
                             + [loss.reshape(1).float()])
            dist.all_reduce(flat, group=group)
            flat /= n
            off = 0
            for i in mean:
                g = grads[i]
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
            # a leaf already split over the update's axis is updated
            # whole: its block is all this rank holds
            shapes = [() if shard_axis in _axes(sp) else tuple(w.shape)
                      for w, sp in zip(leaves, specs)]
            sb = []
            for shape, s in zip(shapes, tree_leaves(states, params)):
                d = shard_dim(shape, n)
                # a whole state leaf (the first call's) becomes its block
                sb.append(s if d is None else map_state(
                    s, lambda x, d=d, shape=shape:
                    block(x, d, r, n).clone() if tuple(x.shape) == shape
                    else x))
            k = len(leaves)
            sharded_step(lambda wb, gb: optimizer._apply(
                wb, gb, sb, [float(lr)] * k, [float(optimizer.wd)] * k,
                [int(t)] * k), leaves, grads, group, n, r,
                full_shapes=shapes)
            states = _rebuild(params, sb)
        else:
            apply(params, _rebuild(params, grads), states, lr, optimizer.wd,
                  t)
        return params, states, loss

    return step


def _dropout_stream(mesh, t, leaves):
    """A step over a mesh draws its dropout masks from a generator of
    ``tensor_parallel.step_seed``: alike across ``tp``, apart across the
    other axes."""
    if mesh is None or not leaves:
        return contextlib.nullcontext()
    from .. import random as _random

    return _random.fork(leaves[0].device, step_seed(
        mesh, t, _random.current_seed()))


def _axes(spec):
    return tuple(a for entry in spec for a in spec_axes(entry))


def _leaf_specs(param_spec, params, leaves, mesh):
    """One spec a leaf: ``param_spec`` is None (all whole), one spec for
    every leaf, or a structure of specs shaped as ``params``. A spec that
    does not fit its leaf's block on ``mesh`` raises."""
    if param_spec is None:
        return [P()] * len(leaves)
    if isinstance(param_spec, P):
        specs = [param_spec] * len(leaves)
    else:
        specs = [P(*s) for s in tree_leaves(param_spec, params)]
    for i, (w, sp) in enumerate(zip(leaves, specs)):
        if len(sp) > w.dim():
            raise ValueError("param_spec %r has more entries than leaf %d "
                             "has dimensions %s" % (sp, i, tuple(w.shape)))
        for a in _axes(sp):
            if a not in mesh.shape:
                raise ValueError("param_spec %r names %r, not an axis of %r"
                                 % (sp, a, mesh))
    return specs


def _scatter_mean(g, spec, mesh):
    """The whole gradient ``g`` reduce-scattered to this rank's block under
    ``spec`` (over each named axis's group in turn, outermost first) and
    divided by the ranks it was summed over: the ranks of an axis other
    than the batch's hold copies of one gradient, so this is their mean."""
    from ..dist.hierarchical import _reduce_scatter

    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            n = int(mesh.shape[a])
            if g.shape[d] % n:
                raise ValueError("dimension %d of %s does not split %d ways"
                                 % (d, tuple(g.shape), n))
            if n > 1:
                x = g.movedim(d, 0).contiguous()
                out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device)
                _reduce_scatter(out, x, group=mesh.group(a))
                g = (out / n).movedim(0, d)
    return g.contiguous()


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


def block_loss_fn(block, loss_block, training=True, out_index=None):
    """A Gluon block and loss as ``loss_fn(param_tensors, batch, key)``
    for :func:`build_train_step`, the mean of the loss over the batch;
    ``param_tensors`` in ``block.collect_params()`` order (returned as
    the second value). ``batch`` is ``(x, y)``, or ``(*inputs, y)`` for a
    block of several inputs; ``out_index`` picks one output of a block
    that returns a tuple (BERT's MLM logits: -1). ``key`` is unused:
    dropout draws from the port's generators. The model reads the
    parameters as :func:`build_train_step` holds them, so the port's
    GPT and BERT split their math over ``tp``."""
    from .. import autograd
    from ..gluon.block import _param_store

    plist = list(block.collect_params().values())

    def loss_fn(param_arrays, batch, key=None):
        *inputs, y = batch
        prev = getattr(_param_store, "params", None)
        _param_store.params = {id(p): a for p, a in zip(plist, param_arrays)}
        try:
            with autograd.record(train_mode=training):
                out = block(*inputs)
                if out_index is not None:
                    out = out[out_index]
                loss = loss_block(out, y)
        finally:
            _param_store.params = prev
        return loss.mean()

    loss_fn._reads_param_blocks = True
    return loss_fn, plist
