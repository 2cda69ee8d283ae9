"""``tree_optimizer_step`` (counterpart of
``mxnet_tpu/parallel/data_parallel.py``'s): an optimizer lifted to a nested
structure of tensors, for a train step that holds its parameters as a dict
or list rather than as Gluon Parameters. The mesh, the sharding and
``build_train_step`` are ROADMAP.md A.12."""
from __future__ import annotations

import torch

from ..util import tree_leaves

__all__ = ["tree_optimizer_step"]


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
