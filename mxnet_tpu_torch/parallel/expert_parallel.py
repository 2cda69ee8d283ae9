"""Expert parallelism: switch-style MoE over the ``ep`` mesh axis
(counterpart of ``mxnet_tpu/parallel/expert_parallel.py``).

Top-1 routing with a fixed capacity, dispatch and combine as one-hot
products (the Switch/GShard formulation, the JAX package's
``_moe_local`` line for line), and two all-to-alls over the ``ep`` group
(``distributed.all_to_all``) that carry token slots to their expert's
rank and back.
Each rank holds a block of the tokens and ``E / n`` experts.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import all_to_all

__all__ = ["moe_ffn"]


class _Mean(torch.autograd.Function):
    """The mean over the groups' ranks forward; each rank keeps its own
    cotangent backward (the value is alike on every rank, so each rank's
    gradient is its share, to be averaged over the ranks with the rest of
    its gradients)."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.detach().clone()
        for group, n in groups:
            if n > 1:
                dist.all_reduce(x, group=group)
                x = x / n  # a new tensor, not an in-place op's (cast_out)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _load_balance_loss(probs, onehot, E):
    """The Switch transformer's auxiliary loss: E * sum_e f_e * p_e."""
    f = onehot.float().mean(dim=0)
    p = probs.mean(dim=0)
    return E * (f * p).sum()


def _moe_local(x, router_w, w1, w2, mesh, axis_name, capacity,
               mean_groups):
    t, C = x.shape
    E = router_w.shape[1]
    cap = capacity
    logits = x @ router_w                                   # (t, E)
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)   # the first maximum, as jnp's
    gate = probs.amax(dim=-1)
    # position of each token within its expert's capacity buffer
    onehot = torch.nn.functional.one_hot(expert, E)         # (t, E) int
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < cap
    # dispatch (t, E, cap): token -> (expert, slot), dropped tokens zeroed
    disp = (onehot.to(x.dtype)[:, :, None]
            * torch.nn.functional.one_hot(pos.clamp(0, cap - 1),
                                          cap).to(x.dtype)[:, None, :]
            * keep.to(x.dtype)[:, None, None])
    slots = torch.einsum("tec,td->ecd", disp, x)            # (E, cap, C)
    # this rank's experts' slots from every rank: (e_local, n*cap, C)
    slots = all_to_all(slots, mesh, axis_name, 0, 1)
    h = torch.relu(torch.einsum("esd,edh->esh", slots, w1))
    y = torch.einsum("esh,ehd->esd", h, w2)                 # (e_local, n*cap, C)
    # back to the tokens' ranks: (E, cap, C), experts in global order
    y = all_to_all(y, mesh, axis_name, 1, 0)
    out = torch.einsum("tec,ecd->td", disp, y) * gate[:, None]
    # the Switch aux loss is the global batch's: the mean over every block
    aux = _Mean.apply(_load_balance_loss(probs, onehot, E), mean_groups)
    return out.to(x.dtype), aux


def moe_ffn(x, router_w, w1, w2, mesh, axis_name="ep", capacity_factor=2.0,
            batch_axis=None):
    """x: this rank's block (t, C) of tokens split over ``axis_name`` (and
    over ``batch_axis`` too, ep x dp: each dp replica routes its block
    through its own ep all-to-alls against the dp-replicated experts);
    router_w (C, E), alike on every rank; w1 (E, C, H) and w2 (E, H, C)
    whole (each rank takes its ``E / n`` experts) or already this rank's
    block (E / n, ...). Returns (y (t, C), this rank's block; the aux
    loss, the global batch's mean, alike on every rank)."""
    from .distributed import check_device
    from .mesh import shard_array

    check_device(x, router_w, w1, w2)
    n = int(mesh.shape[axis_name])
    E = router_w.shape[1]
    if E % n:
        raise ValueError("num experts %d must divide the %r axis (%d)"
                         % (E, axis_name, n))
    if w1.shape[0] == E and n > 1:
        w1 = shard_array(w1, mesh, axis_name)
        w2 = shard_array(w2, mesh, axis_name)
    capacity = max(1, int(capacity_factor * x.shape[0] / E))
    mean_groups = [(mesh.group(axis_name), n)]
    if batch_axis is not None:
        mean_groups.append((mesh.group(batch_axis),
                            int(mesh.shape[batch_axis])))
    return _moe_local(x, router_w, w1, w2, mesh, axis_name, capacity,
                      mean_groups)
