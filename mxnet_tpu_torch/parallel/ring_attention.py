"""Ring attention: sequence (context) parallelism over the ``sp`` mesh
axis (counterpart of ``mxnet_tpu/parallel/ring_attention.py``).

q, k and v are (B, H, T, D) with T split over ``sp``: each rank holds
its block of T/n positions. K/V blocks rotate around the ring
(``batch_isend_irecv`` to ``(rank + 1) % n``; the next block is in flight
while the current one is computed), so at step i a rank holds the block
of rank ``src = (my - i) % n``, and its queries attend to it:

- ``src == my``, the diagonal block: the flash forward with ``causal``;
- ``src < my``: the flash forward unmasked;
- ``src > my`` under ``causal``: nothing is launched;

each launch with its logsumexp. The partial results merge as they come,
in fp32: out = sum_i exp(lse_i - lse) o_i with lse = logsumexp_i lse_i
(:func:`merge_block`; an lse of -1e30 is an empty block). The backward
runs the ring again: each visited block calls the flash backward with
the *merged* lse and delta = rowsum(dO * O), which gives that block's dq
partial and its dk/dv contributions; the dk/dv accumulators travel with
their K/V block and arrive home after n steps. A rank holds O(T/n * D)
(the JAX package checkpoints its scan body for the same reason).

A block takes the kernels by the attention seam's rule
(``ops.attention.takes_flash``: the dtype, the head dim, whether autograd
records, the whole sequence's length); otherwise, as for an fp32 block
under grad, it takes a dense fp32 step with the same merge. A CPU tensor
takes the kernels' plain versions; a CUDA tensor launches the kernels or
raises.

The per-rank work is :func:`ring_rank_forward` and
:func:`ring_rank_backward`, functions of the rank, the ring length and
the K/V block at each step: :func:`ring_replay` runs every rank's
schedule on one device with no communication (what ``chip_smoke.py``
holds against the whole-sequence kernel).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.cuda import flash_attention as fa
from ..ops.cuda.flash_attention import NEG_INF

__all__ = ["ring_attention", "full_attention", "merge_block",
           "ring_rank_forward", "ring_rank_backward", "ring_replay",
           "shard_sequence", "gather_sequence"]


def merge_block(acc, lse_acc, o, lse):
    """One block's normalized partial ``o`` (B, H, Tq, D) with its ``lse``
    (B, H, Tq) merged into the running ``(acc, lse_acc)`` (None before the
    first block): returns fp32 ``(acc, lse)`` with acc = sum_i exp(lse_i -
    lse) o_i. The first block is taken as it is, so a ring of one gives
    the kernel's output bit for bit."""
    o = o.float()
    if acc is None:
        return o, lse
    new = torch.logaddexp(lse_acc, lse)
    old_empty = lse_acc <= NEG_INF / 2
    empty = lse <= NEG_INF / 2
    w_acc = torch.where(old_empty, 0.0, torch.exp(lse_acc - new))
    w = torch.where(empty, 0.0, torch.exp(lse - new))
    new = torch.where(old_empty & empty, NEG_INF, new)
    return acc * w_acc[..., None] + o * w[..., None], new


def _dense_scores(q, k, causal, scale):
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, -math.inf)
    return s


def _block_forward(q, k, v, causal, scale, flash):
    """(o, lse (B, H, Tq) fp32) of q over one K/V block."""
    if flash:
        o, lse = fa.flash_attention(q, k, v, causal=causal, scale=scale,
                                    return_lse=True)
        return o, lse.reshape(q.shape[:3])
    s = _dense_scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v.float()), lse


def _block_backward(q, k, v, do, lse, delta, causal, scale, flash):
    """(dq, dk, dv) of one block's part of the attention, P rebuilt from
    the merged ``lse``."""
    if flash:
        B, H, Tq, _ = q.shape
        return fa.flash_attention_bwd(
            q, k, v, do, lse.reshape(B * H, Tq, 1).contiguous(),
            delta.contiguous(), scale=scale, causal=causal)
    qs = q.float() * scale
    s = _dense_scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    return dq, dk, dv


def ring_rank_forward(q, steps, my, causal=False, scale=None, flash=False,
                      merge=merge_block):
    """Rank ``my``'s ring forward: ``steps`` yields ``(src, k, v, _)``, the
    K/V block held at each step. Returns (out in q's dtype, the merged lse
    (B, H, Tq) fp32). ``merge`` is :func:`merge_block`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = lse = None
    for src, k, v, _ in steps:
        if causal and src > my:
            continue
        o, l = _block_forward(q, k, v, causal and src == my, scale, flash)
        acc, lse = merge(acc, lse, o, l)
    return acc.to(q.dtype), lse


def ring_rank_backward(q, do, out, lse, steps, my, causal=False, scale=None,
                       flash=False):
    """Rank ``my``'s ring backward: ``steps`` yields ``(src, k, v, (dk,
    dv))``, the K/V block held at each step with the fp32 accumulators
    of its gradients, to which this rank's contributions are added.
    Returns dq in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype).contiguous()
    delta = (out.float() * do.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for src, k, v, acc in steps:
        if causal and src > my:
            continue
        dq_i, dk_i, dv_i = _block_backward(q, k, v, do, lse, delta,
                                           causal and src == my, scale,
                                           flash)
        dq += dq_i.float()
        acc[0].add_(dk_i.float())
        acc[1].add_(dv_i.float())
    return dq.to(q.dtype)


def _ring_steps(ring, k, v, grads=False):
    """This rank's ring steps over ``ring`` (a ``distributed.AxisRing``):
    ``(src, k, v, acc)`` a step, the next K/V block in flight to rank
    ``(i + 1) % n`` while this one is computed; with ``grads``, ``acc`` is
    the block's fp32 (dk, dv) accumulator, which moves with it after each
    step. After the last step the accumulators take one more hop, which
    brings each rank's own block's home: ``ring.home``."""
    n, my = ring.n, ring.index
    acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device)) \
        if grads else None
    for i in range(n):
        pending = ring.post([(k, ring.next), (v, ring.next)],
                            [(k, ring.prev), (v, ring.prev)]) \
            if i < n - 1 else None
        yield (my - i) % n, k, v, acc
        if grads:
            acc = tuple(ring.exchange([(a, ring.next) for a in acc],
                                      [(a, ring.prev) for a in acc]))
        if pending is not None:
            reqs, (k, v) = pending
            for r in reqs:
                r.wait()
    ring.home = acc


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, flash):
        out, lse = ring_rank_forward(q, _ring_steps(ring, k, v), ring.index,
                                     causal, scale, flash)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, causal, scale, flash)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, scale, flash = ctx.args
        dq = ring_rank_backward(q, do, out, lse,
                                _ring_steps(ring, k, v, grads=True),
                                ring.index, causal, scale, flash)
        dk, dv = ring.home
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def _flash_route(q, n, grad):
    from ..ops.attention import takes_flash

    return takes_flash(q, None, False, grad, length=q.shape[2] * n)


def _check_blocks(q, k, v, causal):
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2]:
        raise ValueError("ring attention takes (B, H, T, D) blocks: q %s, "
                         "k %s, v %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal ring attention takes blocks of one length: "
                         "q %d, k %d" % (q.shape[2], k.shape[2]))


def ring_attention(q, k, v, mesh, axis_name="sp", causal=False, scale=None,
                   batch_axis=None):
    """q, k, v: this rank's blocks (B, H, T/n, D) of a sequence split over
    ``axis_name`` on ``mesh`` (``shard_array(x, mesh, None, None, "sp",
    None)``); returns this rank's block of the output. Differentiable: the
    backward is a second ring (see the module docstring). ``batch_axis``
    names the axis the batch is split over as well (dp x sp): each rank's
    blocks are already its batch block, and the ring runs over its own
    ``axis_name`` group, one ring a batch block."""
    from .distributed import AxisRing, check_device

    check_device(q, k, v)
    _check_blocks(q, k, v, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ring = AxisRing(mesh, axis_name)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    return _RingAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), ring, bool(causal),
        float(scale), _flash_route(q, ring.n, grad))


def ring_replay(q, k, v, n, causal=False, scale=None, do=None, flash=None,
                merge=merge_block):
    """Every rank's ring schedule on one device, no communication: q, k, v
    (B, H, T, D) whole, cut into ``n`` blocks of T/n; rank r's step i
    takes block ``(r - i) % n``. Returns (out, lse (B, H, T)), and with
    ``do`` also (dq, dk, dv), each the concatenation of the ranks'
    blocks. ``flash`` defaults to the seam's rule under grad."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if flash is None:
        flash = _flash_route(q, 1, do is not None)
    qs, ks, vs = (list(t.chunk(n, dim=2)) for t in (q, k, v))
    qs, ks, vs = ([c.contiguous() for c in x] for x in (qs, ks, vs))

    def steps(my, accs=None):
        for i in range(n):
            src = (my - i) % n
            yield src, ks[src], vs[src], None if accs is None else accs[src]

    outs, lses = [], []
    for my in range(n):
        o, l = ring_rank_forward(qs[my], steps(my), my, causal, scale, flash,
                                 merge)
        outs.append(o)
        lses.append(l)
    out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
    if do is None:
        return out, lse
    dos = [c.contiguous() for c in do.chunk(n, dim=2)]
    accs = [(torch.zeros(c.shape, dtype=torch.float32, device=c.device),
             torch.zeros(c.shape, dtype=torch.float32, device=c.device))
            for c in ks]
    dqs = [ring_rank_backward(qs[my], dos[my], outs[my], lses[my],
                              steps(my, accs), my, causal, scale, flash)
           for my in range(n)]
    dq = torch.cat(dqs, dim=2)
    dk = torch.cat([a[0] for a in accs], dim=2).to(k.dtype)
    dv = torch.cat([a[1] for a in accs], dim=2).to(v.dtype)
    return out, lse, (dq, dk, dv)


def full_attention(q, k, v, causal=False, scale=None):
    """Whole-sequence attention in fp32 (the reference the tests and
    ``chip_smoke.py`` hold the ring to), in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        T, S = s.shape[-2:]
        keep = torch.ones(T, S, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


class _ShardSeq(torch.autograd.Function):
    """A sequence alike on every rank of the group -> this rank's block;
    the backward gathers every rank's block cotangent (each rank's block
    is the whole cotangent of its positions)."""

    @staticmethod
    def forward(ctx, x, group, my, n):
        ctx.args = (group, n)
        return x.chunk(n, dim=2)[my].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        return _all_gather_seq(g, group, n), None, None, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's block -> the whole sequence on every rank; the
    cotangent is alike on every rank (each computes the same loss), so the
    backward keeps this rank's block of its own copy."""

    @staticmethod
    def forward(ctx, x, group, my, n):
        ctx.args = (my, n)
        return _all_gather_seq(x, group, n)

    @staticmethod
    def backward(ctx, g):
        my, n = ctx.args
        return g.chunk(n, dim=2)[my].contiguous(), None, None, None


def _all_gather_seq(x, group, n):
    if n == 1:
        return x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=2)


def shard_sequence(x, mesh, axis_name="sp"):
    """This rank's block along axis 2 of ``x`` (alike on every rank),
    differentiable."""
    return _ShardSeq.apply(x, mesh.group(axis_name),
                           mesh.local_rank(axis_name),
                           int(mesh.shape[axis_name]))


def gather_sequence(x, mesh, axis_name="sp"):
    """Every rank's block along axis 2, concatenated on every rank,
    differentiable."""
    return _GatherSeq.apply(x, mesh.group(axis_name),
                            mesh.local_rank(axis_name),
                            int(mesh.shape[axis_name]))
