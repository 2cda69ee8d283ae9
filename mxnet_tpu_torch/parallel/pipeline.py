"""Pipeline parallelism over the ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``): the GPipe forward, Megatron's
interleaved virtual stages, and the 1F1B (PipeDream-flush) training
step.

The JAX package runs every schedule as one ``lax.scan`` over ticks, with
the activations riding a ``ppermute`` ring. Here each rank is a stage (a
process): the schedule's control flow, which depends on nothing but the
counts, is simulated in Python for every stage at once (the JAX
package's tick rules, line for line), and each rank then runs its own
slots, tick by tick, sending activations to ``(stage + 1) % S`` and
cotangents to ``(stage - 1) % S`` with ``batch_isend_irecv``. Every rank
walks the same ticks and knows every send of the tick, so each receive
is posted for a send that happens and the ranks cannot deadlock; a slot
that is idle launches nothing.

Stage parameters are given as the JAX package's stacked leaves
(``stack_stage_params``: a leading stage dimension, alike on every rank);
each rank cuts its own block (its row, or its ``param_spec`` block), and
the gradients come back as that block, as a shard of the JAX package's
sharded result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..util import tree_leaves
from .data_parallel import _rebuild
from .distributed import AxisRing
from .mesh import P, shard_array, use_mesh
from .tensor_parallel import tp_scope

__all__ = ["pipeline_apply", "pipeline_apply_interleaved",
           "pipeline_train_step_1f1b", "stack_stage_params",
           "interleave_stage_params"]


def stack_stage_params(per_stage_params):
    """A list of per-stage structures (same structure and shapes) -> one
    structure whose leaves stack them along a new leading stage axis."""
    first = per_stage_params[0]
    leaves = [tree_leaves(p) for p in per_stage_params]
    return _rebuild(first, [torch.stack(xs) for xs in zip(*leaves)])


def interleave_stage_params(per_stage_params, n_devices):
    """Megatron's virtual chunks: global stage g lives on device
    g % n_devices as its local chunk g // n_devices. Reorders the stages
    so that splitting the stacked leading axis over ``pp`` gives each
    device its chunks in a row: row (d*v + j) = global stage
    (j*n_devices + d)."""
    G = len(per_stage_params)
    if G % n_devices:
        raise ValueError("n_stages %d not divisible by n_devices %d"
                         % (G, n_devices))
    v = G // n_devices
    order = [j * n_devices + d for d in range(n_devices) for j in range(v)]
    return stack_stage_params([per_stage_params[g] for g in order])


def _interleaved_schedule(S, v, n_micro):
    """The JAX package's interleaved tick rules simulated for every device:
    a list over ticks of per-device slots ``(g, mb, injected, done)``
    (None: idle). A slot that is neither done nor on the last global stage
    sends its output to the next device, which runs it the next tick."""
    G = S * v
    ticks = (n_micro - 1) * v + G
    rg, rmb = [-1] * S, [-1] * S
    n_inj = 0
    out = []
    for _ in range(ticks):
        slots, sg, smb = [], [-1] * S, [-1] * S
        for d in range(S):
            ring_valid = rg[d] >= 0
            can_inject = d == 0 and not ring_valid and n_inj < n_micro
            if ring_valid:
                g, mb = rg[d], rmb[d]
            elif can_inject:
                g, mb = 0, n_inj
            else:
                slots.append(None)
                continue
            n_inj += can_inject
            done = g + 1 == G
            slots.append((g, mb, can_inject, done))
            if not done:
                sg[(d + 1) % S], smb[(d + 1) % S] = g + 1, mb
        rg, rmb = sg, smb
        out.append(slots)
    return out


class _Schedule(torch.autograd.Function):
    """The forward schedule of :func:`pipeline_apply_interleaved` on this
    rank, differentiable: the backward walks the ticks in reverse, each
    slot's cotangent coming from the next device (or from the outputs'
    for a microbatch's last stage) and its input's going back to the
    previous device."""

    @staticmethod
    def forward(ctx, stage_fn, ring, sched, v, like, mesh, xs, *leaves):
        S, stage = ring.n, ring.index
        chunks = [[t[j].detach().requires_grad_(True) for t in leaves]
                  for j in range(v)]
        outputs = torch.zeros_like(xs)
        saved = {}
        x_recv = None
        with torch.enable_grad(), use_mesh(mesh):
            for t, slots in enumerate(sched):
                slot = slots[stage]
                send = None
                if slot is not None:
                    g, mb, injected, done = slot
                    x_in = (xs[mb] if injected else x_recv).detach()
                    x_in.requires_grad_(True)
                    y = stage_fn(_rebuild(like, chunks[g // S]), x_in)
                    saved[t] = (x_in, y, g // S)
                    if done:
                        outputs[mb] = y.detach().to(outputs.dtype)
                    else:
                        send = y.detach()
                prev = sched[t][(stage - 1) % S]
                recv = prev is not None and not prev[3]
                got = ring.exchange(
                    [(send, ring.next)] if send is not None else [],
                    [(xs[0], ring.prev)] if recv else [])
                x_recv = got[0] if recv else None
        # the results were written on device (G - 1) % S == S - 1
        if S > 1:
            dist.all_reduce(outputs, group=ring.group)
        ctx.saved = saved
        ctx.leaves, ctx.chunks = leaves, chunks
        ctx.args = (ring, sched, mesh, xs)
        return outputs

    @staticmethod
    def backward(ctx, gout):
        ring, sched, mesh, xs = ctx.args
        S, stage = ring.n, ring.index
        grads = [torch.zeros_like(t) for t in ctx.leaves]
        gxs = torch.zeros_like(xs)
        dx_recv = None
        with use_mesh(mesh):
            for t in range(len(sched) - 1, -1, -1):
                slot = sched[t][stage]
                send = None
                if slot is not None:
                    g, mb, injected, done = slot
                    x_in, y, j = ctx.saved.pop(t)
                    gy = gout[mb] if done else dx_recv
                    got = torch.autograd.grad(y, [x_in] + ctx.chunks[j],
                                              gy.to(y.dtype),
                                              allow_unused=True)
                    dx = torch.zeros_like(x_in) if got[0] is None else got[0]
                    for k, d in enumerate(got[1:]):
                        if d is not None:
                            grads[k][j] += d
                    if injected:
                        gxs[mb] += dx.to(gxs.dtype)
                    else:
                        send = dx.detach()
                # the next device's slot of tick t sends its input's
                # cotangent back when that input came over the ring
                nxt = sched[t][(stage + 1) % S]
                recv = nxt is not None and not nxt[2]
                got = ring.exchange(
                    [(send, ring.prev)] if send is not None else [],
                    [(xs[0], ring.next)] if recv else [])
                dx_recv = got[0] if recv else None
        if S > 1:  # xs is replicated: its cotangent is every stage's sum
            dist.all_reduce(gxs, group=ring.group)
        return (None, None, None, None, None, None, gxs, *grads)


def _run_schedule(stage_fn, stage_params, microbatches, mesh, axis_name,
                  n_virtual):
    ring = AxisRing(mesh, axis_name)
    blocks = [shard_array(t, mesh, axis_name)
              for t in tree_leaves(stage_params)]
    like = _rebuild(stage_params, [b[0] for b in blocks])
    sched = _interleaved_schedule(ring.n, int(n_virtual),
                                  int(microbatches.shape[0]))
    return _Schedule.apply(stage_fn, ring, sched, int(n_virtual), like,
                           mesh, microbatches, *blocks)


def pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                   axis_name="pp"):
    """GPipe forward: ``stage_fn(params, x) -> y`` of the same shape on
    every stage. ``stage_params``: leaves (n_stages, ...), stage s's row
    run by rank s of ``axis_name``; ``microbatches`` (n_micro, mb, ...),
    alike on every rank. Microbatch i enters stage 0 at tick i, over
    n_micro + n_stages - 1 ticks; returns the (n_micro, mb, ...) outputs
    on every rank (summed over ``pp``: the last stage's). Differentiable
    in the parameters and the microbatches."""
    return _run_schedule(stage_fn, stage_params, microbatches, mesh,
                         axis_name, 1)


def pipeline_apply_interleaved(stage_fn, stage_params, microbatches, mesh,
                               n_virtual, axis_name="pp"):
    """Interleaved pipeline forward: each device holds ``n_virtual``
    chunks (global stage g on device g % S, the
    :func:`interleave_stage_params` layout), so every microbatch rides the
    ring v times; a returning wavefront takes priority over a fresh
    injection at device 0. (n_micro - 1) * v + S * v ticks. Returns the
    (n_micro, ...) outputs after all S * v stages on every rank.
    Differentiable."""
    return _run_schedule(stage_fn, stage_params, microbatches, mesh,
                         axis_name, n_virtual)


def _1f1b_schedule(S, n_micro):
    """The JAX package's 1F1B tick rules simulated for every stage: per
    tick and stage ``(f, b, f_send, b_send)``: the microbatch of the
    F-slot and of the B-slot (-1: idle), and whether each slot's result
    goes on (activations to stage + 1, cotangents to stage - 1)."""
    ticks = n_micro + 3 * S + 3
    f_mb, b_mb = [-1] * S, [-1] * S
    n_inj = [0] * S
    n_done = [0] * S
    count = [0] * S
    out = []
    for _ in range(ticks):
        slots, nf, nb = [], [-1] * S, [-1] * S
        for s in range(S):
            last = s == S - 1
            inject = s == 0 and n_inj[s] < n_micro and \
                n_inj[s] - n_done[s] < S
            f_valid = inject if s == 0 else f_mb[s] >= 0
            mbi = min(n_inj[s], n_micro - 1) if s == 0 else max(f_mb[s], 0)
            count[s] += f_valid
            n_inj[s] += inject
            f = mbi if f_valid else -1
            f_send = f_valid and not last
            if f_send:
                nf[(s + 1) % S] = mbi
            b_valid = f_valid if last else b_mb[s] >= 0
            b = (mbi if last else max(b_mb[s], 0)) if b_valid else -1
            count[s] -= b_valid
            n_done[s] += b_valid
            b_send = b_valid and s > 0
            if b_send:
                nb[(s - 1) % S] = b
            slots.append((f, b, f_send, b_send))
        f_mb, b_mb = nf, nb
        out.append(slots)
    return out


def pipeline_train_step_1f1b(stage_fn, loss_fn, stage_params, microbatches,
                             targets, mesh, axis_name="pp",
                             batch_axis=None, param_spec=None):
    """One 1F1B (PipeDream-flush) training step: each microbatch's backward
    starts once the last stage has its forward, so a stage stashes at most
    n_stages + 2 inputs (a B-slot recomputes its forward from the stashed
    input, as the JAX package's ``vjp`` of the stashed ``x`` does).

    ``stage_fn(params, x) -> y`` with ``y.shape == x.shape``;
    ``loss_fn(y, target) -> scalar`` (a microbatch's mean).
    ``stage_params``: leaves (n_stages, ...) (``stack_stage_params``);
    ``microbatches`` (n_micro, mb, ...) and ``targets`` (n_micro, ...),
    alike on every rank. With ``batch_axis`` both are (n_micro, mb, ...)
    and each rank of that axis pipelines its block of every microbatch
    (the loss and the gradients are averaged over it). ``param_spec``: a
    structure of specs leading with ``axis_name`` that also splits the
    stage weights over a tensor axis; ``stage_fn`` then closes its tp
    math itself (``psum_region_entry``/``psum_region_exit``; the mesh is
    entered while it runs), or runs the port's GPT or BERT blocks, which
    split theirs (a ``tensor_parallel.tp_scope`` names the blocks). Returns (the loss, the mean over
    microbatches, and this rank's block of the stacked gradients)."""
    if param_spec is not None:
        # every leaf must split its leading (stage) axis over axis_name, or
        # each rank would run stage 0's weights
        for spec in tree_leaves(param_spec, stage_params):
            if not len(spec) or spec[0] != axis_name:
                raise ValueError(
                    "param_spec leaf %r must lead with %r (the stage dim)"
                    % (spec, axis_name))
        specs = [P(*s) for s in tree_leaves(param_spec, stage_params)]
    else:
        specs = [P(axis_name)] * len(tree_leaves(stage_params))
    ring = AxisRing(mesh, axis_name)
    S, stage = ring.n, ring.index
    last = stage == S - 1
    n_micro = int(microbatches.shape[0])
    if batch_axis is not None:
        microbatches = shard_array(microbatches, mesh, None, batch_axis)
        targets = shard_array(targets, mesh, None, batch_axis)
    live = [shard_array(t, mesh, *sp)[0].detach().requires_grad_(True)
            for t, sp in zip(tree_leaves(stage_params), specs)]
    params = _rebuild(stage_params, live)
    grads = [torch.zeros_like(t) for t in live]
    K = S + 2  # the stash's capacity, as the JAX package's
    stash = [None] * K
    head = count = 0
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    fx = gx = None
    like = microbatches[0]
    # a stage_fn of the port's GPT or BERT blocks splits its math over the
    # tensor axis the specs name (tensor_parallel.tp_scope)
    scope = tp_scope(mesh, [(t, P(*sp[1:])) for t, sp in zip(live, specs)])
    with use_mesh(mesh), scope:
        for slots in _1f1b_schedule(S, n_micro):
            f, b, f_send, b_send = slots[stage]
            sends = []
            if f >= 0:
                x_in = microbatches[f] if stage == 0 else fx
                stash[head % K] = x_in
                head += 1
                count += 1
                if f_send:
                    with torch.no_grad():
                        sends.append((stage_fn(params, x_in), ring.next))
            if b >= 0:
                x_old = stash[(head - count) % K].detach().requires_grad_(
                    True)
                stash[(head - count) % K] = None
                count -= 1
                with torch.enable_grad():
                    y2 = stage_fn(params, x_old)
                    if last:
                        lv = loss_fn(y2, targets[b])
                        seed, = torch.autograd.grad(
                            lv, y2, torch.full_like(lv, 1.0 / n_micro),
                            retain_graph=True)
                        loss_sum = loss_sum + lv.detach().float()
                        gy = seed
                    else:
                        gy = gx
                    got = torch.autograd.grad(y2, [x_old] + live,
                                              gy.to(y2.dtype),
                                              allow_unused=True)
                for acc, d in zip(grads, got[1:]):
                    if d is not None:
                        acc += d
                if b_send:
                    dx = torch.zeros_like(x_old) if got[0] is None \
                        else got[0]
                    sends.append((dx, ring.prev))
            prev = slots[(stage - 1) % S]
            nxt = slots[(stage + 1) % S]
            recvs = []
            if prev[2] and stage > 0:
                recvs.append((like, ring.prev))
            if nxt[3] and stage < S - 1:
                recvs.append((like, ring.next))
            got = ring.exchange(sends, recvs)
            fx = got.pop(0) if prev[2] and stage > 0 else None
            gx = got.pop(0) if nxt[3] and stage < S - 1 else None
    if S > 1:
        dist.all_reduce(loss_sum, group=ring.group)
    loss = loss_sum / n_micro
    if batch_axis is not None and int(mesh.shape[batch_axis]) > 1:
        n = int(mesh.shape[batch_axis])
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.reshape(1)])
        dist.all_reduce(flat, group=mesh.group(batch_axis))
        flat /= n
        off = 0
        for i, g in enumerate(grads):
            grads[i] = flat[off:off + g.numel()].reshape(g.shape).to(
                g.dtype)
            off += g.numel()
        loss = flat[-1]
    return loss, _rebuild(stage_params, [g[None] for g in grads])
