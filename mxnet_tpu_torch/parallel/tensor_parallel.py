"""Tensor parallelism: sharding rules, the Megatron f/g regions, the
split layers and activation constraints (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``).

The JAX package names a placement per parameter and lets XLA's
partitioner split the math and insert the collectives. Here each rank is
a process: a sharded parameter is this rank's block (:func:`shard_params`)
and the regions are explicit ``torch.autograd.Function``s over the axis's
process group, :func:`psum_region_entry` and :func:`psum_region_exit`
(Megatron-LM's ``f`` and ``g``).

``build_train_step(param_spec=)`` and ``pipeline_train_step_1f1b`` run
the model inside a :class:`tp_scope`, which tells the port's GPT and
BERT blocks the mesh and which parameter tensors are blocks under which
spec. A block whose leaves are split as ``TRANSFORMER_RULES`` splits them
computes only its share (Megatron-LM, Shoeybi et al. 2019):

- attention: ``qkv`` column-parallel on this rank's H/n heads (the fused
  weight's block is re-laid into those heads' q, k and v rows by one
  all-to-all, :func:`qkv_head_rows`), the attention seam on (B, H/n, T,
  D), ``attn_out`` row-parallel, its bias added once after the exit;
- the FFN: ``ffn_1`` column-parallel, GELU on the local columns,
  ``ffn_2`` row-parallel;
- a vocabulary-split ``word_embed``: the lookup of the ids inside this
  rank's rows, zero rows elsewhere, summed over the axis
  (:func:`vocab_parallel_embedding`), and the tied head column-parallel
  over the vocabulary (:meth:`tp_scope.vocab_logits`), whose logits
  ``SoftmaxCrossEntropyLoss`` takes through the vocabulary-parallel loss
  (:func:`vocab_parallel_xent`) on the softmax-xent kernels.

A block whose heads (or a leaf's spec) do not allow it reads its split
leaves whole: ``param_value`` all-gathers a registered block
(differentiably; the backward reduce-scatters the gradient and divides by
the ranks it summed, as a replicated gradient's mean). ``counters``
counts both paths a forward and the leaves gathered.

Dropout. The port's draws come from ``random.generator`` of the device.
Inside ``build_train_step`` with a mesh, a step's generator is seeded
from the thread's seed, the step count and the rank's index along every
mesh axis but ``tp`` (:func:`step_seed`): the ranks of one tensor group
draw the same masks for their replicated activations, the ranks of
different data groups different ones.

Every per-rank piece is a function of the rank, the axis size and the
rank's blocks, so ``tp_scope.replay(n, ...)`` runs every rank's share on
one device, summing the parts where the regions sum over the group:
what ``chip_smoke.py`` holds against the unsplit model at full width.
"""
from __future__ import annotations

import re
import threading

import torch
import torch.distributed as dist

from .mesh import P, current_mesh, shard_array, spec_axes

__all__ = ["psum_region_exit", "psum_region_entry", "TRANSFORMER_RULES",
           "FSDP_RULES", "spec_for", "shard_params", "param_specs",
           "constrain", "tp_scope", "current_scope", "counters",
           "reset_counters", "qkv_head_rows", "vocab_parallel_embedding",
           "vocab_parallel_xent", "merge_xent", "step_seed"]


def _axis_group(axis_name, mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("%r names a mesh axis, but no mesh is given or "
                         "entered (parallel.use_mesh)" % (axis_name,))
    return mesh.group(axis_name), int(mesh.shape[axis_name])


def _all_reduce(x, group, n):
    x = x.contiguous().clone()
    if n > 1:
        dist.all_reduce(x, group=group)
    return x


class _RegionExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RegionEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.n), None, None


def psum_region_exit(x, axis_name, mesh=None):
    """Megatron row-parallel exit: the sum over ``axis_name`` forward,
    the identity backward (the ``g`` operator of Megatron-LM fig. 3).

    Every rank of the axis then computes the same (replicated) loss, so
    each keeps its own cotangent copy: an all-reduce backward would
    multiply the gradients upstream by the axis size (and
    ``torch.distributed.nn``'s all-reduce does exactly that). ``mesh``
    defaults to the entered one (``use_mesh``)."""
    group, n = _axis_group(axis_name, mesh)
    return _RegionExit.apply(x, group, n)


def psum_region_entry(x, axis_name, mesh=None):
    """Megatron column-parallel entry: the identity forward, the sum over
    ``axis_name`` backward (the ``f`` operator). The region's input is
    replicated over the axis and each rank's math gives only a partial
    input cotangent, so the true one is their sum."""
    group, n = _axis_group(axis_name, mesh)
    return _RegionEntry.apply(x, group, n)


# BERT/Transformer sharding rules: parameter-name regex -> PartitionSpec.
# Dense weights are (out, in), as in MXNet FullyConnected.
TRANSFORMER_RULES = [
    (r".*(query|key|value|qkv).*weight", P("tp", None)),   # column parallel
    (r".*attn_out.*weight", P(None, "tp")),                # row parallel
    (r".*(query|key|value|qkv).*bias", P("tp")),
    (r".*ffn_1.*weight", P("tp", None)),                   # up-proj column
    (r".*ffn_2.*weight", P(None, "tp")),                   # down-proj row
    (r".*ffn_1.*bias", P("tp")),
    (r".*word_embed.*weight", P("tp", None)),              # vocab sharded
    (r".*embed.*weight", P()),
    (r".*", P()),                                          # default: whole
]

FSDP_RULES = [
    (r".*", "fsdp_largest"),  # the largest dim the 'fsdp' axis divides
]


def spec_for(name, shape, rules, mesh):
    """The spec of the first rule whose pattern matches ``name``; whole
    when that spec does not fit ``shape`` on ``mesh``."""
    for pattern, spec in rules:
        if re.match(pattern, name):
            if spec == "fsdp_largest":
                return _fsdp_spec(shape, mesh)
            if _fits(spec, shape, mesh):
                return spec
            return P()
    return P()


def _fits(spec, shape, mesh):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % mesh.shape[axis] != 0:
            return False
    return True


def _fsdp_spec(shape, mesh):
    n = mesh.shape.get("fsdp", 1)
    if n <= 1:
        return P()
    for dim, s in sorted(enumerate(shape), key=lambda t: -t[1]):
        if s % n == 0:
            spec = [None] * len(shape)
            spec[dim] = "fsdp"
            return P(*spec)
    return P()


def shard_params(named_arrays, mesh, rules=TRANSFORMER_RULES):
    """``[(name, tensor)]`` (the whole values, alike on every rank) -> this
    rank's block of each under its rule's spec. A block carries its whole
    shape as ``_full_shape``."""
    out = []
    for name, a in named_arrays:
        spec = spec_for(name, tuple(a.shape), rules, mesh)
        blk = shard_array(a, mesh, *spec).clone()
        blk._full_shape = tuple(a.shape)
        out.append(blk)
    return out


def param_specs(named_shapes, mesh, rules=TRANSFORMER_RULES):
    return [spec_for(name, tuple(shape), rules, mesh)
            for name, shape in named_shapes]


def constrain(x, *spec):
    """``with_sharding_constraint`` for activations: each rank holds the
    whole value here, so ``x`` comes back as it is; the spec is checked
    against the entered mesh (its axes exist and divide ``x``'s
    dimensions). Without a mesh, nothing is checked."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(spec) > x.dim():
        raise ValueError("constrain: spec %r has more entries than x has "
                         "dimensions %s" % (P(*spec), tuple(x.shape)))
    for d, entry in enumerate(spec):
        n = 1
        for a in spec_axes(entry):
            if a not in mesh.shape:
                raise ValueError("constrain: %r is not an axis of %r"
                                 % (a, mesh))
            n *= int(mesh.shape[a])
        if x.shape[d] % n:
            raise ValueError("constrain: dimension %d of %s does not split "
                             "%d ways" % (d, tuple(x.shape), n))
    return x


# ------------------------------------------------------------ split layers
COLUMN, ROW, VOCAB = P("tp", None), P(None, "tp"), P("tp")

# forwards of a block with split leaves, by path, and the split leaves
# read whole (all-gathered) since the last reset_counters()
counters = {"split": 0, "gathered": 0, "gathered_leaves": 0}


def reset_counters():
    for k in counters:
        counters[k] = 0


_SCOPE = threading.local()


def current_scope():
    """The innermost :class:`tp_scope` entered on this thread, or None."""
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else None


def qkv_head_rows(rows, heads, n, r):
    """The rows of a fused qkv weight of ``rows`` = 3C rows, laid out (3,
    H, D), that hold rank ``r``'s heads ``[r H/n, (r+1) H/n)``: their q,
    k and v rows in that order (a (3C/n,) int64 index)."""
    c, hn = rows // 3, heads // n
    d = c // heads
    one = torch.arange(r * hn * d, (r + 1) * hn * d)
    return torch.cat([one + j * c for j in range(3)])


def _relay_plan(rows, heads, n, me):
    """The all-to-all that turns this rank's contiguous block of the fused
    qkv rows (``P("tp", None)``) into its heads' rows: (the local indices
    to send, in peer order; the count to each peer; the count from each
    peer). Rank s needs :func:`qkv_head_rows` ``(s)``; rank r holds rows
    ``[r L, (r+1) L)``, L = rows / n; ascending rows from the peers in
    order are the needed rows in order."""
    L = rows // n
    send, send_n, recv_n = [], [], []
    need_me = qkv_head_rows(rows, heads, n, me)
    for s in range(n):
        need = qkv_head_rows(rows, heads, n, s)
        mine = need[(need >= me * L) & (need < (me + 1) * L)]
        send.append(mine - me * L)
        send_n.append(int(mine.numel()))
        recv_n.append(int(((need_me >= s * L) & (need_me < (s + 1) * L))
                          .sum()))
    return torch.cat(send), send_n, recv_n


def _a2a(x, out_n, in_n, group):
    out = torch.empty((sum(out_n),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, x.contiguous(), out_n, in_n, group=group)
    return out


class _QkvRelay(torch.autograd.Function):
    """The block of a fused qkv leaf re-laid into this rank's heads' rows
    by one all-to-all; the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, blk, plan, group):
        send, send_n, recv_n = plan
        ctx.plan, ctx.group, ctx.rows = plan, group, blk.shape[0]
        return _a2a(blk.index_select(0, send.to(blk.device)), recv_n,
                    send_n, group)

    @staticmethod
    def backward(ctx, g):
        send, send_n, recv_n = ctx.plan
        back = _a2a(g, send_n, recv_n, ctx.group)
        out = torch.zeros((ctx.rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        out.index_copy_(0, send.to(g.device), back)
        return out, None, None


class _GatherLeaf(torch.autograd.Function):
    """A block all-gathered whole under its spec; the backward
    reduce-scatters the whole gradient back to the block and divides it
    by the ranks it summed (``build_train_step``'s gathered path)."""

    @staticmethod
    def forward(ctx, blk, spec, mesh):
        from ..dist.zero import _whole_shape, gather_spec

        ctx.spec, ctx.mesh = spec, mesh
        full = torch.empty(_whole_shape(blk, spec, mesh), dtype=blk.dtype,
                           device=blk.device)
        gather_spec(full, blk, spec, mesh)
        return full

    @staticmethod
    def backward(ctx, g):
        from .data_parallel import _scatter_mean

        return _scatter_mean(g, ctx.spec, ctx.mesh), None, None


class _GatherLast(torch.autograd.Function):
    """Every rank's block along the last dimension, concatenated in rank
    order. The whole value feeds a loss alike on every rank, so each
    rank's cotangent is the whole one and the backward takes its block."""

    @staticmethod
    def forward(ctx, x, group, n, r):
        ctx.args = (n, r)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.args
        return g.chunk(n, dim=-1)[r].contiguous(), None, None, None


def merge_xent(losses, lses):
    """The vocabulary blocks' (loss_r, lse_r) merged: lse = logsumexp_r
    lse_r, the label's logit = sum_r (lse_r - loss_r) (a block's is 0 but
    in the label's block), loss = lse - that logit. One block is taken as
    it is, so a group of one gives the kernel's loss bit for bit."""
    if len(losses) == 1:
        return losses[0], lses[0]
    lse = torch.logsumexp(torch.stack(lses), dim=0)
    picked = sum(a - b for a, b in zip(lses, losses))
    return lse - picked, lse


class _VocabXent(torch.autograd.Function):
    """Softmax cross-entropy over logits split along the vocabulary: the
    forward kernel on each block with the labels shifted to the block
    (a label outside it picks nothing), the blocks' lse and picked logits
    merged (``merge``), and the backward kernel on each block with the
    merged lse, which gives the block's exact dx."""

    @staticmethod
    def forward(ctx, labels, offsets, merge, *parts):
        from ..ops.cuda.softmax_xent import softmax_xent_fwd

        shifted = [(labels - lo).to(torch.int32) for lo in offsets]
        got = [softmax_xent_fwd(x, lab) for x, lab in zip(parts, shifted)]
        loss, lse = merge([g[0] for g in got], [g[1] for g in got])
        ctx.save_for_backward(lse, *parts, *shifted)
        ctx.n = len(parts)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        from ..ops.cuda import no_second_order
        from ..ops.cuda.softmax_xent import softmax_xent_bwd

        lse, *rest = ctx.saved_tensors
        parts, shifted = rest[:ctx.n], rest[ctx.n:]
        if torch.is_grad_enabled():
            no_second_order("softmax_xent_bwd", parts[0])
        dy = dloss.to(torch.float32).contiguous()
        return (None, None, None) + tuple(
            softmax_xent_bwd(x, lab, lse, dy)
            for x, lab in zip(parts, shifted))


def vocab_parallel_xent(parts, labels, offsets, merge=merge_xent):
    """Per-row NLL (R,) float32 of int labels (R,) (ids of the whole
    vocabulary) under softmax over logits split along the vocabulary:
    ``parts`` the blocks (R, V_r) at ``offsets`` (one a rank, or every
    rank's replayed on one device). ``merge`` combines the blocks' (loss,
    lse) lists (:func:`merge_xent`; a rank's collective merge inside a
    scope)."""
    return _VocabXent.apply(labels.to(torch.int64), list(offsets), merge,
                            *parts)


def vocab_parallel_embedding(F, ids, blocks, offsets, vocab):
    """Rows of a table split along the vocabulary (``blocks`` at
    ``offsets``) for ``ids``, as ``F.Embedding`` of the whole table gives
    them: each block looks up the ids inside it and gives zero rows for
    the rest, and the blocks' rows are summed; an id outside [-V, V)
    gives a NaN row (``jnp.take``'s fill) and a negative one wraps. Not
    summed over ranks here: the caller's exit does that."""
    flat = ids.to(torch.int64)
    valid = (flat >= -vocab) & (flat < vocab)
    flat = torch.where(flat < 0, flat + vocab, flat)
    parts = []
    for blk, lo in zip(blocks, offsets):
        local = flat - lo
        inside = valid & (local >= 0) & (local < blk.shape[0])
        # an id outside the block looks up past its end (a NaN row, no
        # gradient), then is zeroed
        rows = F.Embedding(torch.where(inside, local, blk.shape[0]), blk)
        parts.append(torch.where(inside[..., None], rows, 0.0).to(
            blk.dtype))
    return parts, valid


def step_seed(mesh, t, base):
    """The seed of a ``build_train_step`` step's dropout generator: the
    thread's seed ``base``, the step count ``t`` and this rank's index
    along every axis of ``mesh`` but ``tp``. The ranks of a tensor group
    draw alike; ranks of different data groups do not."""
    idx = 0
    for a in mesh.axis_names:
        if a != "tp":
            idx = idx * int(mesh.shape[a]) + mesh.local_rank(a)
    return ((int(base) * 1000003 + int(t)) * 1000003 + idx) % (2 ** 63)


class tp_scope:
    """The tensor-parallel layout the port's GPT and BERT blocks read
    while the scope is entered (per thread): ``specs`` pairs each split
    leaf tensor, as the model reads it (``param_value``'s store), with its
    spec; ``mesh``'s ``axis_name`` group runs the regions.
    ``tp_scope.replay(n, specs)`` instead takes the whole leaves and runs
    every one of ``n`` ranks' share on this device, summing where the
    regions sum over the group, with no communication."""

    def __init__(self, mesh, specs, axis_name="tp", replay=None):
        self.mesh, self.axis = mesh, axis_name
        self.replayed = replay is not None
        if self.replayed:
            self.n = int(replay)
        else:
            self.n = 1 if mesh is None else int(mesh.shape.get(axis_name,
                                                                1))
        self._leaves = {id(t): (t, P(*sp)) for t, sp in specs
                        if any(spec_axes(e) for e in sp)}
        self._whole = {}
        self._logits = {}

    @classmethod
    def replay(cls, n, specs, axis_name="tp"):
        return cls(None, specs, axis_name, replay=n)

    def __enter__(self):
        stack = getattr(_SCOPE, "stack", None)
        if stack is None:
            stack = _SCOPE.stack = []
        stack.append(self)
        return self

    def __exit__(self, *a):
        _SCOPE.stack.pop()
        self._whole.clear()
        self._logits.clear()

    # ------------------------------------------------------------ layout
    def ranks(self):
        """The ranks whose share this process computes."""
        if self.replayed:
            return list(range(self.n))
        return [self.mesh.local_rank(self.axis) if self.n > 1 else 0]

    def spec(self, t):
        got = self._leaves.get(id(t))
        return got[1] if got is not None and got[0] is t else None

    def splits(self, pairs):
        """True when each (tensor, spec) pair holds: the tensor is a
        registered block under exactly that spec over this scope's axis
        (a spec of None: a leaf that is not split)."""
        for t, want in pairs:
            got = self.spec(t)
            if want is None:
                if got is not None:
                    return False
            elif got is None or tuple(got) != tuple(
                    self.axis if a == "tp" else a for a in want):
                return False
        return True

    def touches(self, tensors):
        return any(self.spec(t) is not None for t in tensors)

    def block(self, t, r, dim):
        """Rank ``r``'s block of leaf ``t`` along ``dim``."""
        if not self.replayed:
            return t
        s = t.shape[dim] // self.n
        return t.narrow(dim, r * s, s)

    def whole(self, t):
        """Leaf ``t`` whole: a registered block all-gathered (once a
        scope, counted), anything else as it is."""
        spec = self.spec(t)
        if spec is None or self.replayed:
            return t
        got = self._whole.get(id(t))
        if got is None:
            got = _GatherLeaf.apply(t, spec, self.mesh)
            self._whole[id(t)] = got
            counters["gathered_leaves"] += 1
        return got

    # ----------------------------------------------------------- regions
    def entry(self, x):
        if self.replayed:
            return x
        return psum_region_entry(x, self.axis, self.mesh)

    def exit(self, parts):
        if self.replayed:
            out = parts[0]
            for p in parts[1:]:
                out = out + p
            return out
        return psum_region_exit(parts[0], self.axis, self.mesh)

    def qkv_rows(self, t, r, heads):
        """Rank ``r``'s heads' q, k and v rows of a fused qkv leaf (its
        block, re-laid by one all-to-all, in a group; whole rows indexed
        in a replay)."""
        if self.n == 1:
            return t
        if self.replayed:
            return t.index_select(0, qkv_head_rows(
                t.shape[0], heads, self.n, r).to(t.device))
        plan = _relay_plan(t.shape[0] * self.n, heads, self.n, r)
        return _QkvRelay.apply(t, plan, self.mesh.group(self.axis))

    def dense_parts(self, F, x, w, b, r, dim):
        """One rank's product with its block of a Dense weight ``w``:
        column-parallel (``dim`` 0: its output columns, with its bias
        block) or row-parallel (``dim`` 1: its input columns, no bias)."""
        return F.FullyConnected(x, self.block(w, r, dim),
                                None if b is None else self.block(b, r, 0),
                                no_bias=b is None, flatten=False)

    # -------------------------------------------------------- vocabulary
    def embed(self, F, ids, w):
        """:func:`vocab_parallel_embedding` over this scope's ranks, closed
        by the exit."""
        vocab = w.shape[0] * (1 if self.replayed else self.n)
        size = vocab // self.n
        ranks = self.ranks()
        parts, valid = vocab_parallel_embedding(
            F, ids, [self.block(w, r, 0) for r in ranks],
            [r * size for r in ranks], vocab)
        out = self.exit(parts)
        return torch.where(valid[..., None], out, float("nan")).to(out.dtype)

    def vocab_logits(self, F, x, w, bias=None, flat=True):
        """The tied head column-parallel over the vocabulary: x (..., C)
        entered, each rank's logits against its rows of ``w`` (``flat``:
        as one (rows, C) product), plus its slice of ``bias`` (V,), a
        replicated leaf entered too, so its gradient sums the ranks'
        slices; returns the whole logits (..., V) (gathered in a group),
        which ``SoftmaxCrossEntropyLoss`` takes through
        :func:`vocab_parallel_xent` on the blocks."""
        xe = self.entry(x)
        if flat:
            xe = F.reshape(xe, shape=(-1, x.shape[-1]))
        if bias is not None:
            bias = self.entry(bias)
        ranks = self.ranks()
        parts = []
        for r in ranks:
            wr = self.block(w, r, 0)
            part = F.dot(xe, F.transpose(wr))
            if bias is not None:
                part = part + bias.narrow(0, r * wr.shape[0], wr.shape[0])
            if flat:
                part = F.reshape(part, shape=tuple(x.shape[:-1]) + (-1,))
            parts.append(part)
        size = parts[0].shape[-1]
        if self.replayed:
            whole = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        elif self.n == 1:
            whole = parts[0]
        else:
            whole = _GatherLast.apply(parts[0], self.mesh.group(self.axis),
                                      self.n, ranks[0])
        self._logits[id(whole)] = (whole, parts, [r * size for r in ranks])
        return whole

    def split_logits(self, t):
        got = self._logits.get(id(t))
        return got[1:] if got is not None and got[0] is t else None

    def xent_merge(self, losses, lses):
        """:func:`merge_xent` of this rank's block with the group's."""
        if self.replayed or self.n == 1:
            return merge_xent(losses, lses)
        group = self.mesh.group(self.axis)
        (loss,), (lse,) = losses, lses
        every = [torch.empty_like(lse) for _ in range(self.n)]
        dist.all_gather(every, lse.contiguous(), group=group)
        picked = (lse - loss).contiguous()
        dist.all_reduce(picked, group=group)
        merged = torch.logsumexp(torch.stack(every), dim=0)
        return merged - picked, merged


def split_scope(leaves, heads=None):
    """The entered scope when a block whose leaves are ``leaves()`` (pairs
    of the tensor it reads and the spec its split form takes, None for a
    leaf it keeps whole; called only inside a scope) computes its share
    over it; None when no scope is entered or none of the leaves is split
    there. A block with split
    leaves that cannot split (another spec, or ``heads`` the axis does
    not divide) reads them whole (``param_value``'s gather) and returns
    None. Each decision is counted in :data:`counters`."""
    scope = current_scope()
    if scope is None:
        return None
    pairs = leaves()
    if not scope.touches([t for t, _ in pairs]):
        return None
    if scope.splits(pairs) and (heads is None or heads % scope.n == 0):
        counters["split"] += 1
        return scope
    counters["gathered"] += 1
    return None


def ffn(x, ffn_1, act, ffn_2):
    """``ffn_2(act(ffn_1(x)))`` of two Dense blocks: inside a scope that
    splits them, ``ffn_1`` column-parallel, ``act`` on each rank's
    columns and ``ffn_2`` row-parallel, its bias added once after the
    exit."""
    from ..gluon.block import param_block, param_value
    from ..ops import F

    scope = split_scope(lambda: [
        (param_block(ffn_1.weight), COLUMN), (param_block(ffn_1.bias), VOCAB),
        (param_block(ffn_2.weight), ROW), (param_block(ffn_2.bias), None)])
    if scope is None:
        return ffn_2(act(ffn_1(x)))
    w1, b1, w2 = (param_block(p) for p in (ffn_1.weight, ffn_1.bias,
                                             ffn_2.weight))
    xe = scope.entry(x)
    out = scope.exit([scope.dense_parts(
        F, act(scope.dense_parts(F, xe, w1, b1, r, 0)), w2, None, r, 1)
        for r in scope.ranks()])
    return out + param_value(ffn_2.bias).to(out.dtype)


def attention(x, qkv, attn_out, heads, attend):
    """``attn_out(attend(qkv(x), heads))`` of two Dense blocks, where
    ``attend(h, H)`` is the model's map of the (B, T, 3 H D) fused q/k/v
    of H heads to the (B, T, H D) attention, or to a tuple of it and more
    outputs (GPT's K/V). Inside a scope that splits the two blocks and
    whose axis divides ``heads``: ``qkv`` column-parallel on each rank's
    H/n heads (its fused rows re-laid, :meth:`tp_scope.qkv_rows`),
    ``attend`` on them, ``attn_out`` row-parallel, its bias added once
    after the exit. Returns the output and the list of each rank's more
    outputs (one entry when unsplit)."""
    from ..gluon.block import param_block, param_value
    from ..ops import F

    def parts_of(got):
        return (got[0], got[1:]) if isinstance(got, tuple) else (got, ())

    scope = split_scope(lambda: [
        (param_block(qkv.weight), COLUMN), (param_block(qkv.bias), VOCAB),
        (param_block(attn_out.weight), ROW),
        (param_block(attn_out.bias), None)], heads)
    if scope is None:
        out, more = parts_of(attend(qkv(x), heads))
        return attn_out(out), [more]
    w, b, wo = (param_block(p) for p in (qkv.weight, qkv.bias,
                                         attn_out.weight))
    xe = scope.entry(x)
    parts, mores = [], []
    for r in scope.ranks():
        h = F.FullyConnected(xe, scope.qkv_rows(w, r, heads),
                             scope.qkv_rows(b, r, heads), flatten=False)
        out, more = parts_of(attend(h, heads // scope.n))
        parts.append(scope.dense_parts(F, out, wo, None, r, 1))
        mores.append(more)
    out = scope.exit(parts)
    return out + param_value(attn_out.bias).to(out.dtype), mores


def xent_rows(pred, label, axis=-1):
    """``SoftmaxCrossEntropyLoss``'s rows through the vocabulary-parallel
    loss when ``pred`` is the entered scope's split logits (along the
    last axis), else None."""
    scope = current_scope()
    if scope is None:
        return None
    got = scope.split_logits(pred)
    if got is None or axis % pred.dim() != pred.dim() - 1:
        return None
    parts, offsets = got
    rows_shape = pred.shape[:-1]
    flat = [p.reshape(-1, p.shape[-1]) for p in parts]
    lab = label.reshape(-1)
    return vocab_parallel_xent(flat, lab, offsets,
                               merge=scope.xent_merge).reshape(rows_shape)
