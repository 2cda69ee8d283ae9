"""mxnet_tpu_torch.ir.passes — the rewrite-pass pipeline over the typed IR
(counterpart of ``mxnet_tpu/ir/passes.py``).

Each pass is a ``Graph -> Graph`` rewrite (through :class:`PassManager`;
the lowering layer runs the same passes through a map-tracking
:class:`_Work` so a capture's leaf and slot numbering survives). They run
once per canonical graph, before the program is built, and every capture
lowering the same math shares the result.

Every default pass is exact, so a lowered program gives the op-by-op
chain's bits (the served export's rows and the ``Executor``'s loss are
held to them bit for bit on the card):

* ``cse``       — merge structurally identical subexpressions of
                  deterministic ops (a node that draws is never merged);
* ``fold``      — pre-evaluate constant islands (``_const``/``_filled``/
                  ``_arange`` roots and the math over them) into baked
                  constants, evaluated on the program's own device;
* ``cast_sink`` — identity casts vanish; a lossless widening round trip
                  collapses (bf16 → fp32 → bf16 is the source value;
                  fp32 → bf16 → fp32 rounds, and is never touched);
* ``dce``       — drop nodes and leaves no output depends on.

``donation`` is the JAX package's fifth default pass: not applicable,
because torch has no buffer donation (as graphlint GL005 and hlolint
GL022 record); asking for it raises with that reason.

``quant`` — opt in, not in ``DEFAULT_PASSES``: an fp32 ``dot`` without
transposes or an fp32 ``FullyConnected`` becomes per-channel int8 weights,
an int8 x int8 -> int32 product through the port's int8 route
(``ops.lowbit.lowbit_matmul``: ``torch._int_mm``) and an fp32 rescale. A
one-node rewrite in place: slots and wiring are untouched. It changes
numbers on purpose, so ``ir.tune``'s parity gate keeps it only where it
fires on nothing.

Per-pass node and edge deltas are kept in :data:`PASS_STATS` (fixed keys,
GL006) and mirrored into the observability registry as ``ir_pass_*``
counters.
"""
from __future__ import annotations

import torch

from ..base import OP_REGISTRY, env_cap, resolve_dtype  # noqa: F401
from .graph import Graph, Node, _freeze

__all__ = ["PassManager", "DEFAULT_PASSES", "PASS_STATS", "pass_stats",
           "optimize", "NOT_APPLICABLE"]

_CONST_ROOT_OPS = ("_const", "_filled", "_arange")
# an island above this many elements stays a runtime computation
_FOLD_MAX_ELEMS = env_cap("MXNET_IR_FOLD_MAX_ELEMS", 65536)

_PASS_NAMES = ("cse", "fold", "cast_sink", "dce", "quant")
NOT_APPLICABLE = {
    "donation": "not applicable, because torch has no buffer donation: a "
                "program's inputs are the caller's tensors, which it never "
                "consumes (graphlint GL005, hlolint GL022)"}

PASS_STATS = {name: {"runs": 0, "nodes_removed": 0, "edges_removed": 0,
                     "rewrites": 0} for name in _PASS_NAMES}


def pass_stats():
    return {k: dict(v) for k, v in PASS_STATS.items()}


def _note(name, graph_before, graph_after, rewrites):
    from ..observability import registry

    st = PASS_STATS[name]
    st["runs"] += 1
    dn = graph_before.n_nodes - graph_after.n_nodes
    de = graph_before.n_edges - graph_after.n_edges
    st["nodes_removed"] += max(dn, 0)
    st["edges_removed"] += max(de, 0)
    st["rewrites"] += rewrites
    if dn > 0:
        registry.counter("ir_pass_%s_nodes_removed" % name).inc(dn)
    if de > 0:
        registry.counter("ir_pass_%s_edges_removed" % name).inc(de)
    if rewrites:
        registry.counter("ir_pass_%s_rewrites" % name).inc(rewrites)


class _Work:
    """Mutable pass workspace with capture-map tracking: ``slot_rep``
    collects slot -> spec replacements (CSE merges, cast bypasses),
    ``leaf_back[j]`` is the input graph's leaf behind current leaf ``j``.
    ``device`` is where ``fold`` evaluates."""

    def __init__(self, graph, device=None):
        self.nodes = list(graph.nodes)
        self.leaf_sigs = list(graph.leaf_sigs)
        self.outputs = list(graph.outputs)
        self.meta = dict(graph.meta)
        self.leaf_back = list(range(len(graph.leaf_sigs)))
        self.slot_rep = {}
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.fold_max_elems = _FOLD_MAX_ELEMS
        self._in_slots = sum(n.n_out for n in graph.nodes)
        self._rep_final = False
        self._renumber = None

    def resolve(self, spec):
        if self._rep_final:
            # after a renumber: values are in the final slot space, whose
            # numbers may coincide with stale keys — one step only
            return self.slot_rep.get(spec, spec) if spec >= 0 else spec
        while spec >= 0 and spec in self.slot_rep:
            spec = self.slot_rep[spec]
        return spec

    def graph(self):
        return Graph(self.nodes, self.leaf_sigs, self.outputs, self.meta)

    def finish(self):
        """(final Graph, leaf_sel, slot_fwd): ``leaf_sel[j]`` is the input
        graph's leaf behind final program argument ``j``; ``slot_fwd`` maps
        every input slot to its final spec (None: dead)."""
        slot_fwd = {}
        for s in range(self._in_slots):
            if s in self.slot_rep:
                slot_fwd[s] = self.resolve(s)
            elif self._renumber is not None:
                slot_fwd[s] = self._renumber.get(s)
            else:
                slot_fwd[s] = s
        return self.graph(), tuple(self.leaf_back), slot_fwd


def _bases(nodes):
    bases, owner, s = [], {}, 0
    for i, n in enumerate(nodes):
        bases.append(s)
        for j in range(n.n_out):
            owner[s + j] = i
        s += n.n_out
    return bases, owner


def _apply_reps(work):
    if not work.slot_rep:
        return
    res = work.resolve
    work.nodes = [n.replace(specs=tuple(res(s) for s in n.specs),
                            kw_specs=tuple(res(s) for s in n.kw_specs))
                  for n in work.nodes]
    work.outputs = [res(s) for s in work.outputs]


def _draws(n):
    from ..symbol import STOCHASTIC

    return n.op in STOCHASTIC


def _cse(work):
    """Merge structurally identical nodes of deterministic ops. Pinned
    nodes and nodes that draw are never merged nor a merge target."""
    seen = {}
    rewrites = 0
    bases, _ = _bases(work.nodes)
    for i, n in enumerate(work.nodes):
        if n.pinned or _draws(n):
            continue
        key = (n.op, n.static_key,
               tuple(work.resolve(x) for x in n.specs),
               tuple(work.resolve(x) for x in n.kw_specs),
               n.kw_names, n.n_out)
        first = seen.setdefault(key, i)
        if first != i:
            for j in range(n.n_out):
                work.slot_rep[bases[i] + j] = bases[first] + j
            rewrites += 1
    _apply_reps(work)
    return rewrites


def _evaluate(n, vals, device):
    from ..symbol import _on_device

    with torch.no_grad(), _on_device(device):
        return n.fn(*vals, **n.static) if n.static else n.fn(*vals)


def _fold(work):
    """Baked constants for constant islands: a node is constant when it is
    a root (``_const``/``_filled``/``_arange``, no inputs) or all its
    inputs are constant. A constant read by a non-constant node (or an
    output) becomes an ``_ir_const`` node holding its value on the
    program's device; interior ones die (DCE sweeps them)."""
    bases, _ = _bases(work.nodes)
    const = {}
    for i, n in enumerate(work.nodes):
        if n.pinned or n.n_out != 1 or n.kw_names or _draws(n):
            continue
        ins = [work.resolve(x) for x in n.specs]
        is_root = n.op in _CONST_ROOT_OPS and not n.specs
        if not (is_root or (ins and all(s >= 0 and s in const
                                        for s in ins))):
            continue
        v = _evaluate(n, [const[s] for s in ins], work.device)
        if not isinstance(v, torch.Tensor) or \
                v.numel() > work.fold_max_elems:
            continue
        const[bases[i]] = v
    if not const:
        return 0
    used = set()
    for i, n in enumerate(work.nodes):
        if bases[i] in const:
            continue
        for x in n.specs + n.kw_specs:
            if work.resolve(x) in const:
                used.add(work.resolve(x))
    for s_ in work.outputs:
        if work.resolve(s_) in const:
            used.add(work.resolve(s_))
    rewrites = 0
    for i, n in enumerate(work.nodes):
        sl = bases[i]
        if sl in used and n.op != "_ir_const":
            work.nodes[i] = Node_const(const[sl], n)
            rewrites += 1
    return rewrites


def Node_const(value, like):
    """A baked constant node: ``value`` computed at pass time; a call
    returns it on the device of the run's source ops (a copy made once a
    device, at the program's first run, never inside a capture)."""
    from ..symbol import _source_device

    copies = {value.device: value}

    def _ir_const(*, value=None):
        dev = _source_device()
        t = copies.get(dev)
        if t is None:
            t = copies[dev] = copies[next(iter(copies))].to(dev)
        return t

    return Node("_ir_const", _ir_const, {"value": value},
                (("value", _freeze(value)),), (), aval=like.aval,
                sig=like.sig)


_FLOAT_BITS = {torch.bfloat16: (8, 8), torch.float16: (11, 5),
               torch.float32: (24, 8), torch.float64: (53, 11)}


def _lossless_widen(src, mid):
    """True when casting ``src`` to ``mid`` loses nothing, so a later cast
    from ``mid`` equals one from ``src`` (mantissa and exponent both
    widen; integers widen within a kind, or unsigned into a wider
    signed)."""
    if src == mid:
        return True
    if src in _FLOAT_BITS and mid in _FLOAT_BITS:
        (ms, es), (mm, em) = _FLOAT_BITS[src], _FLOAT_BITS[mid]
        return mm >= ms and em >= es
    if src.is_floating_point or mid.is_floating_point or \
            src == torch.bool or mid == torch.bool:
        return False
    s_signed, m_signed = src.is_signed, mid.is_signed
    s_size, m_size = src.itemsize, mid.itemsize
    return (s_signed == m_signed and m_size >= s_size) or \
        (not s_signed and m_signed and m_size > s_size)


def _cast_sink(work):
    """Exact cast cleanup: ``cast(x, dtype(x))`` -> ``x``;
    ``cast(cast(x, mid), t)`` with a lossless ``x -> mid`` -> ``cast(x,
    t)``. Never bypasses a pinned producer."""
    from .graph import _SIG_LIST

    bases, owner = _bases(work.nodes)

    def producer(spec):
        return work.nodes[owner[spec]] if spec >= 0 else None

    def spec_dtype(spec):
        if spec >= 0:
            n = producer(spec)
            return None if n.aval is None else n.aval.dtype
        sid = work.leaf_sigs[~spec]
        if sid is None:
            return None
        sig = _SIG_LIST[sid]
        return sig[0] if type(sig) is tuple else None

    rewrites = 0
    for i, n in enumerate(work.nodes):
        if n.op != "cast" or n.pinned:
            continue
        src = work.resolve(n.specs[0])
        target = resolve_dtype(n.static.get("dtype"))
        inner = producer(src)
        if inner is not None and inner.op == "cast" and not inner.pinned:
            inner_src = work.resolve(inner.specs[0])
            sdt = spec_dtype(inner_src)
            mid = resolve_dtype(inner.static.get("dtype"))
            if sdt is not None and mid is not None and \
                    _lossless_widen(sdt, mid):
                work.nodes[i] = n.replace(specs=(inner_src,))
                src = inner_src
                rewrites += 1
        sdt = spec_dtype(src)
        if sdt is not None and sdt == target:
            prod = producer(src)
            if prod is None or not prod.pinned:
                work.slot_rep[bases[i]] = src
                rewrites += 1
    _apply_reps(work)
    return rewrites


def _dce(work):
    """Drop nodes and leaves no output uses, renumbering slots and
    leaves."""
    bases, owner = _bases(work.nodes)
    live_nodes, live_leaves = set(), set()
    stack = list(work.outputs)
    while stack:
        sp = stack.pop()
        if sp < 0:
            live_leaves.add(~sp)
            continue
        ni = owner[sp]
        if ni in live_nodes:
            continue
        live_nodes.add(ni)
        n = work.nodes[ni]
        stack.extend(n.specs + n.kw_specs)
    if len(live_nodes) == len(work.nodes) and \
            len(live_leaves) == len(work.leaf_sigs):
        return 0
    kept = [i for i in range(len(work.nodes)) if i in live_nodes]
    new_bases, s = {}, 0
    for i in kept:
        new_bases[i] = s
        s += work.nodes[i].n_out
    leaf_map, new_leaf_sigs, new_leaf_back = {}, [], []
    for li in range(len(work.leaf_sigs)):
        if li in live_leaves:
            leaf_map[li] = len(new_leaf_sigs)
            new_leaf_sigs.append(work.leaf_sigs[li])
            new_leaf_back.append(work.leaf_back[li])

    def remap(spec):
        if spec < 0:
            return ~leaf_map[~spec]
        return new_bases[owner[spec]] + (spec - bases[owner[spec]])

    renumber = {}
    for i in kept:
        for j in range(work.nodes[i].n_out):
            renumber[bases[i] + j] = new_bases[i] + j
    rewrites = len(work.nodes) - len(kept)
    work.nodes = [work.nodes[i].replace(
        specs=tuple(remap(s) for s in work.nodes[i].specs),
        kw_specs=tuple(remap(s) for s in work.nodes[i].kw_specs))
        for i in kept]
    work.outputs = [remap(s) for s in work.outputs]
    work.leaf_sigs = new_leaf_sigs
    work.leaf_back = new_leaf_back
    # flatten the replacement chains in the old slot space, then map them
    # into the final one; from here on resolve() is one step
    flat = {k: work.resolve(k) for k in list(work.slot_rep)}
    work.slot_rep = {
        k: (renumber.get(v, v) if v >= 0
            else (~leaf_map[~v] if ~v in leaf_map else v))
        for k, v in flat.items()}
    work._rep_final = True
    prev = work._renumber
    work._renumber = renumber if prev is None else {
        k: (None if v is None else renumber.get(v)) for k, v in prev.items()}
    return rewrites


def _quant_node_fn(op, orig):
    """The int8 body replacing one fp32 matmul node; ineligible inputs (a
    dtype, rank or attr the rewrite does not cover) run the original."""

    def fn(a, b, *rest, **static):
        from ..ops.lowbit import (_quantize_act, lowbit_matmul,
                                  quantized_fully_connected,
                                  quantize_weight)

        f32 = torch.float32
        if op == "FullyConnected":
            x, w = a, b
            nh = static.get("num_hidden")
            if w.dim() != 2 or w.dtype != f32 or x.dtype != f32 \
                    or (nh is not None and w.shape[0] != nh):
                return orig(a, b, *rest, **static)
            if static.get("flatten", True) and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            bias = rest[0] if rest and rest[0] is not None and \
                not static.get("no_bias", False) else None
            qw, ws = quantize_weight(w, axis=0)
            return quantized_fully_connected(x, qw, ws, bias)
        if static.get("transpose_a") or static.get("transpose_b") \
                or a.dim() != 2 or b.dim() != 2 \
                or a.dtype != f32 or b.dtype != f32:
            return orig(a, b, *rest, **static)
        qb, b_scale = quantize_weight(b, axis=1)  # per output column
        qa, a_scale = _quantize_act(a, None, torch.int8, 127.0, True)
        acc = lowbit_matmul(qa, qb.t().contiguous())
        return acc.to(f32) * (a_scale * b_scale.reshape(-1))

    return fn


def _quant(work):
    """The opt-in int8 matmul rewrite (module docstring): in place, one
    node at a time."""
    rewrites = 0
    for i, n in enumerate(work.nodes):
        if n.pinned or n.kw_names or n.op not in ("dot", "FullyConnected"):
            continue
        if n.op == "dot" and (n.static.get("transpose_a")
                              or n.static.get("transpose_b")):
            continue
        work.nodes[i] = n.replace(op="_quant_" + n.op,
                                  fn=_quant_node_fn(n.op, n.fn))
        rewrites += 1
    return rewrites


_PASS_FNS = {"cse": _cse, "fold": _fold, "cast_sink": _cast_sink,
             "dce": _dce, "quant": _quant}

DEFAULT_PASSES = ("cse", "fold", "cast_sink", "dce")


class PassManager:
    """An ordered pipeline of passes. :meth:`run` is the ``Graph ->
    Graph`` form; :meth:`run_work` the map-tracking form lowering uses.
    Deterministic: the same graph gives the same result and key. The
    config (``passes`` and ``fold_max_elems``) is ``ir.tune``'s search
    space (:meth:`config` / :meth:`from_config`)."""

    def __init__(self, passes=DEFAULT_PASSES, fold_max_elems=None):
        for p in passes:
            if p in NOT_APPLICABLE:
                raise ValueError("IR pass %r: %s" % (p, NOT_APPLICABLE[p]))
        unknown = [p for p in passes if p not in _PASS_FNS]
        if unknown:
            raise ValueError("unknown IR passes %s (have %s)"
                             % (unknown, sorted(_PASS_FNS)))
        self.passes = tuple(passes)
        self.fold_max_elems = (None if fold_max_elems is None
                               else int(fold_max_elems))

    def config(self):
        cfg = {"passes": list(self.passes)}
        if self.fold_max_elems is not None:
            cfg["fold_max_elems"] = self.fold_max_elems
        return cfg

    @classmethod
    def from_config(cls, cfg):
        return cls(passes=tuple(cfg.get("passes", DEFAULT_PASSES)),
                   fold_max_elems=cfg.get("fold_max_elems"))

    def run_work(self, work):
        if self.fold_max_elems is not None:
            work.fold_max_elems = self.fold_max_elems
        for name in self.passes:
            before = work.graph()
            rewrites = _PASS_FNS[name](work)
            _note(name, before, work.graph(), rewrites)
        return work

    def run(self, graph, device=None):
        return self.run_work(_Work(graph, device)).graph()


def optimize(graph, pm=None, device=None):
    """(final Graph, leaf_sel, slot_fwd): the lowering entry point."""
    return (pm or PassManager()).run_work(_Work(graph, device)).finish()
