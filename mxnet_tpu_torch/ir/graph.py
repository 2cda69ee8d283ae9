"""mxnet_tpu_torch.ir.graph — one typed graph IR under the port's captures
(counterpart of ``mxnet_tpu/ir/graph.py``).

The port had three program caches, each with its own hand-rolled key: the
bulk window's, the ``Executor``'s and the tape's. Each now converts into
the one canonical form here:

* a :class:`Graph` is immutable and typed: nodes carry ``(op, static
  attrs, input wiring)``, values carry interned ``(dtype, shape,
  strides)`` signatures (a program captured on one layout replays only
  on that layout);
* the wiring is the spec-int convention the window already speaks: ``s >=
  0`` is value slot ``s`` (node *i* with ``n_out`` outputs owns ``n_out``
  consecutive slots), ``~li`` is graph leaf ``li`` (a program input);
* :func:`canonicalize` renumbers a capture's graph into a deterministic
  DFS-from-outputs form, and :func:`canonical_key` hashes that form, so
  the same math from the bulk window or a Symbol gets the same key and
  shares one program in ``ir.lower``'s cache, in any process.

Captures: :func:`from_window` (the bulk window at its flush),
:func:`symbol_skeleton` + :func:`from_symbol` (``Symbol.eval``, the
``Executor``'s inference forward, ``SymbolBlock``) and :func:`from_fx`
(the FX graph compiled autograd hands the tape's compiler hook: its key
only, no pass runs on it). :func:`build_runner` runs a graph op by op;
:func:`to_fx` gives it as a ``torch.fx.GraphModule`` to read.

Avals are ``meta`` tensors: an op's output signature is the op run on
meta inputs (``infer_aval_cached``), the port's counterpart of
``jax.eval_shape``. The signature table is capped (MXNET_SIG_INTERN_CAP,
graphlint GL006): ids index a list, so entries are never evicted, and at
the cap a new signature gets None and the capture runs its ops eagerly.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from ..base import OP_REGISTRY, BoundedCache, env_cap

__all__ = ["Node", "Graph", "GraphBuilder", "Canonical", "UnsupportedGraph",
           "canonicalize", "canonical_key", "from_window", "from_symbol",
           "from_fx", "symbol_skeleton", "build_runner", "to_fx",
           "infer_aval_cached", "interner_stats", "sig_value",
           "freeze_attrs"]


# ------------------------------------------------------------- interner
_SIG_IDS = {}
_SIG_LIST = []
_SIG_INTERN_CAP = env_cap("MXNET_SIG_INTERN_CAP", 65536)
# inserts are serialized (two threads interning one fresh signature must
# not both claim len(_SIG_LIST)); a hit is a lock-free dict read
_SIG_LOCK = threading.Lock()


def _sig_id(sig):
    """The interned id of ``sig`` (``(torch.dtype, shape, strides)`` for a
    tensor, the Python type for a scalar leaf), or None at the cap."""
    i = _SIG_IDS.get(sig)
    if i is not None:
        return i
    with _SIG_LOCK:
        i = _SIG_IDS.get(sig)
        if i is None:
            if len(_SIG_IDS) >= _SIG_INTERN_CAP:
                return None
            i = len(_SIG_LIST)
            _SIG_LIST.append(sig)
            _SIG_IDS[sig] = i
        return i


def tensor_sig(t):
    """A tensor's (dtype, shape, strides) signature."""
    return (t.dtype, tuple(t.shape), tuple(t.stride()))


def sig_value(i):
    """The interned signature behind id ``i``."""
    return _SIG_LIST[i]


def interner_stats():
    return {"entries": len(_SIG_IDS), "cap": _SIG_INTERN_CAP}


def _freeze(v):
    """A hashable, process-stable rendering of a static attr."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return (type(v).__name__, v)
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(_freeze(x) for x in v)
    if isinstance(v, (torch.dtype, np.dtype, type)):
        return ("dtype", str(v))
    if isinstance(v, torch.device):
        return ("device", str(v))
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted((str(k), _freeze(x))
                                        for k, x in v.items()))
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu").contiguous().reshape(-1)
        data = t.view(torch.uint8) if t.dtype != torch.bool else t
        return ("tensor", str(v.dtype), tuple(v.shape), hashlib.sha256(
            data.numpy().tobytes()).hexdigest())
    raise TypeError("unhashable static attr of type %s" % type(v).__name__)


def freeze_attrs(attrs):
    """An op's static attrs as the key part both the window and the symbol
    converter build: ``(name, frozen value)`` pairs, sorted."""
    return tuple(sorted((k, _freeze(v)) for k, v in attrs.items()))


# (op, static key, input sig ids) -> (the output's meta tensor, its sig
# id), or None when the op does not run on meta tensors to one tensor.
# Capped (MXNET_AVAL_CACHE_CAP): a miss only runs the op on meta again
_AVAL_CACHE = BoundedCache(env_cap("MXNET_AVAL_CACHE_CAP", 65536))
_AVAL_MISS = object()


def _meta_of(sig):
    if type(sig) is tuple:
        dtype, shape, strides = sig
        return torch.empty_strided(shape, strides, dtype=dtype,
                                   device="meta")
    return sig(1)  # a scalar leaf: only its type can matter


def _infer_aval(fn, kwargs, in_sig_ids):
    from ..ops.cuda import shape_inference
    from ..symbol import _on_device

    ins = [_meta_of(_SIG_LIST[i]) for i in in_sig_ids]
    try:
        with torch.no_grad(), shape_inference(), _on_device(
                torch.device("meta")):
            out = fn(*ins, **kwargs)
    except (RuntimeError, TypeError, ValueError, NotImplementedError,
            IndexError, KeyError, AttributeError, AssertionError):
        return None  # the eager path raises the well-located error
    if not isinstance(out, torch.Tensor):
        return None
    sid = _sig_id(tensor_sig(out))
    return None if sid is None else (out, sid)


def infer_aval_cached(opname, static_key, kwargs, in_sigs, fn=None):
    """Cached (meta output, sig id) of one op application, or None when it
    is not a single tensor on meta inputs."""
    key = (opname, static_key, tuple(in_sigs))
    entry = _AVAL_CACHE.get(key, _AVAL_MISS)
    if entry is _AVAL_MISS:
        entry = _AVAL_CACHE[key] = _infer_aval(
            fn if fn is not None else OP_REGISTRY[opname], kwargs, in_sigs)
    return entry


# ------------------------------------------------------------- the graph


class Node:
    """One typed IR node: a registry op's application.

    ``specs`` wire positional inputs (spec ints); ``kw_names``/``kw_specs``
    wire keyword inputs that are values; ``static`` holds the attrs
    splatted into ``fn`` and ``static_key`` their frozen form. ``n_out``
    slots are produced. ``aval`` (a meta tensor) and ``sig`` describe the
    output when known; passes that need types skip nodes without them.
    ``pinned`` nodes are never merged or bypassed."""

    __slots__ = ("op", "fn", "static", "static_key", "specs", "kw_names",
                 "kw_specs", "n_out", "aval", "sig", "pinned")

    def __init__(self, op, fn, static, static_key, specs, kw_names=(),
                 kw_specs=(), n_out=1, aval=None, sig=None, pinned=False):
        self.op = op
        self.fn = fn
        self.static = static
        self.static_key = static_key
        self.specs = tuple(specs)
        self.kw_names = tuple(kw_names)
        self.kw_specs = tuple(kw_specs)
        self.n_out = n_out
        self.aval = aval
        self.sig = sig
        self.pinned = pinned

    def replace(self, **kw):
        d = {s: getattr(self, s) for s in self.__slots__}
        d.update(kw)
        return Node(**d)

    def ident(self):
        """Structural identity for keys and CSE (``fn`` follows ``op``)."""
        return (self.op, self.static_key, self.specs, self.kw_names,
                self.kw_specs, self.n_out, self.pinned)


class Graph:
    """Immutable typed graph: ``nodes`` in a topological order,
    ``leaf_sigs`` (an interned signature id per program input, None for an
    untyped one), ``outputs`` (spec ints) and ``meta`` (pass notes)."""

    __slots__ = ("nodes", "leaf_sigs", "outputs", "meta")

    def __init__(self, nodes, leaf_sigs, outputs, meta=None):
        self.nodes = tuple(nodes)
        self.leaf_sigs = tuple(leaf_sigs)
        self.outputs = tuple(outputs)
        self.meta = dict(meta or {})

    @property
    def n_nodes(self):
        return len(self.nodes)

    @property
    def n_edges(self):
        return sum(len(n.specs) + len(n.kw_specs) for n in self.nodes)

    def slot_bases(self):
        bases, s = [], 0
        for n in self.nodes:
            bases.append(s)
            s += n.n_out
        return bases

    def slot_owner(self):
        """slot -> (node index, output position)."""
        own = {}
        s = 0
        for i, n in enumerate(self.nodes):
            for j in range(n.n_out):
                own[s] = (i, j)
                s += 1
        return own


class GraphBuilder:
    """Incremental construction shared by the converters: ``leaf`` interns
    a program input (deduped by ``ident``), ``add`` appends a node and
    returns its first slot, ``build`` freezes the result."""

    def __init__(self):
        self.nodes = []
        self.leaf_sigs = []
        self._leaf_ids = {}
        self._nslots = 0

    def leaf(self, ident, sig=None, sig_id=None, untyped=False):
        """Spec int (~li) of a leaf, or None when the interner is at its
        cap. ``untyped=True`` admits a leaf with no signature."""
        li = self._leaf_ids.get(ident)
        if li is None:
            if untyped:
                sid = None
            else:
                sid = sig_id if sig_id is not None else _sig_id(sig)
                if sid is None:
                    return None
            li = self._leaf_ids[ident] = len(self.leaf_sigs)
            self.leaf_sigs.append(sid)
        return ~li

    def add(self, op, fn, static, static_key, specs, kw_names=(),
            kw_specs=(), n_out=1, aval=None, sig=None, pinned=False):
        first = self._nslots
        self.nodes.append(Node(op, fn, static, static_key, specs, kw_names,
                               kw_specs, n_out, aval, sig, pinned))
        self._nslots += n_out
        return first

    @property
    def n_slots(self):
        return self._nslots

    def build(self, outputs, meta=None):
        return Graph(self.nodes, self.leaf_sigs, outputs, meta)


# ------------------------------------------------------- capture: window


def from_window(nodes, key_parts, leaf_sigs, out_slots):
    """A flushed bulk window as a Graph: its creation order is topological
    and its specs are spec ints (every window op has one output, so node
    ``i`` is slot ``i``); ``key_parts[i]`` carries the frozen attrs the
    window built as it deferred. ``leaf_sigs`` are the window's interned
    ids, a tensor's with its device (``(sig id, device)``), and each node
    carries its meta output and its id: the window interned them as it
    deferred, so this is a typed re-wrap, not a walk."""
    return Graph((Node(n.op, n.fn, n.kwargs, kp[1], n.specs, aval=n.meta,
                       sig=n.sig) for n, kp in zip(nodes, key_parts)),
                 (s[0] if type(s) is tuple else s for s in leaf_sigs),
                 out_slots)


# ------------------------------------------------------- capture: symbol

# symbol ops evaluated by dedicated branches (grouping, one output of
# several, control flow, host closures): never one typed node
_SYM_UNSUPPORTED = frozenset(
    ("_group", "_item", "_cond", "_foreach", "_while", "_callable"))


class UnsupportedGraph(Exception):
    """Raised by the converters for graphs the IR cannot represent (control
    flow, random draws, multi-output ops); the caller keeps its own
    path."""


def symbol_skeleton(roots):
    """The structural skeleton of a deterministic Symbol DAG: ``(steps,
    leaf names in first-use order, output specs)``, each step ``(op,
    attrs, static_key, specs)``. Raises :class:`UnsupportedGraph` for a
    node that draws (``symbol._node_is_stochastic``), control flow, a
    multi-output op or an attr that cannot be frozen."""
    from ..symbol import N_OUTPUTS, _node_is_stochastic, _registry

    reg = _registry()
    steps, leaf_names, leaf_pos, memo = [], [], {}, {}
    order, state = [], {}
    for r in roots:  # iterative post-order: export graphs are deep
        stack = [(r, False)]
        while stack:
            s, done = stack.pop()
            if done:
                if state.get(id(s)) != 2:
                    state[id(s)] = 2
                    order.append(s)
                continue
            if id(s) in state:
                continue
            state[id(s)] = 1
            stack.append((s, True))
            for i in reversed(s._inputs):
                if id(i) not in state:
                    stack.append((i, False))
    for s in order:
        if s._op is None:  # a variable: a leaf shared by name
            li = leaf_pos.get(s.name)
            if li is None:
                li = leaf_pos[s.name] = len(leaf_names)
                leaf_names.append(s.name)
            memo[id(s)] = ~li
            continue
        if s._op in _SYM_UNSUPPORTED or s._op in N_OUTPUTS \
                or s._op not in reg:
            raise UnsupportedGraph(s._op)
        if _node_is_stochastic(s):
            raise UnsupportedGraph("%s: draws at run time" % s._op)
        try:
            static_key = freeze_attrs(s._attrs)
        except TypeError as e:
            raise UnsupportedGraph("%s: %s" % (s._op, e))
        specs = tuple(memo[id(i)] for i in s._inputs)
        memo[id(s)] = len(steps)
        steps.append((s._op, s._attrs, static_key, specs))
    return steps, leaf_names, tuple(memo[id(r)] for r in roots)


def from_symbol(skeleton, leaf_sig_ids=None):
    """A typed Graph of a symbol skeleton at the interned signatures of
    the values bound to its leaves; each node's aval comes from the shared
    aval cache. Raises :class:`UnsupportedGraph` when a node does not run
    on meta tensors to one tensor. ``leaf_sig_ids=None`` builds the
    structural form (untyped leaves, no avals)."""
    from ..symbol import _registry

    reg = _registry()
    steps, leaf_names, out_specs = skeleton
    b = GraphBuilder()
    if leaf_sig_ids is None:
        for name in leaf_names:
            b.leaf(name, untyped=True)
        for op, attrs, static_key, specs in steps:
            b.add(op, reg[op], attrs, static_key, specs)
        return b.build(out_specs)
    for name, sid in zip(leaf_names, leaf_sig_ids):
        if b.leaf(name, sig_id=sid) is None:
            raise UnsupportedGraph("signature interner at its cap")
    slot_sigs = []
    for op, attrs, static_key, specs in steps:
        in_sigs = tuple(leaf_sig_ids[~s] if s < 0 else slot_sigs[s]
                        for s in specs)
        entry = infer_aval_cached(op, static_key, attrs, in_sigs, reg[op])
        if entry is None:
            raise UnsupportedGraph("%s: not one tensor on meta inputs" % op)
        av, sid = entry
        b.add(op, reg[op], attrs, static_key, specs, aval=av, sig=sid)
        slot_sigs.append(sid)
    return b.build(out_specs)


# ------------------------------------------------------- capture: FX


def _target_name(target):
    """A process-stable name of an FX call target (an OpOverload renders as
    ``aten.mm.default``; a function as its module and qualified name,
    never its repr, which holds its address)."""
    if isinstance(target, str):
        return target
    if isinstance(target, (torch._ops.OpOverload,
                           torch._ops.OpOverloadPacket)):
        return str(target)
    mod = getattr(target, "__module__", None) or ""
    name = getattr(target, "__qualname__", None) or \
        getattr(target, "__name__", None) or type(target).__qualname__
    return "%s.%s" % (mod, name)


def _fx_static(v, node_ix):
    """An FX argument rendered for the key: a Node as its input position,
    a constant frozen, anything else by its type's qualified name."""
    import torch.fx

    if isinstance(v, torch.fx.Node):
        return ("in", node_ix[v])
    if isinstance(v, (list, tuple)):
        return (type(v).__name__,) + tuple(_fx_static(x, node_ix)
                                           for x in v)
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted((str(k), _fx_static(x, node_ix))
                                        for k, x in v.items()))
    if isinstance(v, slice):
        return ("slice", _fx_static(v.start, node_ix),
                _fx_static(v.stop, node_ix), _fx_static(v.step, node_ix))
    if isinstance(v, (torch.memory_format, torch.layout)):
        return ("enum", str(v))
    try:
        return _freeze(v)
    except TypeError:
        return ("obj", "%s.%s" % (type(v).__module__, type(v).__qualname__))


def _fx_sig(node):
    val = node.meta.get("val", node.meta.get("example_value"))
    if isinstance(val, torch.Tensor):
        return _sig_id(tensor_sig(val))
    return None


def from_fx(gm):
    """An FX ``GraphModule`` (what compiled autograd hands the tape's
    compiler hook) as a Graph: a placeholder is a leaf (typed from its
    example value where the graph has one), a call a node
    whose specs are its FX inputs in order and whose static key renders
    its arguments with those inputs as positions, a ``get_attr`` a node
    keyed by the attribute's value. Only the key and the reading use it: no pass runs on it (it calls hooks and Python
    functions the passes cannot see through)."""
    import torch.fx

    b = GraphBuilder()
    slot = {}
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            sid = _fx_sig(n)
            spec = b.leaf((n.op, n.target), sig_id=sid, untyped=sid is None)
            if spec is None:
                raise UnsupportedGraph("signature interner at its cap")
            slot[n] = spec
        elif n.op == "get_attr":
            # a module attribute is the graph's content: its value is in
            # the key (a constant), not a leaf's signature
            val = gm
            for part in n.target.split("."):
                val = getattr(val, part)
            slot[n] = b.add("get_attr", lambda v=val: v, {},
                            (n.target, _fx_static(val, {})), ())
        elif n.op in ("call_function", "call_method", "call_module"):
            ins = []
            torch.fx.node.map_arg((n.args, n.kwargs), ins.append)
            ins = list(dict.fromkeys(ins))
            node_ix = {x: i for i, x in enumerate(ins)}
            static_key = (n.op, _fx_static(n.args, node_ix),
                          _fx_static(n.kwargs, node_ix))
            slot[n] = b.add(_target_name(n.target), n.target,
                            {"fx_args": n.args, "fx_kwargs": n.kwargs},
                            static_key, tuple(slot[x] for x in ins),
                            sig=_fx_sig(n))
        elif n.op == "output":
            outs = []
            torch.fx.node.map_arg(n.args, outs.append)
            return b.build(tuple(slot[x] for x in outs))
    raise UnsupportedGraph("an FX graph without an output node")


# --------------------------------------------------------- canonical form


class Canonical:
    """:func:`canonicalize`'s result: the canonical graph, ``leaf_perm[j]``
    the original leaf behind canonical leaf ``j``, ``slot_map`` original
    slot -> canonical slot (absent: unreachable, dropped)."""

    __slots__ = ("graph", "leaf_perm", "slot_map", "dropped_nodes")

    def __init__(self, graph, leaf_perm, slot_map, dropped_nodes):
        self.graph = graph
        self.leaf_perm = leaf_perm
        self.slot_map = slot_map
        self.dropped_nodes = dropped_nodes


def canonicalize(graph):
    """Renumber a capture-ordered graph canonically: nodes in DFS
    post-order from the outputs (inputs left to right), leaves by first
    use in that order, unreachable nodes and leaves dropped. The same math
    from any capture converges here."""
    owner = graph.slot_owner()
    nodes = graph.nodes
    order, state = [], {}
    for root in graph.outputs:
        if root < 0:
            continue
        stack = [owner[root][0]]
        while stack:
            ni = stack[-1]
            st = state.get(ni)
            if st == 2:
                stack.pop()
                continue
            if st == 1:
                state[ni] = 2
                order.append(ni)
                stack.pop()
                continue
            state[ni] = 1
            n = nodes[ni]
            for s in reversed(n.specs + n.kw_specs):
                if s >= 0 and state.get(owner[s][0]) is None:
                    stack.append(owner[s][0])
    new_idx = {ni: k for k, ni in enumerate(order)}
    new_bases, s = [], 0
    for ni in order:
        new_bases.append(s)
        s += nodes[ni].n_out
    leaf_perm, leaf_new, slot_map = [], {}, {}

    def remap(spec):
        if spec >= 0:
            ni, j = owner[spec]
            return new_bases[new_idx[ni]] + j
        li = ~spec
        nl = leaf_new.get(li)
        if nl is None:
            nl = leaf_new[li] = len(leaf_perm)
            leaf_perm.append(li)
        return ~nl

    new_nodes = [nodes[ni].replace(
        specs=tuple(remap(s) for s in nodes[ni].specs),
        kw_specs=tuple(remap(s) for s in nodes[ni].kw_specs))
        for ni in order]
    new_outputs = tuple(remap(s) for s in graph.outputs)
    for old, (ni, j) in owner.items():
        if ni in new_idx:
            slot_map[old] = new_bases[new_idx[ni]] + j
    lsigs = tuple(graph.leaf_sigs[li] for li in leaf_perm)
    return Canonical(Graph(new_nodes, lsigs, new_outputs, graph.meta),
                     tuple(leaf_perm), slot_map, len(nodes) - len(order))


def _render_sig(sig):
    """A process-stable rendering of an interned signature (the ids are
    list indices, local to a process)."""
    if sig is None:
        return ("u",)
    if type(sig) is tuple:
        return ("a", str(sig[0]), tuple(sig[1]), tuple(sig[2]))
    return ("s", sig.__name__)


def canonical_key(cgraph):
    """The content-addressed key of a canonical graph: sha256 over op
    names, frozen static attrs, wiring, leaf dtypes, shapes and strides
    and the outputs. Never an ``id()`` or a function's repr: the same
    canonical graph has the same key in every process."""
    payload = ("irv1-torch",
               tuple(n.ident() for n in cgraph.nodes),
               tuple(_render_sig(None if i is None else _SIG_LIST[i])
                     for i in cgraph.leaf_sigs),
               cgraph.outputs)
    return hashlib.sha256(repr(payload).encode()).hexdigest()


# ------------------------------------------------------------- execution


def _call(fn, static, vals, kw):
    if "fx_args" in static:  # an FX call: its own argument structure
        import torch.fx

        it = iter(vals)
        env = {}

        def arg(n):
            if n not in env:
                env[n] = next(it)
            return env[n]

        args, kwargs = torch.fx.node.map_arg(
            (static["fx_args"], static["fx_kwargs"]), arg)
        return fn(*args, **kwargs)
    if kw or static:
        return fn(*vals, **kw, **static)
    return fn(*vals)


def build_runner(graph, device=None):
    """``run(leaf_vals)``: the graph's nodes run in order on the leaves;
    the output tuple. ``device`` is where source ops (``_const``,
    ``_filled``, ``_arange``) make their values (default: the first tensor
    leaf's device, else the CPU)."""
    from ..symbol import _on_device

    steps = [(n.fn, n.static, n.specs, n.kw_names, n.kw_specs, n.n_out)
             for n in graph.nodes]
    outputs = graph.outputs

    def run(lv):
        dev = device or next((v.device for v in lv
                              if isinstance(v, torch.Tensor)), None)
        env = []
        with _on_device(dev):
            for fn, static, specs, kwn, kws, n_out in steps:
                vals = [env[s] if s >= 0 else lv[~s] for s in specs]
                kw = {k: (env[s] if s >= 0 else lv[~s])
                      for k, s in zip(kwn, kws)}
                r = _call(fn, static, vals, kw)
                env.extend(r if n_out != 1 else [r])
        return tuple(env[s] if s >= 0 else lv[~s] for s in outputs)

    return run


def to_fx(graph):
    """The graph as a ``torch.fx.GraphModule`` whose forward takes the
    leaves in order and returns the output tuple: for reading (``print(
    gm.code)``) and for tools that walk FX."""
    import torch.fx

    g = torch.fx.Graph()
    leaves = [g.placeholder("leaf%d" % i) for i in range(len(
        graph.leaf_sigs))]
    env = []

    def val(s):
        return env[s] if s >= 0 else leaves[~s]

    for n in graph.nodes:
        if "fx_args" in n.static:
            it = iter([val(s) for s in n.specs])
            seen = {}

            def arg(x, it=it, seen=seen):
                if x not in seen:
                    seen[x] = next(it)
                return seen[x]

            args, kwargs = torch.fx.node.map_arg(
                (n.static["fx_args"], n.static["fx_kwargs"]), arg)
        else:
            args = tuple(val(s) for s in n.specs)
            kwargs = dict(n.static)
            kwargs.update({k: val(s) for k, s in zip(n.kw_names,
                                                     n.kw_specs)})
        r = g.call_function(n.fn, args, kwargs)
        if n.n_out == 1:
            env.append(r)
        else:
            import operator

            env.extend(g.call_function(operator.getitem, (r, j))
                       for j in range(n.n_out))
    g.output(tuple(val(s) for s in graph.outputs))
    return torch.fx.GraphModule(torch.nn.Module(), g)
