"""Symbolic graph API (counterpart of ``mxnet_tpu/symbol.py``; ref:
python/mxnet/symbol/symbol.py, the nnvm graph).

A :class:`Symbol` is a node of a DAG over the port's op registry: a
variable (``op`` None), an op with its inputs and attrs (the op's keyword
arguments), ``_group`` (several heads) or ``_item`` (one output of a
multi-output op). Evaluation walks the DAG once, each node once, so a
stochastic node (``Dropout`` in training) draws once per forward however
many nodes read it.

Control flow (``cond``, ``foreach``, ``while_loop``; ref:
python/mxnet/symbol/contrib.py) is the JAX package's: ``_cond``,
``_foreach`` and ``_while`` nodes hold their bodies as Symbol-valued
attrs, which ``tojson`` writes into the same node table
(``{"__sym__": i}``, ``{"__symlist__": [...]}``) and ``loads`` reads back.
A body references the outer graph by variable name; a loop body runs once
a step (``foreach`` over axis 0 of its data; ``while_loop`` a masked scan
of ``max_iterations`` steps that re-evaluates its predicate each step).
A stochastic node a body shares with the outer graph draws once a
forward, before the loop; a node private to a body draws again at each
step (``_shared_stochastic_ids``). ``cond`` runs, and differentiates, the
branch its predicate picks: eagerly the predicate is read on the host;
an :class:`Executor` keys its program on the branches of its graph's
top-level conds, so a captured program holds one branch. It runs the
program of the branches the last forward took (the ``then`` branches at
first), which also returns the predicates it computed, and reads them
(one sync, each read counted in ``engine.cond_host_read_counter``). Where
one picks the other branch, the generator is put back and the forward
runs again with the branches read (``engine.cond_rerun_counter``), so a
predicate is computed once a run and a dropout under it draws the same
mask as the branch it picked. A cond inside a loop body cannot be
captured and raises there.

Shapes: :attr:`Symbol.shape` and :meth:`Symbol.infer_shape` run the
registry ops on ``meta`` tensors (``shape_inference.py``), the port's
counterpart of ``jax.eval_shape``; the kernels' ``torch.library`` ops
answer there through their fake implementations.

Serialization is the JAX package's: the same ``nodes``/``head`` JSON, op
names from the registry and attrs written as Python reprs (``"'float32'"``,
``"True"``, ``"(2, 16, 3, 2, 16)"``) and read back with
``ast.literal_eval``, so a file either package writes loads in the other.

:class:`Executor` is the JAX package's "two programs plus the VJP". On a
CUDA device each (``is_train``, input signature) is captured
(``capture.py``) as a forward CUDA graph and, when some argument takes a
gradient, a backward graph that writes ``grad_dict`` under ``grad_req``;
the device's generator is registered with the graphs, so each replay draws
new dropout masks. The arguments are copied into the programs' static
inputs at each forward. On the CPU the same keys run eagerly, with the
same counts. ``is_train`` sets ``training`` on every op that reads it and
does not pin it (``_with_training``).

A ``_callable`` node (``autograd.get_symbol``'s recorded history) runs a
host function; it evaluates, binds and differentiates like any node and
``tojson`` refuses it.
"""
from __future__ import annotations

import ast
import copy
import json
import threading
from collections import OrderedDict

import numpy as np
import torch

from .base import OP_REGISTRY, resolve_device, resolve_dtype
from .ndarray import NDArray

__all__ = ["Symbol", "var", "Variable", "Group", "load", "loads", "Executor",
           "cond", "foreach", "while_loop"]

# the registry ops that return several outputs, and how many (a copy of the
# JAX registry's ``n_outputs``; every other op returns one)
N_OUTPUTS = {
    "BatchNorm": 3, "batch_norm": 3, "BatchNorm_v1": 3, "batch_norm_v1": 3,
    "multibox_target": 3, "bipartite_matching": 2, "quant_cache_write": 2,
    "quant_cache_write_read": 3, "moments": 2, "linalg_slogdet": 2,
    "linalg_gelqf": 2, "linalg_syevd": 2, "_sample_multinomial_prob": 2,
    "sgd_mom_update": 2, "adam_update": 3, "lamb_update_phase1": 3,
    "mp_lamb_update_phase1": 3, "mp_lamb_update_phase2": 2,
    "rmsprop_update": 2, "signum_update": 2, "ftrl_update": 3,
    "mp_sgd_update": 2, "mp_sgd_mom_update": 3, "nag_mom_update": 2,
    "mp_nag_mom_update": 3, "ftml_update": 4, "rmspropalex_update": 4,
    "RNN": 3, "contrib_quantize": 2}
# the registry ops that draw random numbers (the JAX registry's
# ``needs_rng``); Dropout only in training
STOCHASTIC = frozenset((
    "Dropout", "dropout", "RNN", "_sample_multinomial_prob", "exponential",
    "normal", "poisson", "random_exponential", "random_gamma",
    "random_generalized_negative_binomial", "random_negative_binomial",
    "random_normal", "random_poisson", "random_randint", "random_uniform",
    "sample_exponential", "sample_gamma", "sample_multinomial",
    "sample_normal", "sample_poisson", "sample_uniform", "shuffle",
    "uniform"))


def _registry():
    from . import ops  # noqa: F401  (fills the registry)

    return OP_REGISTRY


class Symbol:
    def __init__(self, op=None, inputs=(), attrs=None, name=None, shape=None,
                 dtype=None, out_index=None, n_outputs=1):
        self._op = op  # a registry op, None (variable), "_group"
        self._inputs = list(inputs)
        self._attrs = dict(attrs or {})  # the op's keyword arguments
        self._annotations = {}  # AttrScope attributes: never executed
        if name is None:
            from . import name as _name_mod

            name = _name_mod.current().get(None, op if op else "var")
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = resolve_dtype(dtype)
        self._out_index = out_index
        self._n_outputs = n_outputs

    # ------------------------------------------------------------- structure
    def is_var(self):
        return self._op is None

    def _arg_symbols(self):
        """The free variables, depth first, one per name."""
        seen, out = set(), OrderedDict()
        stack = [self]
        order = []
        while stack:  # iterative depth-first, inputs in order
            s = stack.pop()
            if id(s) in seen:
                continue
            seen.add(id(s))
            order.append(s)
            stack.extend(reversed(s._inputs))
        for s in order:
            if s.is_var():
                out.setdefault(s.name, s)
        return list(out.values())

    def list_arguments(self):
        """The free variables' names, depth first (ref:
        symbol.py:list_arguments)."""
        return [s.name for s in self._arg_symbols()]

    def list_outputs(self):
        if self._op == "_group":
            return [i.name + "_output" for i in self._inputs]
        return [self.name + "_output"]

    def get_internals(self):
        return self

    def __getitem__(self, index):
        if self._op == "_group":
            return self._inputs[index]
        return Symbol("_item", [self], {"index": index},
                      name="%s%d" % (self.name, index))

    def attr(self, key):
        """An op kwarg, else a scope annotation (the node wins)."""
        if key in self._attrs:
            return self._attrs[key]
        return self._annotations.get(key)

    # ---------------------------------------------- tensor-like, for models
    def contiguous(self):
        """A graph value has no layout: the same symbol, no node."""
        return self

    @property
    def device(self):
        """A graph value lies on no device (``ctx=x.device`` in a model's
        trace reaches ``sym.arange``, which ignores it)."""
        return None

    def reshape(self, *shape):
        """A ``reshape`` node (a model's ``x.reshape(T * N, H)``)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _make("reshape", self, shape=tuple(shape))

    def t(self):
        """A ``transpose`` node of a matrix (a model's ``w.t()``)."""
        return _make("transpose", self)

    # ------------------------------------------------------------- build ops
    def __add__(self, o):
        return _make("add", self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return _make("subtract", self, o)

    def __rsub__(self, o):
        return _make("subtract", o, self)

    def __mul__(self, o):
        return _make("multiply", self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _make("divide", self, o)

    def __rtruediv__(self, o):
        return _make("divide", o, self)

    def __pow__(self, o):
        return _make("power", self, o)

    def __neg__(self):
        return _make("negative", self)

    def __lt__(self, o):
        return _make("lesser", self, o)

    def __le__(self, o):
        return _make("lesser_equal", self, o)

    def __gt__(self, o):
        return _make("greater", self, o)

    def __ge__(self, o):
        return _make("greater_equal", self, o)

    __hash__ = object.__hash__

    # ------------------------------------------------------------- evaluate
    def _meta_out(self):
        """This node's output on ``meta`` tensors, from the variables'
        declared shapes (memoized on each node)."""
        from .shape_inference import meta_eval

        return meta_eval(self)

    @property
    def shape(self):
        """The output's shape, inferred through the graph when every
        variable it reads declares a shape (``var(name, shape=...)``)."""
        if self._shape is not None:
            return self._shape
        if self.is_var():
            raise ValueError(
                "shape of variable %r unknown — declare it: var(%r, "
                "shape=...)" % (self.name, self.name))
        out = self._meta_out()
        if isinstance(out, (list, tuple)):
            out = out[self._out_index or 0]
        self._shape = tuple(out.shape)
        return self._shape

    def eval(self, ctx=None, **kwargs):
        """The outputs as NDArrays for the variables' values in
        ``kwargs`` (a walk of the graph, eagerly)."""
        feed = {}
        for n in self.list_arguments():
            if n not in kwargs:
                raise KeyError("unbound variable %s" % n)
            v = kwargs[n]
            feed[n] = v._data if isinstance(v, NDArray) else \
                torch.as_tensor(np.asarray(v))
        with torch.no_grad():
            out = _eval_symbols(_heads(self), feed)
        return [NDArray(o) for o in out]

    def infer_shape(self, **kwargs):
        """(argument shapes, output shapes, auxiliary shapes) from the given
        input shapes; parameter variables need no declared shape, per-op
        rules deduce them (ref: nnvm InferShape; ``shape_inference.py``)."""
        from .shape_inference import format_infer_errors, infer_shapes_partial

        known = {n: tuple(s) for n, s in kwargs.items()}
        var_shapes, out, errors = infer_shapes_partial(self, known)
        names = self.list_arguments()
        missing = [n for n in names if var_shapes.get(n) is None]
        if missing:
            raise ValueError("shape of %s could not be inferred%s"
                             % (missing, format_infer_errors(errors)))
        outs = out if isinstance(out, list) else [out]
        if any(o is None for o in outs):
            raise ValueError("output shape could not be inferred%s"
                             % format_infer_errors(errors))
        return ([var_shapes[n] for n in names], [tuple(o) for o in outs], [])

    def infer_type(self, **kwargs):
        """(argument dtypes, output dtypes, auxiliary dtypes) as numpy
        types; arguments not given are float32, as in the JAX package."""
        from .shape_inference import infer_types

        return infer_types(self, kwargs)

    # ------------------------------------------------------------- binding
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Allocate zero arguments (and gradients unless ``grad_req`` is
        ``"null"``) and bind. Shapes not given are inferred from the given
        ones (ref: symbol.py:simple_bind)."""
        device = resolve_device(ctx)
        names = self.list_arguments()
        if any(shapes.get(n) is None for n in names):
            arg_shapes, _, _ = self.infer_shape(
                **{n: s for n, s in shapes.items() if s is not None})
            shapes = dict(zip(names, arg_shapes))
        types = dict(type_dict or {})
        args = {n: NDArray(torch.zeros(
            shapes[n], dtype=resolve_dtype(types.get(n)) or torch.float32,
            device=device)) for n in names}
        grads = None if grad_req == "null" else {
            n: NDArray(torch.zeros_like(a._data)) for n, a in args.items()}
        return Executor(self, device, args, grads, grad_req)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             **kwargs):
        names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        args = {n: v if isinstance(v, NDArray) else NDArray(v)
                for n, v in (args or {}).items()}
        device = resolve_device(ctx) if ctx is not None else (
            next(iter(args.values()))._data.device if args else None)
        return Executor(self, device, args, args_grad, grad_req)

    def tojson(self):
        """The JAX package's graph JSON (ref: nnvm SaveJSON): inputs, then
        subgraph attrs, before each node; attrs as Python reprs."""
        nodes, index = [], {}
        for s in _topo_all(self):
            if s._op == "_callable":
                raise ValueError(
                    "symbol %r wraps a host closure (autograd.get_symbol "
                    "tape capture) and cannot be serialized to json; "
                    "rebuild the graph with symbol ops to save it" % s.name)
            attrs = {}
            for k, v in s._attrs.items():
                if isinstance(v, Symbol):
                    attrs[k] = {"__sym__": index[id(v)]}
                elif isinstance(v, list) and any(isinstance(e, Symbol)
                                                 for e in v):
                    attrs[k] = {"__symlist__": [index[id(e)] for e in v]}
                else:
                    attrs[k] = repr(_jsonable(v))
            node = {"op": s._op or "null", "name": s.name, "attrs": attrs,
                    "shape": list(s._shape) if s._shape else None,
                    "inputs": [index[id(i)] for i in s._inputs]}
            if s._annotations:
                node["annotations"] = dict(s._annotations)
            index[id(s)] = len(nodes)
            nodes.append(node)
        return json.dumps({"nodes": nodes, "head": len(nodes) - 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        return "<Symbol %s>" % self.name


def _jsonable(v):
    """An attr as the JAX package writes it: dtypes by name."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, np.dtype):
        return v.name
    return v


def _topo(root):
    """Every node reachable from ``root``, inputs before users, in the
    order a depth-first walk over inputs in order visits them."""
    order, state = [], {}
    stack = [(root, False)]
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
    return order


def _attr_symbols(attrs):
    """The Symbol-valued attrs of a node (a control-flow body), lists
    included, in attr order."""
    for v in attrs.values():
        if isinstance(v, Symbol):
            yield v
        elif isinstance(v, list):
            for e in v:
                if isinstance(e, Symbol):
                    yield e


def _topo_all(root):
    """``_topo`` over inputs and then control-flow bodies: every node
    reachable either way, each after its inputs and bodies (the order the
    JAX package's ``tojson`` writes)."""
    order, state = [], {}
    stack = [(root, False)]
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
        for i in reversed(list(s._inputs) + list(_attr_symbols(s._attrs))):
            if id(i) not in state:
                stack.append((i, False))
    return order


def _heads(sym):
    return list(sym._inputs) if sym._op == "_group" else [sym]


def _node_is_stochastic(sym):
    """Does this node draw at run time? A random op, or a training-gated
    one whose ``training`` attr is on."""
    if sym._op not in STOCHASTIC:
        return False
    fn = OP_REGISTRY.get(sym._op)
    if getattr(fn, "needs_training", False) and not sym._attrs.get(
            "training", False):
        return False
    return True


def _graph_has_rng(sym):
    return any(_node_is_stochastic(s) for s in _topo_all(sym))


def _shared_stochastic_ids(roots):
    """Ids of the nodes reachable from more than one region: the outer
    graph (every root, through inputs, stopping at bodies) and each
    control-flow body (a cond branch, a loop's subgraphs; nested bodies
    are regions of their own). Of these, the stochastic ones draw once a
    forward, before the control flow that reads them."""
    subgraphs, owners = [], set()

    def walk(s, acc, seen):
        stack = [s]
        while stack:
            s = stack.pop()
            if id(s) in seen:
                continue
            seen.add(id(s))
            acc.add(id(s))
            if id(s) not in owners and s._op in _CONTROL_FLOW:
                owners.add(id(s))
                if s._op == "_cond":
                    subgraphs.append([s._attrs["then_sym"]])
                    subgraphs.append([s._attrs["else_sym"]])
                else:
                    subgraphs.append(list(_attr_symbols(s._attrs)))
            stack.extend(s._inputs)

    regions, main, seen = [], set(), set()
    for r in roots:
        walk(r, main, seen)
    regions.append(main)
    i = 0
    while i < len(subgraphs):  # a walk may find nested bodies
        acc, seen = set(), set()
        for b in subgraphs[i]:
            walk(b, acc, seen)
        regions.append(acc)
        i += 1
    counts = {}
    for r in regions:
        for nid in r:
            counts[nid] = counts.get(nid, 0) + 1
    return frozenset(nid for nid, n in counts.items() if n > 1)


def _shared_for(outputs):
    """``_shared_stochastic_ids`` of ``outputs``, memoized on the first
    output (which outlives the memo)."""
    if not outputs:
        return frozenset()
    key = tuple(id(o) for o in outputs)
    memo = outputs[0].__dict__.get("_shared_memo")
    if memo is not None and memo[0] == key:
        return memo[1]
    shared = _shared_stochastic_ids(outputs)
    outputs[0]._shared_memo = (key, shared)
    return shared


def _eval(sym, env, cache, shared=frozenset()):
    """The value of ``sym`` for the variables' values in ``env``, each node
    evaluated once (``cache`` by node id); ``shared``: the nodes the outer
    graph shares with control-flow bodies (``_shared_stochastic_ids``)."""
    for s in _topo(sym):
        if id(s) in cache:
            continue
        if s.is_var():
            if s.name not in env:
                raise KeyError("unbound variable %s" % s.name)
            val = env[s.name]
        elif s._op == "_group":
            val = [cache[id(i)] for i in s._inputs]
        elif s._op == "_item":
            parent = cache[id(s._inputs[0])]
            idx = s._attrs["index"]
            if not isinstance(parent, (list, tuple)) and idx != 0:
                raise ValueError(
                    "symbol output %d requested but %r produced a single "
                    "output with these attributes" % (idx,
                                                      s._inputs[0]._op))
            val = parent[idx] if isinstance(parent, (list, tuple)) \
                else parent
        elif s._op in _CONTROL_FLOW:
            val = _CONTROL_FLOW[s._op](
                s._attrs, [cache[id(i)] for i in s._inputs], env, cache,
                shared, s)
        elif s._op == "_callable":
            val = s._attrs["fn"](*[cache[id(i)] for i in s._inputs])
        else:
            fn = _registry()[s._op]
            val = fn(*[cache[id(i)] for i in s._inputs], **s._attrs)
        cache[id(s)] = val
    return cache[id(sym)]


def _eval_symbols(outputs, feed):
    """The outputs' values, flattened, in one walk (a node shared by two
    outputs evaluates, and draws, once); source ops on the device of the
    fed tensors."""
    device = next((v.device for v in feed.values()
                   if isinstance(v, torch.Tensor)), None)
    shared = _shared_for(outputs)
    cache, outs = {}, []
    with _on_device(device):
        for s in outputs:
            o = _eval(s, feed, cache, shared)
            outs.extend(o if isinstance(o, list) else [o])
    return outs


# ----------------------------------------------------------- control flow

def _hoist_shared_draws(roots, env, cache, shared):
    """Evaluate into the outer cache the stochastic nodes of ``roots`` (a
    body's subgraphs) that the outer graph shares: one draw a forward,
    whichever evaluates them first."""
    for r in roots:
        for n in _topo_all(r):
            if id(n) in shared and _node_is_stochastic(n) \
                    and id(n) not in cache:
                _eval(n, env, cache, shared)


def _steps(n, first):
    """How many loop steps to run: one on ``meta`` tensors (shape
    inference; every step has the first's shapes), else ``n``."""
    return 1 if first.device.type == "meta" else n


def _stacked(outs, n):
    if len(outs) == n:
        return torch.stack(outs)
    return outs[0].unsqueeze(0).expand((n,) + tuple(outs[0].shape))


def _foreach_eval(a, ins, env, cache, shared, node=None):
    """(ref: control_flow.cc:foreach) ``out_sym`` and ``state_syms`` once a
    step over axis 0 of the data: [stacked outputs, *final states]."""
    n = a["n_states"]
    data, states, free = ins[0], list(ins[1:1 + n]), ins[1 + n:]
    free_env = dict(zip(a["free_names"], free))
    out_sym, state_syms = a["out_sym"], a["state_syms"]
    _hoist_shared_draws([out_sym] + list(state_syms), env, cache, shared)
    T = data.shape[0]
    outs = []
    for t in range(_steps(T, data)):
        senv = {a["slice_name"]: data[t],
                **dict(zip(a["state_names"], states)), **free_env}
        sc = dict(cache)
        outs.append(_eval(out_sym, senv, sc, shared))
        states = [_eval(s, senv, sc, shared) for s in state_syms]
    return [_stacked(outs, T)] + states


def _while_eval(a, ins, env, cache, shared, node=None):
    """(ref: control_flow.cc:while_loop) The JAX package's masked scan of
    ``max_iterations`` steps: each step re-evaluates the predicate, keeps
    the loop vars where it is false and emits zeros there."""
    n = a["n_vars"]
    vs, free = list(ins[:n]), ins[n:]
    free_env = dict(zip(a["free_names"], free))
    pred_sym, out_sym, var_syms = a["pred_sym"], a["out_sym"], a["var_syms"]
    _hoist_shared_draws([pred_sym, out_sym] + list(var_syms), env, cache,
                        shared)
    steps = a["max_iterations"]
    outs = []
    for _ in range(_steps(steps, vs[0])):
        senv = {**dict(zip(a["var_names"], vs)), **free_env}
        sc = dict(cache)
        pred = _eval(pred_sym, senv, sc, shared).reshape(()).to(torch.bool)
        o = _eval(out_sym, senv, sc, shared)
        new = [_eval(s, senv, sc, shared) for s in var_syms]
        vs = [torch.where(pred, nv, v) for nv, v in zip(new, vs)]
        outs.append(torch.where(pred, o, torch.zeros_like(o)))
    return [_stacked(outs, steps)] + vs


def _decided_branch(pred, node):
    """Which branch a cond takes: ``then`` on meta tensors (shapes), the
    executor's decision for its node, else the predicate read on the host
    (counted); inside a CUDA graph capture with no decision it raises."""
    from . import engine

    if pred.device.type == "meta":
        return True
    decided = (getattr(_where, "decisions", None) or {}).get(id(node))
    if decided is not None:
        return decided
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "cond %r: its predicate is not known before the capture (a cond "
            "inside a loop body cannot be captured)"
            % getattr(node, "name", "cond"))
    engine.cond_host_read_counter.count += 1
    return bool(pred.reshape(()).item())


def _cond_eval(a, ins, env, cache, shared, node=None):
    """(ref: control_flow.cc:cond) The branch the predicate picks, alone:
    it alone runs and takes gradient."""
    benv = dict(zip(a["arg_names"], ins[1:]))
    then_sym, else_sym = a["then_sym"], a["else_sym"]
    _hoist_shared_draws([then_sym, else_sym], {**env, **benv}, cache,
                        shared)
    branch = then_sym if _decided_branch(ins[0], node) else else_sym
    return _eval(branch, benv, dict(cache), shared)


_CONTROL_FLOW = {"_cond": _cond_eval, "_foreach": _foreach_eval,
                 "_while": _while_eval}


class _decisions:
    """The cond decisions (node id → bool) an executor read for a forward,
    while its program runs or is captured."""

    def __init__(self, decisions):
        self._d = decisions

    def __enter__(self):
        self._prev = getattr(_where, "decisions", None)
        _where.decisions = self._d

    def __exit__(self, *exc):
        _where.decisions = self._prev


def _substitute(outputs, mapping):
    """``outputs`` rebuilt with the free variables named in ``mapping``
    replaced by the mapped symbols (a SymbolBlock spliced into an enclosing
    trace); parameter variables stay free."""
    memo = {}
    for root in outputs:
        for s in _topo(root):
            if id(s) in memo:
                continue
            if s.is_var():
                out = mapping.get(s.name, s)
            else:
                new_ins = [memo[id(i)] for i in s._inputs]
                if all(n is o for n, o in zip(new_ins, s._inputs)):
                    out = s
                else:
                    out = Symbol(s._op, new_ins, s._attrs, name=s.name,
                                 shape=s._shape, dtype=s._dtype,
                                 out_index=s._out_index,
                                 n_outputs=s._n_outputs)
                    out._annotations = dict(s._annotations)
            memo[id(s)] = out
    return [memo[id(s)] for s in outputs]


def _make(op, *args, name=None, **attrs):
    """An op node over ``args`` (Symbols; a number becomes a ``_const``
    node), named by the current NameManager, annotated by the current
    AttrScope."""
    from . import attribute as _attr_mod
    from . import name as _name_mod

    inputs = []
    for a in args:
        if a is None:
            continue
        if isinstance(a, Symbol):
            inputs.append(a)
        else:
            inputs.append(Symbol("_const", [], {"value": float(a)},
                                 name="const"))
    if name is None:
        name = _name_mod.current().get(None, op.lower())
    s = Symbol(op, inputs, attrs, name=name)
    s._annotations = _attr_mod.current().get(None)
    return s


_where = threading.local()


class _on_device:
    """The device the graph's source ops (``_const``, ``_filled``,
    ``_arange``, which read no input) make their values on while a walk
    runs: its variables' device (``meta`` in shape inference)."""

    def __init__(self, device):
        self._device = device

    def __enter__(self):
        self._prev = getattr(_where, "device", None)
        _where.device = self._device

    def __exit__(self, *exc):
        _where.device = self._prev


def _source_device():
    return getattr(_where, "device", None) or torch.device("cpu")


def _const(*, value):
    return torch.full((), value, dtype=torch.float32,
                      device=_source_device())


def _filled(*, shape, value, dtype="float32"):
    return torch.full(tuple(shape), value, dtype=resolve_dtype(dtype),
                      device=_source_device())


def _arange(*, start, stop, step=1.0, repeat=1, dtype="float32"):
    out = torch.arange(start, stop, step,
                       dtype=resolve_dtype(dtype or "float32"),
                       device=_source_device())
    return out.repeat_interleave(repeat) if repeat != 1 else out


def _item(x, *, index):
    return x[index]


def _cond(pred, *vals, then_sym, else_sym, arg_names):
    """The ``_cond`` node as an op on arrays (``nd._cond``, shape
    inference): the chosen branch over ``vals``."""
    return _cond_eval(dict(then_sym=then_sym, else_sym=else_sym,
                           arg_names=arg_names), (pred,) + vals, {}, {},
                      frozenset())


def _foreach(data, *rest, out_sym, state_syms, slice_name, state_names,
             free_names, n_states):
    return _foreach_eval(dict(out_sym=out_sym, state_syms=state_syms,
                              slice_name=slice_name, state_names=state_names,
                              free_names=free_names, n_states=n_states),
                         (data,) + rest, {}, {}, frozenset())


def _while(*rest, pred_sym, out_sym, var_syms, var_names, free_names,
           n_vars, max_iterations):
    return _while_eval(dict(pred_sym=pred_sym, out_sym=out_sym,
                            var_syms=var_syms, var_names=var_names,
                            free_names=free_names, n_vars=n_vars,
                            max_iterations=max_iterations),
                       rest, {}, {}, frozenset())


def _register_graph_ops():
    from .base import register_op

    for fn in (_const, _filled, _arange, _item, _cond, _foreach, _while):
        register_op(fn.__name__)(fn)


_register_graph_ops()


def var(name, shape=None, dtype=None, **kwargs):
    """A free variable, annotated by the current AttrScope."""
    from . import attribute as _attr_mod

    s = Symbol(None, name=name, shape=shape, dtype=dtype)
    s._annotations = _attr_mod.current().get(None)
    return s


Variable = var


def Group(symbols):
    return Symbol("_group", list(symbols), name="group")


_loop_uid = [0]


def _next_uid():
    _loop_uid[0] += 1
    return _loop_uid[0]


def _free_args(roots, loop_names):
    """The free variables of a body's subgraphs that are not loop
    variables, in the outer graph's order, once each."""
    free, seen = [], set()
    for s in roots:
        if not isinstance(s, Symbol):
            raise TypeError(
                "loop body must return Symbols, got %s — nd.contrib offers "
                "the eager NDArray form" % type(s).__name__)
        for a in s._arg_symbols():
            if a.name not in loop_names and a.name not in seen:
                seen.add(a.name)
                free.append(a)
    return free


def cond(pred, then_sym, else_sym, name=None):
    """(ref: symbol/contrib.py:cond) ``then_sym`` where the scalar ``pred``
    is true, else ``else_sym`` (Symbols, or zero-argument callables
    returning one). The branches read the outer graph's variables."""
    if callable(then_sym) and not isinstance(then_sym, Symbol):
        then_sym = then_sym()
    if callable(else_sym) and not isinstance(else_sym, Symbol):
        else_sym = else_sym()
    for b in (then_sym, else_sym):
        if not isinstance(b, Symbol):
            raise NotImplementedError(
                "cond branches must be (or return) a single Symbol, got %s "
                "— multi-output branches are not supported yet (Group them "
                "or use several conds)" % type(b).__name__)
    seen = {}
    for branch in (then_sym, else_sym):
        for a in branch._arg_symbols():
            seen.setdefault(a.name, a)
    arg_names = list(seen)
    return Symbol("_cond", [pred] + [seen[n] for n in arg_names],
                  {"then_sym": then_sym, "else_sym": else_sym,
                   "arg_names": arg_names}, name=name or "cond")


def foreach(body, data, init_states, name=None):
    """(ref: symbol/contrib.py:foreach) ``body(slice, states) -> (out,
    new_states)`` traced once over loop variables and run once a step over
    axis 0 of ``data``; returns (stacked outputs, final states)."""
    single_state = not isinstance(init_states, (list, tuple))
    states = [init_states] if single_state else list(init_states)
    for s in [data] + states:
        if not isinstance(s, Symbol):
            raise TypeError("foreach data/init_states must be Symbols, got "
                            "%s — nd.contrib.foreach is the eager form"
                            % type(s).__name__)
    uid = _next_uid()
    slice_v = Symbol(None, name="_fe%d_x" % uid,
                     shape=(data._shape[1:] if data._shape else None))
    state_vs = [Symbol(None, name="_fe%d_s%d" % (uid, j), shape=s._shape)
                for j, s in enumerate(states)]
    out_sym, new_states = body(slice_v,
                               state_vs[0] if single_state else state_vs)
    if isinstance(out_sym, (list, tuple)):
        raise NotImplementedError(
            "foreach bodies with multiple per-step outputs are not "
            "supported yet — return one Symbol (stack/concat inside the "
            "body, or run several foreach loops)")
    new_states = [new_states] if not isinstance(new_states, (list, tuple)) \
        else list(new_states)
    if len(new_states) != len(states):
        raise ValueError("body returned %d states, expected %d"
                         % (len(new_states), len(states)))
    state_names = [v.name for v in state_vs]
    free = _free_args([out_sym] + new_states,
                      {slice_v.name} | set(state_names))
    node = Symbol("_foreach", [data] + states + free,
                  {"out_sym": out_sym, "state_syms": new_states,
                   "slice_name": slice_v.name, "state_names": state_names,
                   "free_names": [a.name for a in free],
                   "n_states": len(states)}, name=name)
    out_states = [node[i + 1] for i in range(len(states))]
    return node[0], (out_states[0] if single_state else out_states)


def while_loop(cond_fn, func, loop_vars, max_iterations, name=None):
    """(ref: symbol/contrib.py:while_loop) ``cond_fn(vars) -> pred``,
    ``func(vars) -> (out, new_vars)``, a masked scan of ``max_iterations``
    steps (steps after the predicate turns false keep the vars and emit
    zeros); returns (stacked outputs, final vars)."""
    if max_iterations is None:
        raise ValueError("symbolic while_loop needs max_iterations (static "
                         "output stacking; the nd.contrib form allows None)")
    single = not isinstance(loop_vars, (list, tuple))
    vars_in = [loop_vars] if single else list(loop_vars)
    for v in vars_in:
        if not isinstance(v, Symbol):
            raise TypeError("while_loop loop_vars must be Symbols, got %s — "
                            "nd.contrib.while_loop is the eager form"
                            % type(v).__name__)
    uid = _next_uid()
    var_vs = [Symbol(None, name="_wl%d_v%d" % (uid, j), shape=v._shape)
              for j, v in enumerate(vars_in)]
    packed = var_vs[0] if single else var_vs
    pred_sym = cond_fn(packed)
    out_sym, new_vars = func(packed)
    if isinstance(out_sym, (list, tuple)):
        raise NotImplementedError(
            "while_loop bodies with multiple per-step outputs are not "
            "supported yet — return one Symbol")
    new_vars = [new_vars] if not isinstance(new_vars, (list, tuple)) \
        else list(new_vars)
    if len(new_vars) != len(vars_in):
        raise ValueError("func returned %d loop vars, expected %d"
                         % (len(new_vars), len(vars_in)))
    var_names = [v.name for v in var_vs]
    free = _free_args([pred_sym, out_sym] + new_vars, set(var_names))
    node = Symbol("_while", vars_in + free,
                  {"pred_sym": pred_sym, "out_sym": out_sym,
                   "var_syms": new_vars, "var_names": var_names,
                   "free_names": [a.name for a in free],
                   "n_vars": len(vars_in),
                   "max_iterations": int(max_iterations)}, name=name)
    out_vars = [node[i + 1] for i in range(len(vars_in))]
    return node[0], (out_vars[0] if single else out_vars)


def load(fname):
    with open(fname) as f:
        return loads(f.read())


def _literal(v):
    """An attr as the JAX package writes it (a repr), read back; a dtype
    written as ``float32`` (no quotes) reads as its name."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def loads(json_str):
    """The graph :meth:`Symbol.tojson` (either package's) wrote. No
    AttrScope reaches it: annotations come from the file only."""
    blob = json.loads(json_str)
    built = []
    for node in blob["nodes"]:
        attrs = {}
        for k, v in node["attrs"].items():
            if isinstance(v, dict) and "__sym__" in v:
                attrs[k] = built[v["__sym__"]]  # a control-flow body
            elif isinstance(v, dict) and "__symlist__" in v:
                attrs[k] = [built[i] for i in v["__symlist__"]]
            else:
                attrs[k] = _literal(v)
        if node["op"] == "null":
            s = Symbol(None, name=node["name"], shape=node.get("shape"))
        else:
            s = Symbol(node["op"], [built[i] for i in node["inputs"]], attrs,
                       name=node["name"])
        s._annotations = dict(node.get("annotations", {}))
        built.append(s)
    return built[blob.get("head", len(built) - 1)]


def _with_training(sym, training):
    """The DAG cloned with ``training`` set on every training-gated op that
    does not pin it (an explicit attr wins, as upstream's
    ``mode='always'`` dropout): how ``forward(is_train=...)`` governs
    Dropout and BatchNorm."""
    memo = {}
    for s in _topo_all(sym):
        if s._op in (None, "_const"):
            memo[id(s)] = s  # variables keep their identity
            continue
        c = copy.copy(s)
        c._inputs = [memo[id(i)] for i in s._inputs]
        attrs = {k: memo[id(v)] if isinstance(v, Symbol) else
                 [memo[id(e)] if isinstance(e, Symbol) else e for e in v]
                 if isinstance(v, list) else v for k, v in s._attrs.items()}
        fn = OP_REGISTRY.get(s._op)
        if getattr(fn, "needs_training", False) and "training" not in attrs:
            attrs["training"] = bool(training)
        c._attrs = attrs
        c.__dict__.pop("_meta_cache", None)
        c.__dict__.pop("_shared_memo", None)
        memo[id(s)] = c
    return memo[id(sym)]


def _signature(values):
    return tuple((tuple(v.shape), v.dtype, str(v.device)) for v in values)


class _Program:
    """One key's captured graphs: the static arguments, the forward graph
    with its outputs and the predicates of the top-level conds, the
    generator registered with it and, when some argument takes a gradient,
    the backward graph with its static output cotangents."""

    def __init__(self):
        self.static = self.fwd = self.bwd = self.gen = None
        self.outs = self.preds = self.gouts = self.grads = None
        self.generation = 0


def _split(outs, n):
    """(heads, the last ``n`` values: the top-level conds' predicates)."""
    outs = list(outs)
    return outs[:len(outs) - n], outs[len(outs) - n:]


class Executor:
    """A bound symbol (ref: src/executor/graph_executor.cc; the JAX
    package's two programs plus the VJP). See the module docstring.
    ``stats``: forward and backward captures, forward and backward
    replays, recaptures."""

    def __init__(self, sym, ctx, args, args_grad, grad_req):
        self._sym = sym
        self._ctx = ctx
        self.arg_dict = dict(args or {})
        self.grad_dict = dict(args_grad or {})
        self._grad_req = grad_req
        self._names = [a.name for a in sym._arg_symbols()]
        self._modes = {}
        self._conds = {}
        self._guesses = {}  # (is_train, diff, signature) -> last decisions
        self._programs = {}
        self._seen = set()
        self._last = None  # (program or eager state, generation, is_train)
        self.outputs = []
        self.stats = {"forward_captures": 0, "backward_captures": 0,
                      "forward_replays": 0, "backward_replays": 0,
                      "recaptures": 0}

    # ----------------------------------------------------------- plumbing
    def _req(self, name):
        req = self._grad_req
        if isinstance(req, dict):
            return req.get(name, "null")
        if isinstance(req, (list, tuple)):
            return dict(zip(self._names, req)).get(name, "null")
        return req

    def _diff_names(self):
        return [n for n in self._names
                if self.grad_dict.get(n) is not None
                and self._req(n) != "null"
                and self.arg_dict[n]._data.is_floating_point()]

    def _mode(self, is_train):
        s = self._modes.get(bool(is_train))
        if s is None:
            s = self._modes[bool(is_train)] = _with_training(self._sym,
                                                             is_train)
        return s

    @property
    def aux_dict(self):
        """Auxiliary states: BatchNorm's moving statistics are arguments
        here, as in the JAX package, so this is empty."""
        return {}

    # ----------------------------------------------------------- forward
    def forward(self, is_train=False, **kwargs):
        from . import engine

        for k, v in kwargs.items():
            if k not in self.arg_dict and k not in self._names:
                raise ValueError("forward: no argument %r" % k)
            self.arg_dict[k] = v if isinstance(v, NDArray) else NDArray(v)
        missing = [n for n in self._names if n not in self.arg_dict]
        if missing:
            raise KeyError("unbound variables %s" % missing)
        vals = [self.arg_dict[n]._data for n in self._names]
        diff = self._diff_names() if is_train else []
        mode = self._mode(is_train)
        conds = self._top_conds(mode)
        guess_key = (bool(is_train), tuple(diff), _signature(vals))
        decisions = self._guesses.get(guess_key) or {id(c): True
                                                     for c in conds}
        # each run reads the predicates its program computed; a wrong guess
        # runs again from the same draws with what was read. A cond whose
        # predicate reads an earlier cond's output settles one run later.
        for _ in range(len(conds) + 1):
            outs, state, prog, read = self._run(mode, vals, diff, is_train,
                                                decisions, conds)
            if read == decisions:
                break
            engine.cond_rerun_counter.count += 1
            decisions = read
        else:
            raise RuntimeError("the cond predicates did not settle in %d "
                               "runs" % (len(conds) + 1))
        self._guesses[guess_key] = decisions
        if is_train:  # an eval forward in between keeps it
            self._last = (state, prog.generation, diff)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def _top_conds(self, s):
        """The graph's top-level cond nodes (a cond in a loop body is not
        one: it raises under capture)."""
        conds = self._conds.get(id(s))
        if conds is None:
            conds = self._conds[id(s)] = [n for n in _topo(s)
                                          if n._op == "_cond"]
        return conds

    def _run(self, s, vals, diff, is_train, decisions, conds):
        """One forward through the program keyed on ``decisions`` (captured
        at its first use on the card): (head outputs, backward state,
        program, {id(cond): branch} read from the predicates it computed,
        one sync). When the read differs, the generator the run drew from
        is put back, so the run that follows draws the same masks."""
        from . import engine
        from . import random as _random

        key = (bool(is_train), tuple(diff), _signature(vals),
               tuple(decisions.values()))
        preds = [c._inputs[0] for c in conds]
        device = vals[0].device if vals else torch.device("cpu")
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _Program()
            self.stats["forward_captures"] += 1
            self.stats["backward_captures"] += int(bool(diff))
            self.stats["recaptures"] += int(key in self._seen)
            self._seen.add(key)
            engine.symbol_compile_counter.bump(
                note="executor[train=%s grads=%d]" % (bool(is_train),
                                                      len(diff)))
            if device.type == "cuda":
                with _decisions(decisions):
                    self._capture(prog, s, vals, diff, device, preds)
        self.stats["forward_replays"] += 1
        gen = None
        if conds:
            gen = prog.gen if prog.fwd is not None else \
                _random.generator(device)
            drawn_from = gen.get_state()
        if prog.fwd is None:  # the CPU: the same key, eagerly
            with _decisions(decisions):
                outs, got, state = self._eager_forward(s, vals, diff, preds)
        else:
            with torch.no_grad():
                for t, v in zip(prog.static, vals):
                    t.copy_(v)
            prog.fwd.replay()
            prog.generation += 1
            outs = [o.detach().clone() for o in prog.outs]
            got, state = prog.preds, prog
        if not conds:
            return outs, state, prog, {}
        with torch.no_grad():
            branches = torch.stack([p.reshape(()).to(torch.bool)
                                    for p in got]).tolist()
        engine.cond_host_read_counter.count += len(conds)
        read = {id(c): bool(b) for c, b in zip(conds, branches)}
        if read != decisions:
            gen.set_state(drawn_from)
        return outs, state, prog, read

    def _eager_forward(self, s, vals, diff, preds):
        """(head outputs, predicate values, backward state) in one walk."""
        heads = _heads(s)
        if not diff:
            with torch.no_grad():
                outs = _eval_symbols(heads + preds, dict(zip(self._names,
                                                            vals)))
            return _split(outs, len(preds)) + (None,)
        ins = [v.detach().requires_grad_(n in diff)
               if v.is_floating_point() else v
               for n, v in zip(self._names, vals)]
        with torch.enable_grad():
            outs, got = _split(_eval_symbols(
                heads + preds, dict(zip(self._names, ins))), len(preds))
        return [o.detach() for o in outs], got, (ins, outs)

    def _capture(self, prog, s, vals, diff, device, preds):
        from . import random as _random
        from .capture import capture_graph

        prog.static = [v.detach().clone().requires_grad_(n in diff)
                       for n, v in zip(self._names, vals)]
        env = dict(zip(self._names, prog.static))
        dins = [t for n, t in zip(self._names, prog.static) if n in diff]

        def run():
            with torch.set_grad_enabled(bool(diff)):
                return _eval_symbols(_heads(s) + preds, env)

        def warm():
            outs, _ = _split(run(), len(preds))
            live = [o for o in outs if o.requires_grad]
            if live:
                torch.autograd.grad(live, dins,
                                    [torch.ones_like(o) for o in live],
                                    allow_unused=True)

        pool = torch.cuda.graph_pool_handle()
        prog.gen = _random.generator(device)
        prog.fwd = capture_graph(run, device, pool, warmup=warm,
                                 generators=[prog.gen])
        prog.outs, prog.preds = _split(prog.fwd.out, len(preds))
        if not diff:
            return
        live = [o for o in prog.outs if o.requires_grad]
        prog.gouts = [torch.zeros_like(o) for o in live]

        def backward():
            got = torch.autograd.grad(live, dins, prog.gouts,
                                      allow_unused=True)
            return [torch.zeros_like(t) if g is None else g
                    for g, t in zip(got, dins)]

        # the backward reads the forward's saved activations: no warm-up,
        # the forward's pool
        prog.bwd = capture_graph(backward, device, pool, warmup=lambda: None)
        prog.grads = prog.bwd.out

    # ----------------------------------------------------------- backward
    def backward(self, out_grads=None):
        """The gradients of the last ``forward(is_train=True)``'s outputs
        (seeded with ``out_grads``, ones by default), stored in
        ``grad_dict`` under each argument's ``grad_req``."""
        if self._last is None:
            raise RuntimeError("backward needs a forward(is_train=True)")
        state, generation, diff = self._last
        if not diff:  # every grad_req null: nothing to store
            return
        if out_grads is None:
            cots = [None] * len(self.outputs)
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [getattr(g, "_data", g) for g in out_grads]
        if isinstance(state, _Program):
            if state.generation != generation:
                raise RuntimeError("backward after a later forward of the "
                                   "same key replayed over its activations")
            live = [i for i, o in enumerate(state.outs) if o.requires_grad]
            with torch.no_grad():
                for s, i in zip(state.gouts, live):
                    c = cots[i]
                    if c is None:
                        s.fill_(1)
                    else:
                        s.copy_(c)
            state.bwd.replay()
            self.stats["backward_replays"] += 1
            grads = [g.clone() for g in state.grads]
        else:
            ins, outs = state
            pairs = [(o, torch.ones_like(o) if c is None else
                      c.to(o.dtype)) for o, c in zip(outs, cots)
                     if o.requires_grad]
            dins = [t for n, t in zip(self._names, ins) if n in diff]
            got = torch.autograd.grad([o for o, _ in pairs], dins,
                                      [c for _, c in pairs],
                                      allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for g, t in zip(got, dins)]
            self.stats["backward_replays"] += 1
        for n, g in zip(diff, grads):
            dst = self.grad_dict[n]
            if self._req(n) == "add":
                dst._data = dst._data + g.detach()
            else:
                dst._data = g.detach()

    # ----------------------------------------------------------- params
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """(ref: executor.py:Executor.copy_params_from) Each named argument
        takes the given value; a later rebind of the caller's array does
        not reach it."""
        merged = dict(arg_params or {})
        merged.update(aux_params or {})
        for n, v in merged.items():
            if n in self.arg_dict or n in self._names:
                t = v._data if isinstance(v, NDArray) else v if \
                    isinstance(v, torch.Tensor) else torch.as_tensor(
                        np.asarray(v))
                self.arg_dict[n] = NDArray(t)
            elif not allow_extra_params:
                raise ValueError("Executor has no argument %r" % n)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """(ref: executor.py:Executor.reshape) A new executor with the
        named arguments at new shapes (zeros) and fresh zero gradients; a
        new shape is a new key, captured at its first forward."""
        unknown = [n for n in kwargs if n not in self.arg_dict]
        if unknown:
            raise ValueError("reshape: no such argument(s) %s (have %s)"
                             % (unknown, sorted(self.arg_dict)))
        ex = Executor(self._sym, self._ctx, dict(self.arg_dict), {},
                      self._grad_req)
        for n, shape in kwargs.items():
            a = ex.arg_dict[n]._data
            if tuple(a.shape) != tuple(shape):
                ex.arg_dict[n] = NDArray(torch.zeros(
                    shape, dtype=a.dtype, device=a.device))
        ex.grad_dict = {n: NDArray(torch.zeros_like(ex.arg_dict[n]._data))
                        for n, g in self.grad_dict.items() if g is not None}
        return ex
