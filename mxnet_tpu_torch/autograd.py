"""Autograd (counterpart of ``mxnet_tpu/autograd.py``) over torch autograd.

MXNet's contract, kept here: a graph is recorded only inside
``autograd.record()`` (``HybridBlock`` and ``nd`` run with torch's grad
mode set from :func:`is_recording`, so work outside ``record()`` builds no
graph), ``record()`` also sets the training flag that ``Dropout`` reads,
and :func:`backward` writes each variable's gradient under its
``grad_req``: ``"write"`` replaces it, ``"add"`` adds to it, ``"null"``
leaves it alone. A non-scalar head gets MXNet's implicit head-gradient of
ones (torch's own ``Tensor.backward()`` refuses one).

The variables a backward reaches are the Parameters read and the NDArrays
with a gradient buffer (``attach_grad``, :func:`mark_variables`) used
inside the outermost ``record()`` scope on this thread. :func:`backward`
lets torch's engine accumulate into the parameters' gradient tensors
(``torch.autograd.backward`` with ``inputs=``), each cleared first unless
its ``grad_req`` is ``"add"``, so a parameter's
``register_post_accumulate_grad_hook`` fires as its gradient lands (the
bucketed exchange of ``mxnet_tpu_torch.dist`` starts there). :func:`grad`
returns gradients without storing them, and with ``create_graph=True``
records their computation for a higher order. The state is per thread, as
in the JAX package.

The compiled tape replay (the JAX package's ``set_tape_compile``,
``MXNET_TAPE_COMPILE``): the port's tape is torch's autograd graph, and its
counterpart of the JAX ``tape_jitted`` program is torch's compiled
autograd. With the replay on, a backward on a CUDA device runs under
``torch._dynamo.compiled_autograd`` with
``torch.compile(backend=TAPE_BACKEND)``, which traces the backward graph
at ``backward()`` time and caches the compiled program by its structure;
a backward in which torch captured a new graph or compiled one (a
recompile after a guard failure too) counts in
``engine.tape_compile_counter``, one that ran a built program in
``engine.tape_cache_hit_counter``, both read from torch's own counters.
On the CPU the backward runs eagerly, keyed by the graph's structure (each
node's kind and wiring, the variables' and heads' shapes and dtypes): a
new key counts as a build, a known one as a hit; :func:`set_tape_compile`
given a ``cpu_backend`` compiles there too (tests use ``"aot_eager"``). The JAX package's eager hatches stay explicit and are
counted in ``engine.tape_eager_counter``: the replay off
(``set_tape_compile(False)``, ``MXNET_TAPE_COMPILE=0``), a tape holding an
:class:`Function` node or another Python ``torch.autograd.Function`` that
is not plain torch compute (a hybridized block's replay node, a
collective's; the kernels' ``torch.library`` formulas and the Embedding,
dense attention and SoftmaxOutput Functions are traced), a variable with
a ``register_post_accumulate_grad_hook`` (the bucketed exchange of
``mxnet_tpu_torch.dist`` starts there, and its collectives must not be
traced), and ``grad(create_graph=True)``.
``grad_req`` holds as on the eager path: the compiled backward is the same
``torch.autograd.backward`` with ``inputs=``.

:func:`get_symbol` reads a forward record of its own: torch's graph keeps
no op's forward function, where the JAX tape keeps each op's primal. Under
``record()`` each ``nd`` op (its registry function and attrs), each
NDArray call of a Gluon block (its eager forward: a hybridized block's
program is replayed through the block's own ops) and each
:class:`Function` (opaque) appends an entry naming its inputs and outputs
by tokens, serial numbers held for each tensor in a weak-keyed map: an
entry pins no tensor, and a freed tensor's reused ``id()`` gets a new
token. The record starts afresh at each outermost ``record()``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function",
           "get_symbol", "set_tape_compile", "tape_compile_enabled"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # id(variable) -> (Parameter or NDArray, the tensor the recorded
        # graph read)
        self.params = {}
        # get_symbol's forward record: _Entry list, and tensor -> token
        self.record = []
        self.tokens = WeakIdKeyDictionary()


_st = _State()

def read_variable(var, tensor):
    """Called by ``Parameter`` and by ``nd`` for an NDArray with a gradient
    buffer: while recording, remember the variable and the tensor the graph
    uses, for :func:`backward`."""
    if _st.recording:
        _st.params[id(var)] = (var, tensor)


class _RecordScope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._grad_mode = None

    def __enter__(self):
        self._prev = (_st.recording, _st.training)
        if self._rec:
            from . import engine

            engine.flush()  # recording entry is a sync point
        if self._rec is not None:
            if self._rec and not _st.recording:
                _st.params = {}  # fresh per outermost record scope
                _st.record = []
            _st.recording = self._rec
            self._grad_mode = torch.set_grad_enabled(self._rec)
        if self._train is not None:
            _st.training = self._train
        return self

    def __exit__(self, *exc):
        if self._grad_mode is not None:
            self._grad_mode.__exit__(*exc)
            self._grad_mode = None
        _st.recording, _st.training = self._prev

    def __call__(self, fn):
        def wrapped(*args, **kwargs):
            with _RecordScope(self._rec, self._train):
                return fn(*args, **kwargs)

        return wrapped


class _Mode:
    """Recording and the training flag set (and torch's grad mode with
    recording) without starting a new variable list: a program's body
    runs in the mode of the call it stands for."""

    def __init__(self, recording, training):
        self._mode = (recording, training)

    def __enter__(self):
        self._prev = (_st.recording, _st.training)
        _st.recording, _st.training = self._mode
        self._grad = torch.set_grad_enabled(self._mode[0])
        self._grad.__enter__()

    def __exit__(self, *exc):
        self._grad.__exit__(*exc)
        _st.recording, _st.training = self._prev


def record(train_mode=True):
    """Record the graph of what runs inside, for :func:`backward`."""
    return _RecordScope(True, train_mode)


def pause(train_mode=False):
    """Stop recording inside a ``record()`` scope."""
    return _RecordScope(False, train_mode)


def train_mode():
    return _RecordScope(None, True)


def predict_mode():
    return _RecordScope(None, False)


def is_recording():
    return _st.recording


def is_training():
    return _st.training


def _tensors(xs):
    """A head or variable list as tensors (NDArrays unwrapped)."""
    if xs is None:
        return None
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    return [getattr(x, "_data", x) for x in xs]


def _seeds(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise ValueError("backward: %d heads but %d head_grads"
                         % (len(heads), len(head_grads)))
    return [torch.ones_like(h) if g is None else g.to(h.dtype)
            for h, g in zip(heads, head_grads)]


def _live(heads, head_grads):
    """(heads, seeds) of the heads that carry a graph: a head with none
    (a ``BlockGrad`` output, BatchNorm's moving statistics) adds nothing."""
    heads = _tensors(heads)
    pairs = [(h, s) for h, s in zip(heads, _seeds(heads,
                                                  _tensors(head_grads)))
             if h.requires_grad]
    return [h for h, _ in pairs], [s for _, s in pairs]


# off by default, where the JAX package's is on (ROADMAP.md C.2): a new
# backward graph costs a compile of seconds on the card
_TAPE_COMPILE_DEFAULT = False
_TAPE_COMPILE = os.environ.get(
    "MXNET_TAPE_COMPILE", "1" if _TAPE_COMPILE_DEFAULT else "0") != "0"
# the torch.compile backend of a CUDA backward: AOT autograd's traced graph
# run as it is. Inductor's code for the GPT-2 backward under compiled
# autograd fails on torch 2.11 (it reads a python float where its kernel
# takes a tensor; PERF.md section 6)
TAPE_BACKEND = "aot_eager"
_CPU_BACKEND = None
# structural keys of the backward programs built so far
_TAPE_KEYS = set()
_TAPE_KEY_CAP = 1024


def set_tape_compile(enabled, cpu_backend=None):
    """Turn the compiled tape replay on or off; returns the previous
    setting. ``cpu_backend`` (a ``torch.compile`` backend, ``""`` for
    none) makes a CPU backward compile too, for tests; by default a CPU
    backward runs eagerly."""
    global _TAPE_COMPILE, _CPU_BACKEND
    prev, _TAPE_COMPILE = _TAPE_COMPILE, bool(enabled)
    if cpu_backend is not None:
        _CPU_BACKEND = cpu_backend or None
    return prev


def tape_compile_enabled():
    return _TAPE_COMPILE


def _compiled_autograd():
    """torch's compiled autograd entry point in the form this module uses
    (``torch._dynamo.compiled_autograd._enable(compiler_fn)``, torch
    2.11's); raises ``ImportError`` when the installed torch lacks it."""
    import torch._dynamo.compiled_autograd as ca

    if not callable(getattr(ca, "_enable", None)):
        raise ImportError("this torch (%s) has no torch._dynamo."
                          "compiled_autograd._enable: the compiled tape "
                          "replay needs it" % torch.__version__)
    return ca


def _compiler(backend):
    def compile_graph(gm):
        # no fullgraph: torch 2.11's compiled-autograd graph holds a piece
        # Dynamo does not trace, which it runs as it is
        return torch.compile(gm, backend=backend)

    return compile_graph


# the port's Python autograd Functions whose backward is torch ops on their
# saved tensors, which compiled autograd traces
_TRACED_FUNCTIONS = frozenset(("_EmbeddingBackward", "_DenseAttentionBackward",
                               "_SoftmaxOutputBackward"))


def _opaque(fn):
    """A Python ``torch.autograd.Function`` node the compiled replay does not
    trace: a user's :class:`Function`, a hybridized block's graph replay, a
    collective's; not a kernel op's registered formula nor one of
    :data:`_TRACED_FUNCTIONS`."""
    if not isinstance(fn, torch.autograd.function.BackwardCFunction):
        return False
    name = type(fn).__name__
    return not (name in _TRACED_FUNCTIONS or name.startswith(
        "GeneratedBackwardFor_mxnet_tpu"))


def _tape_key(heads, entries):
    """The backward graph's structural key, or None when it holds an opaque
    node: every node's kind, in depth-first order, with the positions of
    the nodes it feeds, the variables' and heads' shapes and dtypes."""
    order, index, parts = [], {}, []
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in index:
            continue
        if _opaque(fn):
            return None
        index[fn] = len(order)
        order.append(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    for fn in order:
        var = getattr(fn, "variable", None)
        parts.append((type(fn).__name__,
                      tuple(index.get(n, -1) for n, _ in fn.next_functions),
                      None if var is None else (tuple(var.shape),
                                                var.dtype)))
    return (tuple(parts), tuple((tuple(h.shape), h.dtype) for h in heads),
            tuple((tuple(t.shape), t.dtype) for _, t in entries))


def _tape_route(heads, entries):
    """"compiled" (through compiled autograd: a CUDA backward, or a CPU one
    given a ``cpu_backend``; :func:`_accumulate` counts it), "counted"
    (keyed by structure and counted here, run eagerly: the CPU) or "eager"
    (a counted hatch)."""
    from . import engine

    if not _TAPE_COMPILE or not heads or any(
            getattr(t, "_post_accumulate_grad_hooks", None)
            for _, t in entries):
        engine.tape_eager_counter.count += 1
        return "eager"
    key = _tape_key(heads, entries)
    if key is None:
        engine.tape_eager_counter.count += 1
        return "eager"
    if any(h.is_cuda for h in heads) or _CPU_BACKEND:
        return "compiled"
    if key in _TAPE_KEYS:
        engine.tape_cache_hit_counter.count += 1
    else:
        if len(_TAPE_KEYS) >= _TAPE_KEY_CAP:
            _TAPE_KEYS.clear()
        _TAPE_KEYS.add(key)
        engine.tape_compile_counter.bump(note="tape[%x]" % (
            hash(key) & 0xFFFFFFFF))
    return "counted"


def _backward_scope(heads):
    """The profiler's ``backward[...]`` record of a compiled replay, named
    after the head nodes' kinds, while the profiler runs."""
    from . import profiler

    if not profiler.is_running():
        return contextlib.nullcontext()
    return profiler.backward_scope([type(h.grad_fn).__name__
                                    for h in heads if h.grad_fn is not None])


def _torch_builds():
    """torch's counts of compiled-autograd graphs captured and of graphs
    Dynamo compiled: a backward that moves either built a program."""
    from torch._dynamo.utils import counters

    return (counters["compiled_autograd"]["captures"],
            counters["stats"]["unique_graphs"])


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Compute the gradients of ``heads`` (tensors or NDArrays, one or a
    list) with respect to every variable read inside the last ``record()``
    scope, and store them by each variable's ``grad_req`` (ref:
    python/mxnet/autograd.py:backward). ``head_grads`` default to ones of
    each head's shape. A variable the heads do not reach keeps its
    gradient."""
    heads, seeds = _live(heads, head_grads)
    entries = [(p, t) for p, t in _st.params.values()
               if p.grad_req != "null" and t.requires_grad]
    if not entries:
        raise RuntimeError("backward: no variable with a gradient was read "
                           "inside autograd.record()")
    _accumulate(heads, seeds, entries, retain_graph,
                _tape_route(heads, entries))
    if not retain_graph:
        _st.params = {}


def _accumulate(heads, seeds, entries, retain_graph, route="eager"):
    """The gradients accumulated into the tensors' ``.grad`` by torch's
    engine (a Parameter's hooks fire as each lands): cleared first unless
    ``grad_req`` is ``"add"``; a variable the heads do not reach keeps its
    gradient; an NDArray's gradient goes to its own buffer."""
    from .gluon.parameter import Parameter

    saved = []
    for var, t in entries:
        saved.append(t.grad)
        if not (isinstance(var, Parameter) and var.grad_req == "add"):
            t.grad = None
    if heads and route == "compiled":
        from . import engine

        backend = TAPE_BACKEND if any(h.is_cuda for h in heads) \
            else _CPU_BACKEND
        before = _torch_builds()
        with _compiled_autograd()._enable(_compiler(backend), dynamic=False), \
                _backward_scope(heads):
            torch.autograd.backward(heads, seeds, retain_graph=retain_graph,
                                    inputs=[t for _, t in entries])
        if _torch_builds() != before:
            engine.tape_compile_counter.bump(note="tape[compiled]")
        else:
            engine.tape_cache_hit_counter.count += 1
    elif heads:
        torch.autograd.backward(heads, seeds, retain_graph=retain_graph,
                                inputs=[t for _, t in entries])
    for (var, t), old in zip(entries, saved):
        if not isinstance(var, Parameter):
            g, t.grad = t.grad, old
            if g is not None:
                var._store_grad(g)
        elif t.grad is None:
            t.grad = old


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (NDArrays),
    as new NDArrays; no gradient buffer is touched (ref:
    python/mxnet/autograd.py:grad). A variable the heads do not reach gets
    zeros. With ``create_graph=True`` the gradients carry a graph of their
    own, so a loss made from them (a WGAN-GP penalty) differentiates again;
    ``retain_graph`` defaults to ``create_graph``."""
    from .ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    heads, seeds = _live(heads, head_grads)
    if create_graph:
        from . import engine

        engine.tape_eager_counter.count += 1
    vts = [v._data for v in variables]
    live = [i for i, t in enumerate(vts) if t.requires_grad] if heads else []
    gs = torch.autograd.grad(heads, [vts[i] for i in live], seeds,
                             retain_graph=retain_graph,
                             create_graph=create_graph,
                             allow_unused=True) if live else ()
    out = [torch.zeros_like(t.detach()) for t in vts]
    for i, g in zip(live, gs):
        if g is not None:
            out[i] = g
    return [NDArray(g) for g in out]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` (NDArrays) variables of the next backward, with
    ``gradients`` as their gradient buffers (ref: autograd.py:
    mark_variables). One with no recorded history becomes a leaf."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._data
        if t.grad_fn is None and not t.requires_grad and (
                t.is_floating_point() or t.is_complex()):
            v._data = t.detach().requires_grad_(True)
        v._grad = g
        v._grad_req = req
        read_variable(v, v._data)


class _FunctionNode(torch.autograd.Function):
    """The torch node of an :class:`Function` call: its forward and
    backward run the user's, on NDArrays, with recording paused."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        from .ndarray import NDArray

        with pause():
            raw = fn.forward(*[NDArray(t) for t in inputs])
        outs = [raw] if not isinstance(raw, (list, tuple)) else list(raw)
        if not all(isinstance(o, NDArray) for o in outs):
            raise TypeError("autograd.Function.forward must return NDArrays")
        ctx.fn = fn
        ctx.n_in = len(inputs)
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray

        with pause():
            ig = ctx.fn.backward(*[NDArray(g) for g in grads])
        ig = [ig] if not isinstance(ig, (list, tuple)) else list(ig)
        if len(ig) != ctx.n_in:
            raise ValueError("backward returned %d grads for %d inputs"
                             % (len(ig), ctx.n_in))
        return (None,) + tuple(
            None if g is None else getattr(g, "_data", g) for g in ig)


class Function:
    """User-defined differentiable function (ref: python/mxnet/autograd.py:
    Function): subclass with ``forward`` and ``backward`` over NDArrays.
    ``forward`` runs with recording paused; inside ``record()`` the call
    becomes one node of the graph whose gradient is ``backward``'s, one per
    ``forward`` input. ``save_for_backward`` keeps arrays on the instance."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray, unwrap

        if not all(isinstance(a, NDArray) for a in inputs):
            raise TypeError("autograd.Function inputs must be NDArrays")
        rec = is_recording()
        ts = [unwrap(a, rec) for a in inputs]
        with torch.set_grad_enabled(rec):
            outs = _FunctionNode.apply(self, *ts)
        if rec:
            _record_entry(None, ts, {}, outs)
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)


# ------------------------------------------------------------ forward record

_tokens = itertools.count(1)


class _Tok:
    """A tensor argument of a recorded entry: its token, shape and dtype."""

    __slots__ = ("tok", "shape", "dtype", "produced")

    def __init__(self, t):
        tok = _st.tokens.get(t)
        if tok is None:
            tok = _st.tokens[t] = next(_tokens)
        self.tok = tok
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        # a tensor some unrecorded op computed under record(): it cannot be
        # a leaf of the recovered graph
        self.produced = t.grad_fn is not None


def _template(x):
    """``x`` with each tensor replaced by its :class:`_Tok`."""
    if isinstance(x, torch.Tensor):
        return _Tok(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_template(v) for v in x)
    if isinstance(x, dict):
        return {k: _template(v) for k, v in x.items()}
    return x


def _fill(x, env):
    if isinstance(x, _Tok):
        return env[x.tok]
    if isinstance(x, (list, tuple)):
        return type(x)(_fill(v, env) for v in x)
    if isinstance(x, dict):
        return {k: _fill(v, env) for k, v in x.items()}
    return x


def _toks(x):
    if isinstance(x, _Tok):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _toks(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _toks(v)]
    return []


def _flat_tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat_tensors(o)]
    return []


class _Entry:
    __slots__ = ("fn", "args", "kwargs", "training", "outs")

    def __init__(self, fn, args, kwargs, outs):
        self.fn = fn
        self.args = _template(list(args))
        self.kwargs = _template(dict(kwargs))
        self.training = _st.training
        self.outs = [_Tok(o).tok for o in _flat_tensors(outs)]


def _record_entry(fn, args, kwargs, outs):
    """Append an entry to this thread's forward record: ``fn(*args,
    **kwargs)`` gave ``outs`` (tensors, through lists and tuples); ``fn``
    None for an opaque node."""
    _st.record.append(_Entry(fn, args, kwargs, outs))


def get_symbol(x):
    """The recorded history of ``x`` as a Symbol (ref:
    python/mxnet/autograd.py:get_symbol): the forward record pruned to what
    ``x`` depends on, replayed as one ``_callable`` node over the record's
    leaf arrays, the variables ``arg0..argN`` in first-use order. It
    evaluates, binds and differentiates like any Symbol; ``tojson`` refuses
    it. Raises ``ValueError`` without a history and ``NotImplementedError``
    across an opaque node (an :class:`Function`, ``nd.contrib`` control
    flow) or a leaf an unrecorded op computed under ``record()``."""
    from . import symbol as _symbol
    from .ndarray import NDArray

    if not isinstance(x, NDArray):
        raise TypeError("get_symbol expects an NDArray, got %r" % type(x))
    x_tok = _st.tokens.get(x._data)
    needed = set() if x_tok is None else {x_tok}
    tape = []
    for e in reversed(_st.record):
        if any(o in needed for o in e.outs):
            if e.fn is None:
                raise NotImplementedError(
                    "get_symbol across an imperative CustomOp tape node is "
                    "not supported (its forward is not replayable)")
            tape.append(e)
            needed.update(t.tok for t in _toks((e.args, e.kwargs)))
    tape.reverse()
    if not tape:
        raise ValueError(
            "array has no recorded computation history; call get_symbol on "
            "an output computed under autograd.record()")
    produced, leaves, seen = set(), [], set()
    for e in tape:
        for t in _toks((e.args, e.kwargs)):
            if t.tok not in produced and t.tok not in seen:
                if t.produced:
                    raise NotImplementedError(
                        "get_symbol: an input of the history was computed "
                        "under record() by an operation the record does not "
                        "hold")
                seen.add(t.tok)
                leaves.append(t)
        produced.update(e.outs)
    leaf_toks = [t.tok for t in leaves]
    arg_vars = [_symbol.var("arg%d" % k, shape=t.shape, dtype=t.dtype)
                for k, t in enumerate(leaves)]

    def replay(*leaf_vals):
        env = dict(zip(leaf_toks, leaf_vals))
        for e in tape:
            with _RecordScope(None, e.training):
                out = e.fn(*_fill(e.args, env), **_fill(e.kwargs, env))
            for o, v in zip(e.outs, _flat_tensors(out)):
                env[o] = v
        return env[x_tok]

    return _symbol.Symbol(op="_callable", inputs=arg_vars,
                          attrs={"fn": replay}, name="autograd_history")
