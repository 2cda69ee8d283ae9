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

Not here: the compiled tape replay of the JAX package
(``set_tape_compile``; ``ROADMAP.md`` A.13) and ``get_symbol`` (A.14).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward", "grad", "mark_variables", "Function",
           "get_symbol", "set_tape_compile"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # id(variable) -> (Parameter or NDArray, the tensor the recorded
        # graph read)
        self.params = {}


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
        if self._rec is not None:
            if self._rec and not _st.recording:
                _st.params = {}  # fresh per outermost record scope
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
    _accumulate(heads, seeds, entries, retain_graph)
    if not retain_graph:
        _st.params = {}


def _accumulate(heads, seeds, entries, retain_graph):
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
    if heads:
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
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if len(wrapped) == 1 else tuple(wrapped)


def get_symbol(x):
    """The recorded history as a Symbol: the symbolic front end is not
    ported yet."""
    raise NotImplementedError("autograd.get_symbol needs the symbol front "
                              "end, not ported yet (ROADMAP.md A.14)")


def set_tape_compile(enabled):
    """The JAX package's compiled tape replay: the port's counterpart, a
    captured backward, is not ported yet."""
    raise NotImplementedError("compiled tape replay is not ported yet "
                              "(ROADMAP.md A.13)")
