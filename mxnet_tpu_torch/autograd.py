"""Autograd (counterpart of ``mxnet_tpu/autograd.py``) over torch autograd.

MXNet's contract, kept here: a graph is recorded only inside
``autograd.record()`` (``HybridBlock`` runs its forward with torch's grad
mode set from :func:`is_recording`, so a forward outside ``record()``
builds no graph), ``record()`` also sets the training flag that
``Dropout`` reads, and :func:`backward` writes each Parameter's gradient
under its ``grad_req``: ``"write"`` replaces it, ``"add"`` adds to it,
``"null"`` leaves it alone. A non-scalar head gets MXNet's implicit
head-gradient of ones (torch's own ``Tensor.backward()`` refuses one).

The Parameters a backward reaches are the ones read inside the outermost
``record()`` scope on this thread (``Parameter.data()`` registers itself
here). The state is per thread, as in the JAX package.

Not in this module yet: NDArray, ``mark_variables`` and
``grad(create_graph=True)`` (``ROADMAP.md`` A.2).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "backward"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # id(Parameter) -> (Parameter, the tensor it gave the recorded graph)
        self.params = {}


_st = _State()


def read_param(param, tensor):
    """Called by ``Parameter.data()``: while recording, remember the
    parameter and the leaf tensor the graph uses, for :func:`backward`."""
    if _st.recording:
        _st.params[id(param)] = (param, tensor)


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


def backward(heads, head_grads=None, retain_graph=False):
    """Compute the gradients of ``heads`` (a tensor or a list) with respect
    to every Parameter read inside the last ``record()`` scope, and store
    them by each Parameter's ``grad_req`` (ref:
    python/mxnet/autograd.py:backward). ``head_grads`` default to ones of
    each head's shape. A Parameter the heads do not reach keeps its
    gradient."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    if len(head_grads) != len(heads):
        raise ValueError("backward: %d heads but %d head_grads"
                         % (len(heads), len(head_grads)))
    seeds = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    entries = [(p, t) for p, t in _st.params.values()
               if p.grad_req != "null"]
    if not entries:
        raise RuntimeError("backward: no Parameter with a gradient was read "
                           "inside autograd.record()")
    grads = torch.autograd.grad(heads, [t for _, t in entries], seeds,
                                retain_graph=retain_graph, allow_unused=True)
    for (param, _), g in zip(entries, grads):
        if g is not None:
            param._store_grad(g)
    if not retain_graph:
        _st.params = {}
