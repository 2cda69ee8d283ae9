"""Every loss class of the port against the JAX package's: the loss and
the gradient of each differentiable input, on seeded numpy inputs, with
``weight`` and ``sample_weight`` where the class takes them. fp32 within
1e-5 of the largest element (1e-4 for ``CTCLoss``: the JAX package runs
the forward algorithm in log space step by step, torch's ``ctc_loss`` in
its own order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import loss as tloss
from torch_port_helpers import jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

N, C = 4, 5


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        what, float(np.abs(got - want).max()))


def _run(name, kw, inputs, diff, tol=1e-5, extra=None):
    """The loss ``name`` of both packages on numpy ``inputs`` (positional),
    with ``extra`` keyword arrays; the loss and the gradients of the
    inputs indexed by ``diff`` (the per-sample losses summed as the
    head)."""
    extra = extra or {}
    jl = getattr(jloss, name)(**kw)
    tl = getattr(tloss, name)(**kw)
    jin = [mx.nd.array(a) for a in inputs]
    for i in diff:
        jin[i].attach_grad()
    jex = {k: mx.nd.array(v) for k, v in extra.items()}
    with jag.record():
        jout = jl(*jin, **jex)
    jag.backward(jout)
    tin = [torch.from_numpy(a).requires_grad_(i in diff)
           for i, a in enumerate(inputs)]
    tex = {k: torch.from_numpy(v) for k, v in extra.items()}
    with autograd.record():
        tout = tl(*tin, **tex)
    grads = torch.autograd.grad(tout, [tin[i] for i in diff],
                                torch.ones_like(tout))
    _close(tout, jout.asnumpy(), tol, name + " loss")
    for i, g in zip(diff, grads):
        _close(g, jin[i].grad.asnumpy(), tol, "%s gradient %d" % (name, i))


def _rng(seed):
    return np.random.RandomState(seed)


def _f(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("name,kw", [
    ("L2Loss", {}), ("L2Loss", dict(weight=0.5)), ("L1Loss", {}),
    ("HuberLoss", dict(rho=0.7)), ("HingeLoss", dict(margin=0.5)),
    ("SquaredHingeLoss", {}), ("LogisticLoss", {}),
    ("LogisticLoss", dict(label_format="binary", weight=2.0)),
    ("SigmoidBCELoss", {}), ("SigmoidBCELoss", dict(from_sigmoid=True)),
])
def test_regression_and_binary_losses_match_jax(jax_trace_state,  # noqa: F811
                                                name, kw):
    """Labels of another shape than pred are reshaped to it; a
    sample_weight of one column broadcasts over the rest."""
    rng = _rng(len(name))
    pred = _f(rng.randn(N, C) * 2)
    if kw.get("from_sigmoid"):
        pred = _f(1 / (1 + np.exp(-pred)))
    if name in ("HingeLoss", "SquaredHingeLoss") or (
            name == "LogisticLoss" and not kw):
        label = _f(np.sign(rng.randn(N * C)))
    elif name.startswith("Sigmoid") or kw.get("label_format") == "binary":
        label = _f(rng.randint(0, 2, N * C))
    else:
        label = _f(rng.randn(N * C))
    sw = _f(rng.rand(N, 1))
    _run(name, kw, [pred, label], diff=(0,))
    _run(name, kw, [pred, label, sw], diff=(0,))


@pytest.mark.parametrize("kw", [{}, dict(from_logits=True),
                                dict(sparse_label=False),
                                dict(axis=1, weight=0.5)])
def test_softmax_cross_entropy_matches_jax(jax_trace_state, kw):  # noqa: F811
    rng = _rng(9)
    pred = _f(rng.randn(N, C, 3) if kw.get("axis") == 1 else rng.randn(N, C))
    if kw.get("from_logits"):
        pred = _f(pred - np.log(np.exp(pred).sum(-1, keepdims=True)))
    if kw.get("sparse_label") is False:
        label = _f(rng.rand(N, C))
        label /= label.sum(-1, keepdims=True)
    elif kw.get("axis") == 1:
        label = rng.randint(0, C, (N, 3)).astype(np.int32)
    else:
        label = rng.randint(0, C, (N,)).astype(np.int32)
    _run("SoftmaxCrossEntropyLoss", kw, [pred, label], diff=(0,))


@pytest.mark.parametrize("kw", [{}, dict(from_logits=False, axis=-1)])
def test_kl_div_loss_matches_jax(jax_trace_state, kw):  # noqa: F811
    rng = _rng(10)
    pred = _f(rng.randn(N, C))
    if kw.get("from_logits", True):
        pred = _f(pred - np.log(np.exp(pred).sum(-1, keepdims=True)))
    label = _f(rng.rand(N, C))
    label /= label.sum(-1, keepdims=True)
    _run("KLDivLoss", kw, [pred, label], diff=(0, 1))


def test_triplet_and_cosine_embedding_losses_match_jax(jax_trace_state):  # noqa: F811
    rng = _rng(11)
    a, p, n = (_f(rng.randn(N, 3, 2)) for _ in range(3))
    _run("TripletLoss", dict(margin=0.5), [a, p, n], diff=(0, 1, 2))
    x1, x2 = _f(rng.randn(N, 6)), _f(rng.randn(N, 6))
    label = _f([1, -1, 1, -1])
    _run("CosineEmbeddingLoss", dict(margin=0.1), [x1, x2, label],
         diff=(0, 1))


@pytest.mark.parametrize("kw", [{}, dict(from_logits=False),
                                dict(compute_full=True)])
def test_poisson_nll_loss_matches_jax(jax_trace_state, kw):  # noqa: F811
    rng = _rng(12)
    pred = _f(rng.randn(N, C) * 0.5)
    if kw.get("from_logits") is False:
        pred = _f(np.exp(pred))
    target = _f(rng.poisson(2.0, (N, C)))
    _run("PoissonNLLLoss", kw, [pred, target], diff=(0,))


def test_sdml_loss_matches_jax(jax_trace_state):  # noqa: F811
    rng = _rng(13)
    x1, x2 = _f(rng.randn(N, 6)), _f(rng.randn(N, 6))
    _run("SDMLLoss", dict(smoothing_parameter=0.2), [x1, x2], diff=(0, 1))


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_loss_matches_jax(jax_trace_state, layout):  # noqa: F811
    """Blank first; labels of lengths 1-3 padded to 3, inputs of lengths
    5-8 padded to 8 (every alignment feasible), and the full lengths."""
    rng = _rng(14)
    T, L, V = 8, 3, 6
    pred = _f(rng.randn(N, T, V))
    label = rng.randint(1, V, (N, L)).astype(np.float32)
    plen = np.array([8, 7, 5, 8], np.float32)
    llen = np.array([3, 2, 1, 3], np.float32)
    for i, n in enumerate(llen.astype(int)):
        label[i, n:] = -1
    if layout == "TNC":
        pred = _f(pred.transpose(1, 0, 2))
    _run("CTCLoss", dict(layout=layout), [pred, label], diff=(0,),
         tol=1e-4, extra=dict(pred_lengths=plen, label_lengths=llen))
    full = np.abs(label)
    _run("CTCLoss", dict(layout=layout), [pred, full], diff=(0,), tol=1e-4)
