"""The port's GPT training step against the JAX package's: a small GPT
(2 layers, 128 units, 2 heads of 64, vocab 1001, so V is odd, sequences of
256 tokens) through both packages' Gluon paths as a user writes them:
``amp.convert_hybrid_block`` (bf16 case), ``autograd.record`` ->
next-token ``SoftmaxCrossEntropyLoss`` over (B, T, V) logits ->
``backward`` -> ``Trainer("adam", multi_precision=True).step``.

At T = 256 in bf16 the port's attention takes ``flash_attention_with_grad``
(here its plain versions) and its loss the softmax-xent wrapper (its plain
versions), the JAX package the dense path and its jnp loss on the CPU. The
LM head is tied, so ``word_embed.weight`` sums two gradients: the head's
product and the embedding gather's."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models.gpt import GPTModel as JaxGPT
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.gpt import GPTModel as PortGPT
from mxnet_tpu_torch.ops import functional as F
from mxnet_tpu_torch.ops.cuda import softmax_xent as sx
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401

T = 256
BATCH = 2
GPT_TRAIN = dict(vocab_size=1001, units=128, num_layers=2, num_heads=2,
                 max_length=T, dropout=0.0)
RECIPE = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}


def _tokens(seed):
    """(input, target): B sequences of T + 1 tokens, input the first T,
    target the last T (the next token at each position)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, GPT_TRAIN["vocab_size"], (BATCH, T + 1)).astype(
        np.int32)
    return seq[:, :T], seq[:, 1:]


def _jax_step(model, trainer, inp, tgt):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        logits = model(mx.nd.array(inp, dtype="int32"))
        loss = loss_fn(logits, mx.nd.array(tgt, dtype="int32"))
    jag.backward(loss)
    grads = {p.name[len(model.prefix):]: np.asarray(p.grad().asnumpy(),
                                                    np.float32)
             for p in model.collect_params().values()}
    trainer.step(inp.shape[0])
    return np.asarray(loss.asnumpy(), np.float32), grads


def _port_step(model, trainer, inp, tgt):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        logits = model(torch.from_numpy(inp))
        loss = loss_fn(logits, torch.from_numpy(tgt))
    autograd.backward(loss)
    grads = {p.name[len(model.prefix):]:
             p._tensor().grad.float().numpy().copy()
             for p in model.collect_params().values()}
    trainer.step(inp.shape[0])
    return loss.detach().float().numpy(), grads


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().copy()
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    return np.asarray(a, np.float32)


def _masters(model, trainer=None):
    """{name: fp32 weight}: the optimizer's fp32 master copy where the
    trainer keeps one (a bf16 weight under multi_precision), else the
    weight. Before the first step there is no state: the master a step
    starts from is the weight in fp32."""
    out = {}
    states = trainer._states if trainer is not None else {}
    for i, p in enumerate(model.collect_params().values()):
        s = states.get(i)
        w = s["master"] if isinstance(s, dict) and "master" in s else p.data()
        out[p.name[len(model.prefix):]] = _f32(w)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("bf16", [False, True])
def test_gpt_training_step_matches_jax(jax_trace_state, bf16):  # noqa: F811
    """One step on the same numpy batch, from the same weights.

    fp32 (dense attention on both sides): the loss within 1e-4, every
    gradient within 1e-4 in relative L2 (fp32 sums in another order), and
    Adam's update of every parameter's fp32 master within 1e-4 in
    relative L2, over the elements whose gradient stands above the error
    the gradient check allows (more than 90% of all elements; a
    parameter's update nonzero on every one of them).

    bf16 (the port's flash and softmax-xent plain versions against the
    JAX package's dense path and jnp loss): the same, each within 0.05.
    ``word_embed.weight``'s gradient is held in fp32 only: its rows sum
    every position's gather gradient, which the JAX side adds up in bf16
    (the gather's scatter-add VJP) and the port in fp32 (ROADMAP.md
    C.2)."""
    jm = JaxGPT(**GPT_TRAIN)
    jm.initialize()
    tm = from_jax_params(PortGPT(**GPT_TRAIN), jax_params(jm))
    if bf16:
        jamp.convert_hybrid_block(jm, "bfloat16")
        tamp.convert_hybrid_block(tm, "bfloat16")
        assert tm.word_embed.weight.dtype == torch.bfloat16
        assert tm.ln_f.gamma.dtype == torch.float32
    jtr = jgluon.Trainer(jm.collect_params(), "adam", RECIPE)
    ttr = gluon.Trainer(tm.collect_params(), "adam", RECIPE)
    inp, tgt = _tokens(0)
    jw0, tw0 = _masters(jm), _masters(tm)
    jl, jg = _jax_step(jm, jtr, inp, tgt)
    tl, tg = _port_step(tm, ttr, inp, tgt)
    tol = 0.05 if bf16 else 1e-4
    assert tl.shape == (BATCH,) and tl.dtype == np.float32
    np.testing.assert_allclose(tl, jl, atol=tol)
    assert set(jg) == set(tg)
    for name in jg:
        if bf16 and name.endswith("word_embed_weight"):
            continue
        assert _rel_l2(tg[name], jg[name]) < tol, name
    # the tied table's gradient has the head's product on rows no input
    # token gathers
    unseen = sorted(set(range(GPT_TRAIN["vocab_size"])) - set(inp.ravel()))
    word = next(n for n in tg if n.endswith("word_embed_weight"))
    assert np.abs(tg[word][unseen]).sum() > 0
    # The update each trainer made, on the fp32 masters. Adam's first step
    # moves an element by about lr * sign(g) whatever |g|, so where the
    # gradient is below its own error the two signs are a coin toss: held
    # are the elements whose gradient (as Adam takes it, with the decay
    # added) stands above the error the gradient check allows.
    jd = {n: w - jw0[n] for n, w in _masters(jm, jtr).items()}
    td = {n: w - tw0[n] for n, w in _masters(tm, ttr).items()}
    held = total = 0
    for name in jd:
        geff = jg[name] / BATCH + RECIPE["wd"] * jw0[name]
        m = np.abs(geff) > tol * np.sqrt(np.mean(geff ** 2))
        assert m.any(), name
        assert np.all(td[name][m] != 0), name
        assert _rel_l2(td[name][m], jd[name][m]) < tol, name
        held, total = held + m.sum(), total + m.size
    assert held / total > 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_loss_at_odd_vocab_matches_jax(jax_trace_state,  # noqa: F811
                                                    dtype):
    """``SoftmaxCrossEntropyLoss`` over (B, T, V) logits with V = 1001
    (odd: no row after the first starts 16-byte aligned on the card): the
    per-sample loss (the mean over T) and the logits' gradient against the
    JAX loss's, fp32 within 1e-5 and 1e-7; bf16 logits within 1e-4 and
    one bf16 step of the gradient's largest element."""
    rng = np.random.default_rng(3)
    V = GPT_TRAIN["vocab_size"]
    x = (rng.standard_normal((3, 7, V)) * 3).astype(np.float32)
    y = rng.integers(0, V, (3, 7)).astype(np.int32)
    y[0, 0] = V - 1   # a label in the last column
    jx = mx.nd.array(x).astype(dtype)
    jx.attach_grad()
    with jag.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jx, mx.nd.array(y, dtype="int32"))
    jag.backward(jl)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    with autograd.record():
        tl = gluon.loss.SoftmaxCrossEntropyLoss()(tx, torch.from_numpy(y))
    # the head's implicit gradient is ones, as jag.backward's
    (tgrad,) = torch.autograd.grad(tl, tx, torch.ones_like(tl))
    assert tl.dtype == torch.float32 and tl.shape == (3,)
    assert tgrad.dtype == tx.dtype
    jgrad = np.asarray(jx.grad.astype("float32").asnumpy())
    tgrad = tgrad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(tgrad, jgrad, atol=1e-7)
    else:
        np.testing.assert_allclose(tl.detach().numpy(),
                                   np.asarray(jl.asnumpy(), np.float32),
                                   atol=1e-4)
        np.testing.assert_allclose(tgrad, jgrad,
                                   atol=np.abs(jgrad).max() * 2.0 ** -7)


def test_the_loss_hands_the_kernel_the_logits_own_rows(monkeypatch):
    """The (B*T, V) rows ``softmax_xent_rows`` hands the kernel op's
    implementation (``IMPLS["softmax_xent_fwd"]``, behind the wrapper and
    its ``torch.library`` op) are a view of the (B, T, V) logits' own
    storage (no copy of a language model's logits). A padded vocabulary
    sliced to V reaches the implementation as it is and passes the
    kernel's check (the kernel reads each row at the view's row stride)
    with the plain version's loss and gradient of the
    same logits made contiguous; a view with strided columns is refused by
    the check, not copied."""
    seen = []
    real = sx.IMPLS["softmax_xent_fwd"]

    def spy(x, labels):
        seen.append(x)
        return real(x, labels)

    monkeypatch.setitem(sx.IMPLS, "softmax_xent_fwd", spy)
    logits = torch.randn(2, 5, 1001)
    labels = torch.randint(0, 1001, (2, 5))
    loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits, labels)
    assert loss.shape == (2,)
    (x,) = seen
    assert x.shape == (10, 1001) and x.is_contiguous()
    assert x.data_ptr() == logits.data_ptr()
    # a padded vocabulary sliced to V: rows 1008 apart
    wide = torch.randn(10, 1008)[:, :1001]
    wide.requires_grad_()
    lab = labels.reshape(-1)
    got = F.softmax_xent_rows(wide, lab)
    assert seen[-1].data_ptr() == wide.data_ptr()
    assert not seen[-1].is_contiguous()
    sx._check(wide.detach(), lab.to(torch.int32))
    (gw,) = torch.autograd.grad(got.sum(), wide)
    dense = wide.detach().contiguous().requires_grad_()
    want = F.softmax_xent_rows(dense, lab)
    (gd,) = torch.autograd.grad(want.sum(), dense)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(gw, gd, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        sx._check(torch.randn(1001, 10).t(), lab.to(torch.int32))
