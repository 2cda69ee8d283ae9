"""The port's training path against the JAX package's: autograd's record /
backward contract, ``grad_req``, Dropout, Adam with ``multi_precision``,
``gluon.Trainer``, and one whole BERT pretraining step.

Inputs and weights are seeded numpy arrays handed to both packages (the
port's BERT takes the JAX model's weights through ``from_jax_params``); the
JAX side runs on the CPU through its own Gluon path
(``autograd.record`` -> loss -> ``backward`` -> ``Trainer.step``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.models.bert import BERTModel as JaxBERT
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd, gluon, optimizer
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.bert import BERTModel as PortBERT
from mxnet_tpu_torch.ops import functional as F
from torch_port_helpers import SMALL_BERT, jax_params, jax_trace_state  # noqa: F401


def _dense(grad_req="write"):
    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    if grad_req != "write":
        for p in net.collect_params().values():
            p.grad_req = grad_req
    return net


# ---------------------------------------------------------- autograd


def test_no_graph_outside_record_and_flags():
    net = _dense()
    x = torch.randn(2, 4)
    assert not net(x).requires_grad
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert net(x).requires_grad
        with autograd.pause():
            assert not autograd.is_recording()
            assert not net(x).requires_grad
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.record(train_mode=False):
        assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()


def test_backward_of_nonscalar_head_uses_ones():
    """MXNet's implicit head gradient: a per-sample loss backs up as its
    sum does (torch's own Tensor.backward() refuses a non-scalar head)."""
    net = _dense()
    x = torch.randn(5, 4)
    with autograd.record():
        y = net(x)
    autograd.backward(y)
    got = net.weight._tensor().grad.clone()
    with autograd.record():
        y = net(x).sum()
    autograd.backward(y)
    torch.testing.assert_close(got, net.weight._tensor().grad)
    torch.testing.assert_close(got, torch.ones(5, 3).t() @ x)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_grad_req_write_add_null(grad_req):
    """``write`` gives the same gradient after two backwards without
    zero_grad; ``add`` gives twice it; ``null`` keeps no gradient (and the
    tensor is not a grad-requiring leaf)."""
    net = _dense(grad_req)
    x = torch.randn(2, 4)
    w = net.weight
    assert w._tensor().is_leaf
    assert w._tensor().requires_grad == (grad_req != "null")
    grads = []
    for _ in range(2):
        with autograd.record():
            y = (net(x) * 2.0).sum()
        if grad_req == "null":
            with pytest.raises(RuntimeError):
                autograd.backward(y)
            assert w._tensor().grad is None
            return
        autograd.backward(y)
        grads.append(w._tensor().grad.clone())
    once = 2.0 * torch.ones(2, 3).t() @ x
    torch.testing.assert_close(grads[0], once)
    torch.testing.assert_close(grads[1], once if grad_req == "write"
                               else 2 * once)
    w.zero_grad()
    assert not w._tensor().grad.any()


def test_parameter_stays_a_leaf_through_cast_and_set_data():
    net = _dense()
    w = net.weight
    w.cast("bfloat16")
    assert w._tensor().dtype == torch.bfloat16 and w._tensor().is_leaf
    assert w._tensor().requires_grad
    assert w._tensor().grad.dtype == torch.bfloat16
    src = torch.randn(3, 4)
    w.set_data(src)
    assert w._tensor().is_leaf and w._tensor().requires_grad
    with torch.no_grad():
        w._tensor().add_(1.0)  # the optimizer updates in place
    assert not torch.equal(src.to(torch.bfloat16), w._tensor())  # no aliasing


# ---------------------------------------------------------- Dropout


def test_dropout_scaling_keep_fraction_and_seed():
    x = torch.ones(200, 500)
    mx_random.seed(3)
    y1 = F.Dropout(x, p=0.1, training=True)
    mx_random.seed(3)
    y2 = F.Dropout(x, p=0.1, training=True)
    assert torch.equal(y1, y2)  # the same seed gives the same mask
    assert not torch.equal(F.Dropout(x, p=0.1, training=True), y1)
    kept = y1 != 0
    # inverted dropout: kept values are x / keep, in x's dtype
    assert torch.equal(y1[kept], torch.full_like(y1[kept], 1 / 0.9))
    frac = float(kept.float().mean())
    assert abs(frac - 0.9) < 4 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.equal(F.Dropout(x, p=0.1, training=False), x)
    xb = x.to(torch.bfloat16)
    assert F.Dropout(xb, p=0.5, training=True).dtype == torch.bfloat16


def test_dropout_block_follows_record_and_random_seed():
    drop = gluon.nn.Dropout(0.5)
    x = torch.ones(64, 64)
    assert torch.equal(drop(x), x)  # predict mode outside record()
    outs = []
    for _ in range(2):
        mx_random.seed(11)
        with autograd.record():
            outs.append(drop(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], x)


# ---------------------------------------------------------- Adam


def _adam_case(step):
    rng = np.random.RandomState(step)
    weights = [rng.randn(3, 4).astype(np.float32),
               rng.randn(5).astype(np.float32),
               rng.randn(2, 3).astype(np.float32)]
    grads = [rng.randn(*w.shape).astype(np.float32) * 3 for w in weights]
    return weights, grads


@pytest.mark.parametrize("steps", [1, 2])
def test_adam_multi_precision_matches_jax(jax_trace_state,  # noqa: F811
                                          steps):
    """fp32 and bf16 weights (the latter with fp32 masters) through both
    packages' fused step, with rescale, clipping, wd and an lr multiplier:
    fp32 weights, masters and moments within 1e-6; bf16 weights within one
    bf16 step of each other."""
    kw = dict(learning_rate=1e-3, wd=0.01, rescale_grad=0.5,
              clip_gradient=2.0, multi_precision=True)
    jopt = mx.optimizer.Adam(**kw)
    topt = optimizer.create("adam", **kw)
    for o in (jopt, topt):
        o.set_lr_mult({1: 0.5})
    dtypes = ["float32", "bfloat16", "bfloat16"]
    w0, _ = _adam_case(0)
    jw = [mx.nd.NDArray(jnp.asarray(w, getattr(jnp, d)))
          for w, d in zip(w0, dtypes)]
    tw = [torch.from_numpy(w).to(getattr(torch, d))
          for w, d in zip(w0, dtypes)]
    jst = [jopt.create_state(i, w) for i, w in enumerate(jw)]
    tst = [topt.create_state(i, w) for i, w in enumerate(tw)]
    for step in range(steps):
        _, grads = _adam_case(step + 1)
        jst = jopt.fused_update(jw, [jnp.asarray(g, w.dtype) for g, w in
                                     zip(grads, jw)], jst, indices=[0, 1, 2])
        tst = topt.fused_update(tw, [torch.from_numpy(g).to(w.dtype) for g, w
                                     in zip(grads, tw)], tst,
                                indices=[0, 1, 2])
    for j, t in zip(jw, tw):
        got, want = t.float().numpy(), np.asarray(j.asnumpy(), np.float32)
        if t.dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -7)
    for j, t in zip(jst, tst):
        jm = j if not isinstance(j, dict) else j["state"]
        tm = t if not isinstance(t, dict) else t["state"]
        if isinstance(t, dict):
            np.testing.assert_allclose(t["master"].numpy(),
                                       np.asarray(j["master"]), atol=1e-6)
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert topt.num_update == jopt.num_update == steps


def test_trainer_refuses_what_is_not_ported():
    params = _dense().collect_params()
    # the asynchronous kvstore is refused in both packages; the dist
    # kvstores, compression and weight-update sharding are ported
    # (test_torch_port_kvstore.py, test_torch_port_dist.py)
    with pytest.raises(ValueError, match="asynchronous"):
        gluon.Trainer(params, "adam", kvstore="dist_async")
    with pytest.warns(UserWarning, match="compression_params ignored"):
        gluon.Trainer(params, "adam", compression_params={"type": "2bit"})
    trainer = gluon.Trainer(params, "adam", kvstore="local")
    trainer.set_weight_update_sharding(None)
    assert trainer._kvstore is None
    # every optimizer the JAX package registers is ported; a name neither
    # package registers is refused
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizer.create("nadam")


def test_trainer_skips_null_params_and_sets_learning_rate():
    net = _dense()
    net.bias.grad_req = "null"
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.1})
    bias = net.bias._tensor().clone()
    weight = net.weight._tensor().detach().clone()
    with autograd.record():
        loss = net(torch.randn(4, 4)).sum()
    autograd.backward(loss)
    trainer.step(4)
    assert torch.equal(net.bias._tensor(), bias)
    assert not torch.equal(net.weight._tensor(), weight)
    trainer.set_learning_rate(0.01)
    assert trainer.learning_rate == 0.01


# ---------------------------------------------------------- whole step


def _batch(seed, B, T, P, vl):
    rng = np.random.RandomState(seed)
    V = SMALL_BERT["vocab_size"]
    return (rng.randint(0, V, (B, T)).astype(np.int32),
            rng.randint(0, 2, (B, T)).astype(np.int32),
            np.asarray(vl, np.float32),
            rng.randint(0, T, (B, P)).astype(np.int32),
            rng.randint(0, V, (B, P)).astype(np.int32),
            rng.randint(0, 2, (B,)).astype(np.int32))


def _jax_step(model, trainer, batch):
    tok, tt, vl, mp, mlm_y, nsp_y = batch
    mlm_loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        _, _, nsp, mlm = model(mx.nd.array(tok, dtype="int32"),
                               mx.nd.array(tt, dtype="int32"),
                               mx.nd.array(vl),
                               mx.nd.array(mp, dtype="int32"))
        loss = mlm_loss(mlm, mx.nd.array(mlm_y, dtype="int32")) + \
            nsp_loss(nsp, mx.nd.array(nsp_y, dtype="int32"))
    jag.backward(loss)
    grads = {p.name[len(model.prefix):]: np.asarray(p.grad().asnumpy(),
                                                    np.float32)
             for p in model.collect_params().values()}
    trainer.step(tok.shape[0])
    return np.asarray(loss.asnumpy(), np.float32), grads


def _port_step(model, trainer, batch):
    tok, tt, vl, mp, mlm_y, nsp_y = (torch.from_numpy(a) for a in batch)
    mlm_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    nsp_loss = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        _, _, nsp, mlm = model(tok, tt, vl, mp)
        loss = mlm_loss(mlm, mlm_y) + nsp_loss(nsp, nsp_y)
    autograd.backward(loss)
    grads = {p.name[len(model.prefix):]:
             p._tensor().grad.float().numpy().copy()
             for p in model.collect_params().values()}
    trainer.step(tok.shape[0])
    return loss.detach().float().numpy(), grads


def _params(model):
    return {p.name[len(model.prefix):]: np.asarray(
        p.data().detach().float().numpy() if isinstance(p.data(), torch.Tensor)
        else p.data().asnumpy(), np.float32)
        for p in model.collect_params().values()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("bf16", [False, True])
def test_bert_training_step_matches_jax(jax_trace_state, bf16):  # noqa: F811
    """Two pretraining steps of a small BERT (2 layers, 128 units, 2 heads
    of 64, vocab 1000, dropout 0) through both packages' Gluon paths:
    record -> MLM + NSP SoftmaxCrossEntropyLoss -> backward ->
    Trainer("adam", multi_precision=True).step.

    fp32 at seq 64 (dense attention on both sides): the losses within 1e-4
    and every gradient within 2e-3 in relative L2 (fp32 sums in another
    order; measured about 1e-6), the weights after two steps within 1e-4
    (lr 1e-4: Adam's first steps move a weight by about lr whatever the
    gradient's size, so a sign flip of a gradient near zero moves it by
    2 lr).

    bf16 at seq 256, where the port takes the flash path (its plain versions
    here) and the JAX package the dense path: the losses within 0.05 and
    each gradient within 0.08 in relative L2, the two rounding bf16 at
    different places. The token-type table is held to fp32 only: its row
    gradient sums every token's, which the JAX side adds up in bf16 (the
    gather's scatter-add VJP) and the port in fp32."""
    T, B, vl = (256, 1, [200]) if bf16 else (64, 4, [64, 40, 64, 1])
    cfg = dict(SMALL_BERT, max_length=T, dropout=0.0)
    jm = JaxBERT(**cfg)
    jm.initialize()
    if bf16:
        jamp.convert_hybrid_block(jm, "bfloat16")
    tm = from_jax_params(PortBERT(**cfg), jax_params(jm))
    if bf16:
        assert tm.word_embed.weight.dtype == torch.bfloat16
    opt = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}
    jtr = jgluon.Trainer(jm.collect_params(), "adam", opt)
    ttr = gluon.Trainer(tm.collect_params(), "adam", opt)
    for step in range(2):
        batch = _batch(step, B, T, 7, vl)
        jl, jg = _jax_step(jm, jtr, batch)
        tl, tg = _port_step(tm, ttr, batch)
        np.testing.assert_allclose(tl, jl, atol=0.05 if bf16 else 1e-4)
        assert set(jg) == set(tg)
        for name in jg:
            if bf16 and name.endswith("token_type_embed_weight"):
                continue
            assert _rel_l2(tg[name], jg[name]) < (0.08 if bf16 else 2e-3), \
                name
    if not bf16:
        jp, tp = _params(jm), _params(tm)
        for name in jp:
            np.testing.assert_allclose(tp[name], jp[name], atol=1e-4,
                                       err_msg=name)


def test_amp_training_with_dropout_gives_every_gradient():
    """bf16 via amp with dropout 0.1 in train mode: the loss is fp32 per
    sample, the norms' gradients fp32, every parameter gets a gradient
    (decoder_bias too), the tied decoder weight gets the MLM head's use on
    rows no input token touches, and the dropout masks follow the seed."""
    model = PortBERT(**dict(SMALL_BERT, dropout=0.1))
    model.initialize(device="cpu")
    tamp.convert_hybrid_block(model, "bfloat16")
    tok, tt, vl, mp, mlm_y, nsp_y = (torch.from_numpy(a) for a in
                                     _batch(0, 2, 64, 3, [64, 9]))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for seed in (1, 1, 2):
        mx_random.seed(seed)
        with autograd.record():
            _, _, nsp, mlm = model(tok, tt, vl, mp)
            loss = loss_fn(mlm, mlm_y) + loss_fn(nsp, nsp_y)
        losses.append(loss.detach())
    assert torch.equal(losses[0], losses[1])
    assert not torch.equal(losses[0], losses[2])
    assert loss.dtype == torch.float32 and loss.shape == (2,)
    autograd.backward(loss)
    for p in model.collect_params().values():
        assert p._tensor().grad.any(), p.name
        assert bool(torch.isfinite(p._tensor().grad).all()), p.name
    assert model.encoder.ln.gamma._tensor().grad.dtype == torch.float32
    unseen = sorted(set(range(SMALL_BERT["vocab_size"]))
                    - set(tok.flatten().tolist()))
    assert model.word_embed.weight._tensor().grad[unseen].any()
