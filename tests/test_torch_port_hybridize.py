"""``HybridBlock.hybridize()`` and the Trainer's step program on the CPU,
where each program runs its call eagerly with the same keys and counts as
on a card (``gluon/hybrid.py``, ``optimizer.StepProgram``):

- a Dense stack with BatchNorm, a small BERT and a small GPT hybridized,
  their forwards and gradients against the JAX package's hybridized
  blocks (``tests/test_gluon.py``'s ``test_hybridize_matches_imperative``
  and ``test_grad_through_hybridized``) at the JAX tests' 1e-5, and bit
  for bit against the port's eager calls;
- the program keys (the training flag, whether the call differentiates,
  the inputs' signature), a new key on a new shape, and the drops on
  ``cast``, ``hybridize`` and ``set_data`` (``copy_data`` keeps them);
- ``autograd.grad(create_graph=True)`` through a hybridized block against
  the JAX package (``tests/test_autograd.py``
  ``test_create_graph_through_hybridized_block``), counted;
- ``random.seed`` dropping the programs; two shapes and a predict call
  between the forwards and one backward;
- ``grad_req="add"`` across two backward calls;
- the step program's device-side rate and update counts against an
  ``lr_scheduler`` across its boundary (bit for bit against the eager
  Trainer, 1e-5 against the JAX Trainer), and the capture counts of a
  training loop;
- the refusals, and ``chip_smoke.py``'s ``phase_hybridize`` rehearsed at
  a small size (only its launch checks fail here).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd, gluon, lr_scheduler, nd
from mxnet_tpu_torch.gluon import nn
from torch_port_helpers import (SMALL_BERT, SMALL_GPT, bert_inputs,  # noqa: F401
                                few_threads, jax_bert, jax_gpt,
                                jax_trace_state, port_bert_from,
                                port_gpt_from)

pytestmark = pytest.mark.usefixtures("jax_trace_state", "few_threads")


def _stack(pkg):
    net = pkg.nn.HybridSequential()
    net.add(pkg.nn.Dense(32, activation="relu", in_units=16),
            pkg.nn.BatchNorm(in_channels=32), pkg.nn.Dense(4, in_units=32))
    return net


def _jax_stack():
    jmx.random.seed(0)
    net = _stack(jgluon)
    net.initialize()
    return net


def _port_stack(jnet):
    """The port's stack on the CPU with the JAX stack's values, by
    structural name (BatchNorm's running statistics too)."""
    net = _stack(gluon)
    net.initialize(device="cpu")
    theirs = jnet._collect_params_with_prefix()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(torch.from_numpy(theirs[k].data().asnumpy()))
    return net


def _jax_run(net, args, ct, train):
    """(the predict-mode output, the recorded output (in training mode with
    ``train``) and every parameter's gradient of sum(out * ct)) of a JAX
    block."""
    pred = net(*[jmx.nd.array(a) for a in args])
    pred = pred[0] if isinstance(pred, tuple) else pred
    with jautograd.record(train_mode=train):
        out = net(*[jmx.nd.array(a) for a in args])
        out = out[0] if isinstance(out, tuple) else out
        loss = (out * jmx.nd.array(ct)).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return pred.asnumpy(), out.asnumpy(), grads


def _port_run(net, args, ct, train):
    ts = [torch.from_numpy(np.asarray(a)) for a in args]
    for p in net.collect_params().values():
        p.zero_grad()
    with torch.no_grad():
        pred = net(*ts)
    pred = pred[0] if isinstance(pred, tuple) else pred
    with autograd.record(train_mode=train):
        out = net(*ts)
        out = out[0] if isinstance(out, tuple) else out
        loss = (out * torch.from_numpy(ct)).sum()
    autograd.backward(loss)
    grads = {k: p._tensor().grad.numpy().copy()
             for k, p in net._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return pred.detach().numpy(), out.detach().numpy(), grads


CASES = ("stack", "bert", "gpt")


def _case(name):
    rng = np.random.default_rng(1)
    if name == "stack":
        jnet = _jax_stack()
        return jnet, _port_stack, [rng.normal(size=(8, 16)).astype(
            np.float32)], (8, 4)
    if name == "bert":
        jnet = jax_bert(False)
        tok, tt, vl = bert_inputs(2, 2, seq=16)
        return jnet, port_bert_from, [tok, tt, vl], (2, 16, 128)
    jnet = jax_gpt()
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    return jnet, port_gpt_from, [toks], (2, 16, 256)


@pytest.mark.parametrize("name", CASES)
def test_hybridized_matches_jax_and_eager(name):
    """Predict-mode outputs, recorded outputs and gradients of the
    hybridized block against the JAX package's hybridized block (1e-5;
    each gradient within 1e-4 relative and 1e-5 of its largest magnitude)
    and bit for bit against the port's own eager calls. The stack records
    in training mode (BatchNorm's batch statistics); BERT and the GPT in
    predict mode (their dropout draws differ between the packages)."""
    jnet, make, args, out_shape = _case(name)
    train = name == "stack"
    ct = np.random.default_rng(2).normal(size=out_shape).astype(np.float32)
    # two copies: a training call moves BatchNorm's running statistics
    eager = _port_run(make(jnet), args, ct, train)
    tnet = make(jnet)
    tnet.hybridize()
    got = _port_run(tnet, args, ct, train)
    jnet.hybridize()
    want = _jax_run(jnet, args, ct, train)
    np.testing.assert_array_equal(got[0], eager[0])
    np.testing.assert_array_equal(got[1], eager[1])
    for k in got[2]:
        np.testing.assert_array_equal(got[2][k], eager[2][k])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    for k, g in got[2].items():  # by structural name
        w = want[2][k]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(
            1.0, float(np.abs(w).max())), err_msg=k)
    st = tnet.hybrid_stats()
    # the predict call and the recorded call: two keys, one backward
    assert (st["forward_captures"], st["backward_captures"],
            st["forward_replays"], st["backward_replays"]) == (2, 1, 2, 1)


def test_keys_new_shapes_and_drops():
    """A key is (training, differentiates, signature): the same call
    replays, a recorded call and a new shape capture anew; cast,
    hybridize and set_data drop every program (a key captured again is a
    recapture), copy_data keeps them."""
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16),
            nn.Dense(4, in_units=32))
    net.initialize(device="cpu")
    net.hybridize()
    x = torch.randn(8, 16)

    def st():
        s = net.hybrid_stats()
        return (s["forward_captures"], s["recaptures"], s["drops"])

    with torch.no_grad():
        net(x)
        net(x)
    assert st() == (1, 0, 0)
    assert net.hybrid_stats()["forward_replays"] == 2
    with autograd.record():
        net(x)
    with autograd.record(train_mode=False):
        net(x)
    assert st() == (3, 0, 0)
    with torch.no_grad():
        net(torch.randn(4, 16))
        net(torch.randn(8, 16, dtype=torch.float64).float())
    assert st() == (4, 0, 0)
    w = net[0].weight
    w.copy_data(w._tensor().detach() * 2)
    with torch.no_grad():
        net(x)
    assert st() == (4, 0, 0)
    w.set_data(w._tensor().detach() * 0.5)
    with torch.no_grad():
        net(x)
    assert st() == (5, 1, 1)
    net.hybridize()
    with torch.no_grad():
        net(x)
    assert st() == (6, 2, 2)
    net.cast("float64")
    with torch.no_grad():
        out = net(x.double())
    assert out.dtype == torch.float64 and st() == (7, 2, 3)
    net.hybridize(False)
    with torch.no_grad():
        net(x.double())
    assert st() == (7, 2, 4)


def test_seed_drops_the_programs():
    """``random.seed`` gives the device a new generator, which the graphs
    do not draw from: the next call drops every program and captures
    again, at each seed (the same value too); calls between seeds
    replay."""
    from mxnet_tpu_torch import random as mx_random

    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=16), nn.Dropout(0.5))
    net.initialize(device="cpu")
    net.hybridize()
    x = torch.randn(4, 16)

    def st():
        s = net.hybrid_stats()
        return (s["forward_captures"], s["recaptures"], s["drops"])

    with autograd.record():
        net(x)
        net(x)
    assert st() == (1, 0, 0)
    for n in (1, 2):
        mx_random.seed(7)
        with autograd.record():
            net(x)
            net(x)
        assert st() == (1 + n, n, n)


def test_keys_interleaved_before_one_backward():
    """Two shapes forwarded under one ``record``, then a predict call of a
    third before the one backward (on a card each program has a memory
    pool of its own, so no key's graph overwrites another's saved
    activations): the gradients equal the eager calls' bit for bit; one
    backward replay for each recorded key."""
    jnet = _jax_stack()
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
          for n in (8, 4, 2)]
    got = []
    for hyb in (False, True):
        net = _port_stack(jnet)
        if hyb:
            net.hybridize()
        with autograd.record(train_mode=False):
            la = net(xs[0]).sum()
            lb = (net(xs[1]) ** 2).sum()
        with torch.no_grad():
            net(xs[2])
        autograd.backward(la + lb)
        got.append({k: p._tensor().grad.clone()
                    for k, p in net._collect_params_with_prefix().items()
                    if p.grad_req != "null"})
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
    st = net.hybrid_stats()
    assert (st["forward_captures"], st["backward_captures"],
            st["forward_replays"], st["backward_replays"]) == (3, 2, 3, 2)


def test_create_graph_through_hybridized_block_matches_jax():
    """The JAX test's case: gx = w broadcast, d(gx . gx)/dw = 4 w; the
    second order takes the block's eager forward, counted."""
    xv = np.array([[1.0, -2.0, 0.5], [0.3, 0.7, -1.1]], np.float32)
    jnet = jgluon.nn.Dense(1, in_units=3, use_bias=False)
    jnet.initialize()
    jnet.hybridize()
    jx = jmx.nd.array(xv)
    with jautograd.record():
        out = jnet(jx)
        (jgx,) = jautograd.grad(out.sum(), [jx], create_graph=True)
        loss = (jgx * jgx).sum()
    loss.backward()
    import mxnet_tpu_torch as tmx

    net = gluon.nn.Dense(1, in_units=3, use_bias=False)
    net.initialize(device="cpu")
    net.weight.set_data(torch.from_numpy(jnet.weight.data().asnumpy()))
    net.hybridize()
    x = nd.array(xv, ctx=tmx.cpu())
    with autograd.record():
        out = net(x)
        (gx,) = autograd.grad(out.sum(), [x], create_graph=True)
        loss = (gx * gx).sum()
    loss.backward()
    np.testing.assert_allclose(gx.asnumpy(), jgx.asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               jnet.weight.grad().asnumpy(), rtol=1e-5)
    assert net.hybrid_stats()["eager_second_order"] == 1


def test_grad_req_add_accumulates_across_backwards():
    jnet = _jax_stack()
    x = torch.randn(8, 16)
    got = []
    for req in ("write", "add"):
        net = _port_stack(jnet)
        net.hybridize()
        for p in net.collect_params().values():
            if p.grad_req != "null":
                p.grad_req = req
        for _ in range(2):
            with autograd.record():
                loss = net(x).sum()
            autograd.backward(loss)
        got.append(net[0].weight._tensor().grad.clone())
    np.testing.assert_allclose(got[1].numpy(), 2 * got[0].numpy(),
                               rtol=1e-6, atol=1e-7)


def _train(net, trainer, x, y, steps):
    lossf = gluon.loss.SoftmaxCrossEntropyLoss()
    lrs = []
    for _ in range(steps):
        with autograd.record():
            loss = lossf(net(x), y)
        autograd.backward(loss)
        trainer.step(x.shape[0])
        lrs.append(trainer.learning_rate)
    return lrs


def test_step_program_follows_the_scheduler():
    """Adam under FactorScheduler(step=2, factor=0.5) for 5 steps: the
    hybridized block's Trainer runs one step program (captured once,
    replayed each step) whose device-side rate and bias corrections move
    with the schedule: the weights equal the eager Trainer's bit for bit
    and the JAX Trainer's within 1e-5."""
    jnet = _jax_stack()
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(8, 16)).astype(np.float32)
    yv = rng.integers(0, 4, 8).astype(np.int32)
    x, y = torch.from_numpy(xv), torch.from_numpy(yv)
    out = []
    for hyb in (False, True):
        net = _port_stack(jnet)
        tr = gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": 0.01, "lr_scheduler":
                lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                             base_lr=0.01)})
        if hyb:
            net.hybridize()
        lrs = _train(net, tr, x, y, 5)
        out.append([p._tensor().detach().clone()
                    for p in net.collect_params().values()])
        if hyb:
            assert tr.graph_stats() == {"captures": 1, "replays": 5,
                                        "recaptures": 0}
            # the rate of the last run, as the program's buffer holds it
            assert float(tr._program._scal[0, 0]) == np.float32(lrs[-1])
        else:
            assert tr.graph_stats() is None
    assert lrs[0] != lrs[-1]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", {
        "learning_rate": 0.01, "lr_scheduler":
            jmx.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                             base_lr=0.01)})
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(5):
        with jautograd.record():
            loss = jloss(jnet(jmx.nd.array(xv)), jmx.nd.array(yv))
        loss.backward()
        jtr.step(8)
    for k, p in jnet._collect_params_with_prefix().items():
        t = net._collect_params_with_prefix()[k]._tensor()
        np.testing.assert_allclose(t.detach().numpy(), p.data().asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_training_loop_capture_counts():
    """The JAX package's counter invariants as capture counts: one forward
    and one backward capture, one optimizer capture, a replay of each a
    step and no recapture in the steady state, a rate change included;
    another batch size (the rescale) captures the optimizer step again."""
    net = _port_stack(_jax_stack())
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    net.hybridize()
    x, y = torch.randn(8, 16), torch.randint(0, 4, (8,))
    _train(net, tr, x, y, 2)
    tr.set_learning_rate(0.05)
    _train(net, tr, x, y, 2)
    st = net.hybrid_stats()
    assert (st["forward_captures"], st["backward_captures"],
            st["forward_replays"], st["backward_replays"],
            st["recaptures"]) == (1, 1, 4, 4, 0)
    assert tr.graph_stats() == {"captures": 1, "replays": 4,
                                "recaptures": 0}
    _train(net, tr, x[:4], y[:4], 1)
    assert tr.graph_stats() == {"captures": 2, "replays": 5,
                                "recaptures": 1}
    # an optimizer the program cannot capture steps eagerly
    tr2 = gluon.Trainer(net.collect_params(), "lamb", {"learning_rate": 0.1})
    _train(net, tr2, x, y, 1)
    assert tr2.graph_stats() is None


def test_refusals():
    """A hybridized block on a device that is neither a card nor the CPU
    raises; the vocabulary-parallel loss on one raises in the kernel's
    wrapper (no fallback to the plain version); a hybridized block takes
    positional inputs only."""
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    net = _port_stack(_jax_stack())
    net.hybridize()
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        net(torch.empty(8, 16, device="meta"))
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tp.vocab_parallel_xent([x], torch.zeros(4, dtype=torch.int32,
                                                device="meta"), [0])
    with pytest.raises(TypeError, match="positionally"):
        net(x=torch.randn(8, 16))


def test_phase_hybridize_rehearsal(monkeypatch):
    """``chip_smoke.phase_hybridize`` on a 2-layer GPT (128 units, batch 2
    of 64): every check holds but the launch counts, which read 0 without
    the kernels."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, units=128, num_layers=2, num_heads=2,
        vocab_size=1001))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 2, "seq": 64})
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launches" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    r = cs.phase_hybridize(torch.device("cpu"))
    assert r["first_loss_bitwise"] and r["lr_change_took"]
    assert r["replay_masks_differ"] and r["differs"] == 0
    assert r["grads"]["worst_grad_rel_l2"] == 0
    assert failed and all("launches" in w for w in failed)
