"""A small GPT step (2 layers, 128 units, vocab 1001) written in MXNet's
imperative idiom on the port: tokens through ``nd.array``, ``with
autograd.record(): loss = loss_fn(net(x), y)``, ``loss.backward()``,
``trainer.step``, ``loss.mean().asscalar()``. Two steps equal the port's
tensor-path steps bit for bit (fp32 and bf16, dropout on, the same draws),
and the fp32 step matches the JAX package's NDArray step within the GPT
step's tolerances (``test_torch_port_gpt_train.py``: loss and every
gradient within 1e-4)."""
import numpy as np
import pytest
import torch

from torch_port_helpers import (few_threads, jax_params,  # noqa: F401
                                jax_trace_state)

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

T = 64
BATCH = 2
CFG = dict(vocab_size=1001, units=128, num_layers=2, num_heads=2,
           max_length=T)
RECIPE = {"learning_rate": 1e-3, "wd": 0.01, "multi_precision": True}


def _tokens(step):
    seq = np.random.default_rng(step).integers(
        0, CFG["vocab_size"], (BATCH, T + 1)).astype(np.int32)
    return seq[:, :T], seq[:, 1:]


def _port_pair(bf16, dropout):
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch.models.gpt import GPTModel

    models = []
    for _ in range(2):
        m = GPTModel(dropout=dropout, **CFG)
        m.initialize(device="cpu",
                     generator=torch.Generator().manual_seed(0))
        if bf16:
            amp.convert_hybrid_block(m, "bfloat16")
        models.append((m, gluon.Trainer(m.collect_params(), "adam",
                                        RECIPE)))
    return models


def _tensor_step(model, trainer, inp, tgt):
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(model(torch.from_numpy(inp)), torch.from_numpy(tgt))
    autograd.backward(loss)
    trainer.step(BATCH)
    return loss.detach()


def _nd_step(mx, model, trainer, inp, tgt, ctx):
    """The step as an MXNet user writes it (either package)."""
    x = mx.nd.array(inp, ctx=ctx, dtype="int32")
    y = mx.nd.array(tgt, ctx=ctx, dtype="int32")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(model(x), y)
    loss.backward()
    grads = {p.name[len(model.prefix):]: np.asarray(
        p.grad().asnumpy(), np.float32)
        for p in model.collect_params().values()}
    trainer.step(BATCH)
    return loss, loss.mean().asscalar(), grads


@pytest.mark.parametrize("bf16", [False, True])
def test_nd_step_equals_tensor_step_bitwise(bf16):
    import mxnet_tpu_torch as mx

    (tm, ttr), (nm, ntr) = _port_pair(bf16, dropout=0.1)
    for step in range(2):
        inp, tgt = _tokens(step)
        mx.random.seed(11 + step)
        lt = _tensor_step(tm, ttr, inp, tgt)
        mx.random.seed(11 + step)
        ln, mean, _ = _nd_step(mx, nm, ntr, inp, tgt, mx.cpu())
        assert isinstance(ln, mx.nd.NDArray)
        assert torch.equal(ln._data.detach(), lt), step
        assert mean == float(lt.mean())
        for a, b in zip(tm.collect_params().values(),
                        nm.collect_params().values()):
            assert torch.equal(a._tensor(), b._tensor()), (step, a.name)
        for i in ttr._states:
            for sa, sb in zip(*(torch.utils._pytree.tree_leaves(tr._states[i])
                                for tr in (ttr, ntr))):
                assert torch.equal(sa, sb), (step, i)


def test_nd_step_matches_jax_nd_step(jax_trace_state):  # noqa: F811
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx
    from mxnet_tpu.models.gpt import GPTModel as JaxGPT
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.gpt import GPTModel as PortGPT

    jm = JaxGPT(dropout=0.0, **CFG)
    jm.initialize()
    tm = from_jax_params(PortGPT(dropout=0.0, **CFG), jax_params(jm))
    jtr = jmx.gluon.Trainer(jm.collect_params(), "adam", RECIPE)
    ttr = tmx.gluon.Trainer(tm.collect_params(), "adam", RECIPE)
    for step in range(2):
        inp, tgt = _tokens(step)
        jl, jmean, jg = _nd_step(jmx, jm, jtr, inp, tgt, None)
        tl, tmean, tg = _nd_step(tmx, tm, ttr, inp, tgt, tmx.cpu())
        np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), atol=1e-4)
        assert abs(tmean - jmean) <= 1e-4
        assert set(tg) == set(jg)
        for name in jg:
            rel = np.linalg.norm(tg[name] - jg[name]) / max(
                np.linalg.norm(jg[name]), 1e-30)
            assert rel < 1e-4, (step, name, rel)
