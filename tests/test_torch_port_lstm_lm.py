"""The LSTM PTB language model of the port against the JAX package's, on a
small tied ``RNNModel`` (vocabulary 50, 2 x 16 LSTM), weights carried
with ``from_jax_params``: one training step at ``bench.py``'s recipe
(the mean of ``softmax_xent_rows`` over the (T, N, V) logits, SGD lr 1.0
through ``gluon.Trainer``): the loss, every gradient and every updated
weight at fp32 1e-5 of the largest element (the tied table's gradient
gathers the embedding's and the decoder's); the same in bf16 via amp with
fp32 masters within 0.05; and the stateful evaluation idiom in predict
mode (``begin_state``, three chunks with the states carried) equal to the
JAX package's and to one forward over the whole sequence."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu.models.lstm_lm import RNNModel as JRNNModel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.lstm_lm import RNNModel, lstm_ptb
from mxnet_tpu_torch.ops import F
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = dict(vocab_size=50, num_embed=16, num_hidden=16, num_layers=2,
             dropout=0.0, tie_weights=True)
T, N = 7, 3


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


def _pair(bf16):
    jm = JRNNModel("lstm", **SMALL)
    jm.initialize()
    if bf16:
        jamp.convert_hybrid_block(jm, "bfloat16")
    tm = RNNModel("lstm", **SMALL)
    if bf16:
        tamp.convert_hybrid_block(tm, "bfloat16")
    from_jax_params(tm, jax_params(jm))
    return jm, tm


@pytest.mark.parametrize("bf16,tol", [(False, 1e-5), (True, 0.05)],
                         ids=["fp32", "bf16"])
def test_train_step_matches_jax(jax_trace_state, bf16, tol):  # noqa: F811
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 50, (T, N)).astype(np.int32)
    lab = rs.randint(0, 50, (T, N)).astype(np.int32)
    jm, tm = _pair(bf16)
    assert not hasattr(tm, "decoder")  # tied
    opt = {"learning_rate": 1.0, "multi_precision": bf16}
    jt = jmx.gluon.Trainer(jm.collect_params(), "sgd", opt)
    tt = gluon.Trainer(tm.collect_params(), "sgd", opt)
    with jag.record():
        jl = jmx.nd.mean(jmx.nd.softmax_xent_rows(jm(jmx.nd.array(tok)),
                                                  jmx.nd.array(lab)))
    jl.backward()
    jt.step(1)
    with autograd.record():
        tl = F.softmax_xent_rows(tm(torch.from_numpy(tok)),
                                 torch.from_numpy(lab)).mean()
    autograd.backward(tl)
    tt.step(1)
    _close(tl, jl.asnumpy(), tol, "loss")
    tparams = tm.collect_params()
    for name, p in jm.collect_params().items():
        tp = tparams[tm.prefix + name[len(jm.prefix):]]
        _close(tp.grad()._data, p.grad().asnumpy(), tol, name + " grad")
        _close(tp._tensor(), p.data().asnumpy(), tol, name + " updated")


def test_stateful_forward_matches_jax(jax_trace_state):  # noqa: F811
    """Predict mode, three chunks of 4 tokens with the states carried,
    against the JAX package's and against one forward over the 12."""
    rs = np.random.RandomState(1)
    tok = rs.randint(0, 50, (12, N)).astype(np.int32)
    jm, tm = _pair(False)
    jst = jm.begin_state(N)
    with tmx.cpu():
        tst = tm.begin_state(N)
    assert len(tst) == 2 and isinstance(tst[0], tmx.NDArray)
    chunks = []
    for i in range(3):
        x = tok[4 * i:4 * i + 4]
        jy, jst = jm(jmx.nd.array(x), jst)
        with tmx.cpu():
            ty, tst = tm(tmx.nd.array(x, dtype="int32"), tst)
        _close(ty._data, jy.asnumpy(), 1e-5, "chunk %d" % i)
        for t, j in zip(tst, jst):
            _close(t._data, j.asnumpy(), 1e-5, "chunk %d state" % i)
        chunks.append(ty._data)
    whole = tm(torch.from_numpy(tok))
    _close(torch.cat(chunks), whole.detach().numpy(), 1e-5, "whole")


def test_lstm_ptb_is_bench_recipe():
    """``lstm_ptb``: 2 x 650 over a 650-wide embedding, tied, vocabulary
    10000: 6.5M embedding and 6.8M recurrent parameters."""
    m = lstm_ptb(vocab_size=10000, tie_weights=True, dropout=0.5)
    m.initialize(device="cpu")
    shapes = {n[len(m.prefix):]: p.shape
              for n, p in m.collect_params().items()}
    assert shapes["word_embed_weight"] == (10000, 650)
    assert shapes["lstm0_l0_i2h_weight"] == (2600, 650)
    assert shapes["lstm0_l1_h2h_weight"] == (2600, 650)
    assert len(shapes) == 9
