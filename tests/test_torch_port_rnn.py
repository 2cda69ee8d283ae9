"""The port's fused recurrence and ``gluon.rnn`` against the JAX package's,
weights carried with ``from_jax_params``: the ``RNN`` op in every mode,
bidirectional, two layers and NTC, forward and gradients at fp32 1e-5 of
the largest element; in bf16 the dtype rule (``h`` in the input's dtype,
an fp32 ``c0`` keeps ``c`` and ``cn`` in fp32) and values within 0.05;
``begin_state`` and NDArray states through a layer; dropout's draws (the
cells are ``test_torch_port_rnn_cells.py``)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import rnn as jrnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import rnn
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5
BF16_TOL = 0.05


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.asnumpy(), np.float32)


def _close(got, want, what="", tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [y for o in out for y in _flat(o)]
    return [out]


LAYERS = [
    ("LSTM", dict(hidden_size=5, num_layers=2, bidirectional=True), "TNC",
     True),
    ("LSTM", dict(hidden_size=4, layout="NTC"), "NTC", False),
    ("GRU", dict(hidden_size=5, num_layers=2), "TNC", False),
    ("GRU", dict(hidden_size=3, bidirectional=True, layout="NTC"), "NTC",
     True),
    ("RNN", dict(hidden_size=4, activation="tanh", num_layers=2), "TNC",
     True),
    ("RNN", dict(hidden_size=4, bidirectional=True), "TNC", False),
]


@pytest.mark.parametrize("cls,kw,layout,with_states", LAYERS,
                         ids=["%s%d" % (c[0], i) for i, c in
                              enumerate(LAYERS)])
def test_layer_matches_jax(jax_trace_state, cls, kw, layout,  # noqa: F811
                           with_states):
    """Forward (output and states) and every parameter's gradient, the
    deferred input width inferred at the first forward."""
    rs = np.random.RandomState(3)
    T, N, C = 6, 3, 4
    x = rs.randn(*((T, N, C) if layout == "TNC" else (N, T, C))).astype(
        np.float32)
    jb = getattr(jrnn, cls)(**kw)
    jb.initialize()
    tb = getattr(rnn, cls)(**kw)
    if with_states:
        jst = jb.begin_state(N)
        jst = [jmx.nd.array(rs.randn(*s.shape).astype(np.float32) * 0.5)
               for s in jst]
        tst = [tmx.nd.array(s.asnumpy(), ctx=tmx.cpu()) for s in jst]
        assert [s.shape for s in tb.begin_state(N, ctx=tmx.cpu())] == \
            [s.shape for s in jst]
    jb(jmx.nd.array(x), *([jst] if with_states else []))
    from_jax_params(tb, jax_params(jb))
    assert tb.l0_i2h_weight.shape == jb.l0_i2h_weight.shape
    w = rs.randn(*(x.shape[:2] + (tb._hidden_size * tb._dir,))).astype(
        np.float32)
    with jag.record():
        jout = jb(jmx.nd.array(x), *([jst] if with_states else []))
        jl = (_flat(jout)[0] * jmx.nd.array(w)).sum()
        for s in _flat(jout)[1:]:
            jl = jl + s.sum()
    jag.backward(jl)
    with autograd.record():
        if with_states:
            tout = tb(tmx.nd.array(x, ctx=tmx.cpu()), tst)
            assert isinstance(_flat(tout)[0], tmx.NDArray)
            tout = [o._data for o in _flat(tout)]
        else:
            tout = tb(torch.from_numpy(x))
        tl = (_flat(tout)[0] * torch.from_numpy(w)).sum()
        for s in _flat(tout)[1:]:
            tl = tl + s.sum()
    autograd.backward(tl)
    for k, (t, j) in enumerate(zip(_flat(tout), _flat(jout))):
        _close(t, j, "%s output %d" % (cls, k))
    for name, p in jb.collect_params().items():
        tp = tb.collect_params()[tb.prefix + name[len(jb.prefix):]]
        _close(tp.grad(), p.grad(), name)


def test_bf16_dtype_rule(jax_trace_state):  # noqa: F811
    """Under amp the layer's default fp32 zero states keep the LSTM cell
    state in fp32 (``cn`` fp32) while ``h``, the output and the gates are
    bf16; values within 0.05 of the JAX package's, through the op with
    explicit states too."""
    rs = np.random.RandomState(4)
    x = rs.randn(7, 3, 6).astype(np.float32)
    jb = jrnn.LSTM(8, num_layers=2, input_size=6)
    jb.initialize()
    jamp.convert_hybrid_block(jb, "bfloat16")
    tb = rnn.LSTM(8, num_layers=2, input_size=6)
    tamp.convert_hybrid_block(tb, "bfloat16")
    from_jax_params(tb, jax_params(jb))
    assert tb.l0_h2h_weight._tensor().dtype == torch.bfloat16
    jx = jmx.nd.array(x).astype("bfloat16")
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _close(tb(tx), jb(jx), "bf16 output", BF16_TOL)
    h0 = rs.randn(2, 3, 8).astype(np.float32) * 0.5
    c0 = rs.randn(2, 3, 8).astype(np.float32) * 0.5
    weights = [p.data() for p in jb.collect_params().values()]
    jout = jmx.nd.RNN(jx, jmx.nd.array(h0), jmx.nd.array(c0), *weights,
                      mode="lstm", num_layers=2)
    tout = tmx.ops.F.RNN(tx, torch.from_numpy(h0), torch.from_numpy(c0),
                         *[p._tensor() for p in
                           tb.collect_params().values()],
                         mode="lstm", num_layers=2)
    assert str(jout[2].dtype) == "float32" and tout[2].dtype == torch.float32
    assert str(jout[0].dtype) == "bfloat16" and tout[0].dtype == torch.bfloat16
    assert str(jout[1].dtype) == "bfloat16" and tout[1].dtype == torch.bfloat16
    for t, j, what in zip(tout, jout, ("out", "hn", "cn")):
        _close(t, j, "bf16 " + what, BF16_TOL)


def test_dropout_draws_from_the_seeded_generator():
    """Inter-layer dropout in training: one mask a layer boundary from
    ``random.generator``, the same under the same seed, and none in
    predict mode."""
    x = torch.ones(5, 2, 3)
    layer = rnn.LSTM(4, num_layers=3, dropout=0.5, input_size=3)
    layer.initialize(device="cpu")
    outs = []
    for _ in range(2):
        tmx.random.seed(7)
        with autograd.record():
            outs.append(layer(x).detach())
    assert torch.equal(outs[0], outs[1])
    with autograd.record(train_mode=False):
        pred = layer(x).detach()
    assert not torch.equal(outs[0], pred)
    assert torch.equal(pred, layer(x).detach())
