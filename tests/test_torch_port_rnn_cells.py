"""The port's recurrent cells against the JAX package's, weights carried
with ``from_jax_params``: every cell's ``unroll`` over 5 steps from
``begin_state`` (outputs, final states and the parameters' gradients at
fp32 1e-5 of the largest element), and a cell's ``unroll`` equal to the
fused layer over the same weights (1e-5 relative, 1e-6 absolute)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import rnn as jrnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import rnn
from test_torch_port_rnn import _close
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _carry(tc, jc):
    """``from_jax_params`` for a cell, or for each wrapped cell in turn
    when the cells were made outside the wrapper's name scope (each its
    own root)."""
    try:
        from_jax_params(tc, jax_params(jc))
    except KeyError:
        for tchild, jchild in zip(tc._children.values(),
                                  jc._children.values()):
            _carry(tchild, jchild)


def _cell_pair(make, x_shape, seed=5):
    jc = make(jrnn)
    jc.initialize()
    tc = make(rnn)
    rs = np.random.RandomState(seed)
    x = rs.randn(*x_shape).astype(np.float32)
    return jc, tc, x, rs


CELLS = {
    "RNNCell": lambda m: m.RNNCell(5, activation="relu", input_size=4),
    "LSTMCell": lambda m: m.LSTMCell(5, input_size=4),
    "GRUCell": lambda m: m.GRUCell(5, input_size=4),
    "SequentialRNNCell": lambda m: _seq(m),
    "ResidualCell": lambda m: m.ResidualCell(m.GRUCell(4, input_size=4)),
    "DropoutCell": lambda m: _seq(m, dropout=True),
    "ZoneoutCell": lambda m: m.ZoneoutCell(m.LSTMCell(5, input_size=4),
                                           zoneout_outputs=0.3,
                                           zoneout_states=0.2),
    "BidirectionalCell": lambda m: m.BidirectionalCell(
        m.LSTMCell(3, input_size=4), m.GRUCell(3, input_size=4)),
}


def _seq(m, dropout=False):
    s = m.SequentialRNNCell()
    s.add(m.LSTMCell(5, input_size=4))
    if dropout:
        s.add(m.DropoutCell(0.5))
    s.add(m.RNNCell(5, input_size=5))
    return s


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(jax_trace_state, name):  # noqa: F811
    """``unroll`` over 5 steps (NTC) from ``begin_state``, predict mode
    (the dropout and zoneout masks are the identity), outputs and final
    states; and the parameters' gradients, recorded in predict mode."""
    jc, tc, x, rs = _cell_pair(CELLS[name], (3, 5, 4))
    jout, jst = jc.unroll(5, jmx.nd.array(x), layout="NTC")
    _carry(tc, jc)
    with tmx.cpu():
        tout, tst = tc.unroll(5, tmx.nd.array(x), layout="NTC")
    assert isinstance(tout, tmx.NDArray)
    _close(tout, jout, name)
    assert len(tst) == len(jst)
    for t, j in zip(tst, jst):
        _close(t, j, name + " state")
    w = rs.randn(*jout.shape).astype(np.float32)
    # recorded in predict mode: the dropout and zoneout masks are drawn
    # from streams that cannot match
    with jag.record(train_mode=False):
        jl = (jc.unroll(5, jmx.nd.array(x), layout="NTC")[0]
              * jmx.nd.array(w)).sum()
    jag.backward(jl)
    tc.reset()
    with autograd.record(train_mode=False):
        tl = (tc.unroll(5, torch.from_numpy(x), layout="NTC",
                        begin_state=[torch.zeros(s["shape"]) for s in
                                     tc.state_info(3)])[0]
              * torch.from_numpy(w)).sum()
    autograd.backward(tl)
    tparams = list(tc.collect_params().values())
    jparams = list(jc.collect_params().values())
    if name == "BidirectionalCell":
        # the JAX BidirectionalCell.unroll rebuilds the reversed sequence
        # and the backward cell's output from raw arrays, off the tape, so
        # its backward cell gets no gradient there: that cell is held to
        # itself unrolled alone over the reversed sequence instead
        n_l = len(list(tc.l_cell.collect_params().values()))
        r_got = [p.grad()._data.clone() for p in tparams[n_l:]]
        tc.r_cell.collect_params().zero_grad()
        with autograd.record():
            r_out = tc.r_cell.unroll(5, torch.flip(torch.from_numpy(x),
                                                   dims=(1,)),
                                     layout="NTC")[0]
            tl = (torch.flip(r_out, dims=(1,))
                  * torch.from_numpy(w[..., 3:])).sum()
        autograd.backward(tl)
        for g, p in zip(r_got, tparams[n_l:]):
            _close(g, p.grad(), p.name)
        tparams, jparams = tparams[:n_l], jparams[:n_l]
    for tp, jp in zip(tparams, jparams):
        _close(tp.grad(), jp.grad(), jp.name)


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_unroll_equals_fused_layer(cls):
    """A cell unrolled over the sequence and the one-layer fused layer
    with the same four weights give the same output and final states."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(6, 2, 4).astype(np.float32))
    layer = getattr(rnn, cls)(5, input_size=4)
    layer.initialize(device="cpu")
    cell = getattr(rnn, cls + "Cell")(5, input_size=4)
    cell.initialize(device="cpu")
    for nm in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, nm).set_data(getattr(layer, "l0_" + nm)._tensor()
                                   + (0.1 if "bias" in nm else 0.0))
        getattr(layer, "l0_" + nm).set_data(getattr(cell, nm)._tensor())
    states = [torch.zeros(1, 2, 5) for _ in cell.state_info()]
    out, hn = layer(x, states)
    cout, cst = cell.unroll(6, x, [s[0] for s in states], layout="TNC")
    np.testing.assert_allclose(cout.numpy(), out.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for c, h in zip(cst, hn):
        np.testing.assert_allclose(c.detach().numpy(), h[0].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
