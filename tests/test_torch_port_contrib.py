"""A.17's contrib half beside the JAX package's, on the CPU at small
sizes: the ``gluon.contrib.nn`` blocks (``PixelShuffle1D/2D/3D``,
``Identity``, ``HybridConcurrent``/``Concurrent``), the ``gluon.contrib.rnn``
cells (the convolutional RNN, LSTM and GRU cells in 1, 2 and 3
dimensions, ``LSTMPCell``, ``VariationalDropoutCell``), the contrib op
lists bound into ``nd.contrib`` and ``sym.contrib``, ``contrib.text`` and
``registry``.

Tolerances: the shuffles and ``Identity`` are exact (a reshape and a
transpose); the cells' outputs, states and gradients within fp32 1e-5
relative, 1e-6 absolute (cuDNN's and XLA's convolutions sum in other
orders); the text utilities and the registry exactly.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import contrib as jcontrib
from mxnet_tpu.gluon import nn as jnn
from torch_port_helpers import (jax_params, jax_trace_state_module,  # noqa: F401
                                keep_block_names)

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.convert import carry_params
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon import nn as tnn

pytestmark = pytest.mark.usefixtures("jax_trace_state_module",
                                      "keep_block_names")

TOL = dict(rtol=1e-5, atol=1e-6)


class NumpyInit(jmx.init.Initializer):
    """Weights drawn by numpy (uniform in +-0.5, biases 0.1): no threefry
    draw compiled for each shape."""

    def __init__(self, seed=0):
        super().__init__()
        self._rng = np.random.default_rng(seed)

    def _init_weight(self, name, arr):
        self._set(arr, self._rng.uniform(-0.5, 0.5, tuple(arr.shape))
                  .astype(np.float32))

    def _init_bias(self, name, arr):
        self._set(arr, np.full(tuple(arr.shape), 0.1, np.float32))


def _pair(jblock, tblock, *sample):
    """Initialize ``jblock`` from numpy, materialize both on ``sample``
    and carry the JAX weights into ``tblock``."""
    jblock.initialize(NumpyInit())
    with tmx.cpu():
        tblock.initialize()
    if sample:
        jblock(*[jnd.array(s) for s in sample])
        with tmx.cpu():
            tblock(*[tnd.array(s) for s in sample])
    if jblock.collect_params():
        with tmx.cpu():
            carry_params(tblock, jax_params(jblock))


@pytest.mark.parametrize("dims,factor", [(1, 3), (2, (2, 3)), (3, 2)])
def test_pixel_shuffle_matches_jax(dims, factor):
    cls = "PixelShuffle%dD" % dims
    fs = factor if isinstance(factor, tuple) else (factor,) * dims
    shape = (2, 2 * int(np.prod(fs))) + (3,) * dims
    x = np.random.default_rng(dims).standard_normal(shape).astype(np.float32)
    want = getattr(jcontrib.nn, cls)(factor)(jnd.array(x)).asnumpy()
    with tmx.cpu():
        got = getattr(tcontrib.nn, cls)(factor)(tnd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        getattr(tcontrib.nn, cls)(0)


def test_identity_and_concurrent_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    with tmx.cpu():
        np.testing.assert_array_equal(
            tcontrib.nn.Identity()(tnd.array(x)).asnumpy(), x)
    assert tcontrib.nn.Concurrent is tcontrib.nn.HybridConcurrent
    jc = jcontrib.nn.HybridConcurrent(axis=1)
    jc.add(jnn.Dense(2), jnn.Dense(3), jcontrib.nn.Identity())
    with tmx.cpu():
        tc = tcontrib.nn.HybridConcurrent(axis=1)
        tc.add(tnn.Dense(2), tnn.Dense(3), tcontrib.nn.Identity())
    _pair(jc, tc, x)
    want = jc(jnd.array(x)).asnumpy()
    with tmx.cpu():
        got = tc(tnd.array(x)).asnumpy()
    assert got.shape == (3, 9)
    np.testing.assert_allclose(got, want, **TOL)


CONV_CELLS = [(d, kind) for d in (1, 2, 3) for kind in ("RNN", "LSTM",
                                                         "GRU")]


@pytest.mark.parametrize("dims,kind", CONV_CELLS,
                         ids=["Conv%dD%sCell" % c for c in CONV_CELLS])
def test_conv_cells_match_jax(dims, kind):
    from mxnet_tpu.gluon.contrib import rnn as jrnn

    from mxnet_tpu_torch.gluon.contrib import rnn as trnn

    name = "Conv%dD%sCell" % (dims, kind)
    spatial = {1: (5,), 2: (4, 4), 3: (3, 3, 3)}[dims]
    in_shape = (2,) + spatial
    kw = dict(hidden_channels=3, i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    jcell = getattr(jrnn, name)(in_shape, **kw)
    with tmx.cpu():
        tcell = getattr(trnn, name)(in_shape, **kw)
    _pair(jcell, tcell)
    rng = np.random.default_rng(dims * 10 + len(kind))
    x = rng.standard_normal((2, 2) + in_shape).astype(np.float32)
    grad = dims == 2  # one gradient check a dimension is enough
    jx = jnd.array(x)
    if grad:
        jx.attach_grad()
    with jautograd.record():
        jout, jst = jcell.unroll(2, jx, layout="NTC", merge_outputs=True)
        jloss = (jout * jout).sum()
    if grad:
        jloss.backward()
    with tmx.cpu():
        tx = tnd.array(x)
        if grad:
            tx.attach_grad()
        with tautograd.record():
            tout, tst = tcell.unroll(2, tx, layout="NTC",
                                     merge_outputs=True)
            tloss = (tout * tout).sum()
        if grad:
            tloss.backward()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    assert len(tst) == len(jst) == (2 if kind == "LSTM" else 1)
    for t, j in zip(tst, jst):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    assert tcell.state_info(2)[0]["shape"] == jcell.state_info(2)[0]["shape"]
    if grad:
        np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                                   **TOL)
        for p, j in zip(tcell.collect_params().values(),
                        jcell.collect_params().values()):
            np.testing.assert_allclose(p.grad().asnumpy(),
                                       j.grad().asnumpy(), rtol=1e-4,
                                       atol=1e-5)


def test_lstmp_cell_matches_jax():
    from mxnet_tpu.gluon.contrib import rnn as jrnn

    from mxnet_tpu_torch.gluon.contrib import rnn as trnn

    x = np.random.default_rng(2).standard_normal((3, 4, 5)).astype(
        np.float32)
    jcell = jrnn.LSTMPCell(6, 2, input_size=5)
    with tmx.cpu():
        tcell = trnn.LSTMPCell(6, 2, input_size=5)
    _pair(jcell, tcell)
    jx = jnd.array(x)
    jx.attach_grad()
    with jautograd.record():
        jout, jst = jcell.unroll(4, jx, layout="NTC")
        jl = (jout ** 2).sum()
    jl.backward()
    with tmx.cpu():
        tx = tnd.array(x)
        tx.attach_grad()
        with tautograd.record():
            tout, tst = tcell.unroll(4, tx, layout="NTC")
            tl = (tout ** 2).sum()
        tl.backward()
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    assert [s.shape for s in tst] == [(3, 2), (3, 6)]
    for t, j in zip(tst, jst):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **TOL)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(), **TOL)


def test_variational_dropout_cell():
    """One mask a sequence, drawn at the first step after ``reset()``;
    inference is the base cell itself; with no dropout the JAX package's
    output."""
    from mxnet_tpu.gluon import rnn as jgrnn
    from mxnet_tpu.gluon.contrib import rnn as jrnn

    from mxnet_tpu_torch.gluon import rnn as tgrnn
    from mxnet_tpu_torch.gluon.contrib import rnn as trnn

    x = np.random.default_rng(3).standard_normal((2, 3, 4)).astype(
        np.float32)
    jcell = jrnn.VariationalDropoutCell(jgrnn.GRUCell(5, input_size=4))
    with tmx.cpu():
        tbase = tgrnn.GRUCell(5, input_size=4)
        tcell = trnn.VariationalDropoutCell(tbase)
    _pair(jcell, tcell)
    want, _ = jcell.unroll(3, jnd.array(x), layout="NTC")
    with tmx.cpu():
        got, _ = tcell.unroll(3, tnd.array(x), layout="NTC")
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
        drop = trnn.VariationalDropoutCell(tbase, drop_inputs=0.5,
                                           drop_outputs=0.5)
        tmx.random.seed(1)
        ones = tnd.ones((2, 4))
        with tautograd.train_mode():
            drop(ones, drop.begin_state(2))
            m_i, m_o = drop._mask_i, drop._mask_o
            drop(ones, drop.begin_state(2))
            assert drop._mask_i is m_i and drop._mask_o is m_o
            kept = m_i.numpy()
            assert set(np.unique(kept)) <= {0.0, 2.0}
            drop.reset()
            assert drop._mask_i is None
        base_out, _ = tbase(ones, tbase.begin_state(2))
        eval_out, _ = drop(ones, drop.begin_state(2))
        np.testing.assert_array_equal(eval_out.asnumpy(), base_out.asnumpy())


def test_contrib_ops_bound_into_nd_and_sym():
    from mxnet_tpu import _contrib_ops as jops

    from mxnet_tpu_torch import _contrib_ops as tops
    from mxnet_tpu_torch import sym_contrib

    assert tops.CONTRIB_OPS == jops.CONTRIB_OPS
    assert sym_contrib.CONTRIB_OPS is tops.CONTRIB_OPS
    for alias in tops.CONTRIB_OPS:
        assert callable(getattr(tnd.contrib, alias))
        assert callable(getattr(sym_contrib, alias))
    assert set(tnd.contrib._NOT_PORTED) == {
        "DeformableConvolution", "ModulatedDeformableConvolution",
        "PSROIPooling", "Proposal", "MultiProposal", "ROIAlign",
        "ROIPooling"}
    s = sym_contrib.div_sqrt_dim(tmx.sym.var("x"))
    assert "div_sqrt_dim" in s.tojson()
    assert tmx.contrib.ndarray is tnd.contrib
    assert tmx.contrib.symbol is sym_contrib


def test_contrib_text_matches_jax(tmp_path):
    from mxnet_tpu.contrib import text as jtext

    from mxnet_tpu_torch.contrib import text as ttext

    src = "the cat sat\nOn the mat the end\n\nA cat"
    for lower in (False, True):
        jc = jtext.count_tokens_from_str(src, to_lower=lower)
        tc = ttext.count_tokens_from_str(src, to_lower=lower)
        assert tc == jc
    for kw in ({}, {"most_freq_count": 2}, {"min_freq": 2},
               {"reserved_tokens": ["<pad>"], "unknown_token": "<u>"}):
        jv, tv = jtext.Vocabulary(jc, **kw), ttext.Vocabulary(tc, **kw)
        assert tv.idx_to_token == jv.idx_to_token
        assert tv.to_indices(["cat", "zebra"]) == jv.to_indices(
            ["cat", "zebra"])
        assert tv.to_tokens([0, 1]) == jv.to_tokens([0, 1])
    with pytest.raises(ValueError):
        ttext.Vocabulary(tc, min_freq=0)
    path = tmp_path / "vec.txt"
    path.write_text("the 0.1 0.2 0.3\ncat 1 2 3\nmat -1 0 1\n")
    vocab = ttext.Vocabulary(tc)
    je = jtext.CustomEmbedding(str(path), vocabulary=jtext.Vocabulary(jc))
    te = ttext.CustomEmbedding(str(path), vocabulary=vocab)
    np.testing.assert_array_equal(te.idx_to_vec, je.idx_to_vec)
    np.testing.assert_array_equal(te.get_vecs_by_tokens(["cat", "dog"]),
                                  je.get_vecs_by_tokens(["cat", "dog"]))
    bad = tmp_path / "bad.txt"
    bad.write_text("a 1 2\nb 1\n")
    with pytest.raises(ValueError):
        ttext.CustomEmbedding(str(bad))


def test_registry_matches_jax():
    from mxnet_tpu import registry as jreg

    from mxnet_tpu_torch import registry as treg

    outcomes = []
    for reg in (jreg, treg):
        class Base:
            pass

        register = reg.get_register_func(Base, "thing")
        alias = reg.get_alias_func(Base, "thing")
        create = reg.get_create_func(Base, "thing")

        @register
        class Plain(Base):
            def __init__(self, a=1, b=2):
                self.ab = (a, b)

        @alias("other", "third")
        class Named(Base):
            def __init__(self, a=0):
                self.ab = (a, None)

        got = [type(create("plain")).__name__,
               create("PLAIN", a=5).ab,
               create(json.dumps({"type": "plain", "b": 7})).ab,
               create(("plain", {"a": 3}), b=4).ab,
               type(create("third")).__name__,
               create("named", a=9).ab]
        inst = Plain()
        got.append(create(inst) is inst)
        for bad in (lambda: create("none"), lambda: create(3)):
            with pytest.raises(ValueError):
                bad()
        outcomes.append(got)
    assert outcomes[0] == outcomes[1]
