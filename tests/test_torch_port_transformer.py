"""The Transformer NMT model of the port against the JAX package's, on a
small model (1 + 1 layers, 32 units, 4 heads, FFN 64, vocabulary 60),
weights and the ``pos_enc`` constant carried with ``from_jax_params``:
the teacher-forced forward with and without ``src_valid`` (fp32 within
1e-5 of the largest logit), ``decode_step``'s logits over the fixed cache
(1e-5), and ``translate``: greedy over the cache, greedy by re-forward and
``beam=3`` token for token equal to the JAX package's (the training step
is ``test_torch_port_transformer_step.py``).
``Constant``: no gradient, never updated, saved and loaded both ways
between the packages, cast by amp as the JAX package casts it."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu.models.transformer import TransformerModel as JTransformer
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import Constant
from mxnet_tpu_torch.models.transformer import (TransformerModel,
                                                transformer_base)
from torch_port_helpers import jax_params, jax_trace_state_module  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SMALL = dict(src_vocab=60, tgt_vocab=60, units=32, hidden=64, num_layers=1,
             num_heads=4, max_len=32, dropout=0.0)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.asnumpy(), np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


@pytest.fixture(scope="module")
def pair(jax_trace_state_module):  # noqa: F811
    jm = JTransformer(**SMALL)
    jm.initialize()
    tm = TransformerModel(**SMALL)
    from_jax_params(tm, jax_params(jm))
    rng = np.random.RandomState(0)
    src = rng.randint(4, 60, (3, 9)).astype(np.int32)
    tgt = rng.randint(4, 60, (3, 7)).astype(np.int32)
    return jm, tm, src, tgt


def _jnd(a):
    return jmx.nd.array(a, dtype=str(a.dtype))


@pytest.mark.parametrize("valid", [None, [9, 4, 1]])
def test_forward_matches_jax(pair, valid):
    jm, tm, src, tgt = pair
    jargs = [_jnd(src), _jnd(tgt)]
    targs = [torch.from_numpy(src), torch.from_numpy(tgt)]
    if valid is not None:
        v = np.array(valid, np.int32)
        jargs.append(_jnd(v))
        targs.append(torch.from_numpy(v))
    _close(tm(*targs), jm(*jargs), 1e-5, "logits")


def test_decode_step_matches_jax(pair):
    jm, tm, src, _ = pair
    jenc = jm._encode_imperative(_jnd(src))
    tenc = tm.encode(torch.from_numpy(src), tm.pos_enc._tensor())
    _close(tenc, jenc, 1e-5, "encoder output")
    jc = jm.init_cache(jenc, capacity=8)
    tc = tm.init_cache(tenc, capacity=8)
    tok = np.array([[2], [5], [7]], np.int32)
    for t in range(4):
        jl = jm.decode_step(_jnd(tok), jc, t)
        tl = tm.decode_step(torch.from_numpy(tok), tc, t)
        _close(tl, jl, 1e-5, "step %d logits" % t)
        tok = _np(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert tc[0]["self"]["n"] == 4


@pytest.mark.parametrize("how", ["cached", "reforward", "beam"])
def test_translate_matches_jax(pair, how):
    jm, tm, src, _ = pair
    kw = {"cached": {}, "reforward": {"use_cache": False},
          "beam": {"beam": 3}}[how]
    s = src[:1] if how == "beam" else src
    want = jm.translate(_jnd(s), max_len=7, **kw).asnumpy()
    got = tm.translate(torch.from_numpy(s), max_len=7, device="cpu", **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if how == "cached":
        with tmx.cpu():
            nd_got = tm.translate(tmx.nd.array(s, dtype="int32"),
                                  max_len=7, device="cpu")
        assert isinstance(nd_got, tmx.NDArray)
        np.testing.assert_array_equal(nd_got.asnumpy(), want)


def test_constant_files_cross_both_ways(pair, tmp_path):
    jm, tm, _, _ = pair
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jm.save_parameters(jfile)
    other = TransformerModel(**SMALL)
    with tmx.cpu():
        other.load_parameters(jfile, ctx=tmx.cpu())
    assert isinstance(other.pos_enc, Constant)
    assert torch.equal(other.pos_enc._tensor(), tm.pos_enc._tensor())
    tm.save_parameters(tfile)
    jother = JTransformer(**SMALL)
    jother.load_parameters(tfile)
    for name, p in jother.collect_params().items():
        q = jm.collect_params()[jm.prefix + name[len(jother.prefix):]]
        np.testing.assert_array_equal(p.data().asnumpy(), q.data().asnumpy())


def test_constant_under_amp(pair):
    """amp casts the constant with the other parameters, to bf16, in both
    packages; it stays without a gradient."""
    jm = JTransformer(**dict(SMALL, num_layers=1))
    jm.initialize()
    jamp.convert_hybrid_block(jm, "bfloat16")
    tm = TransformerModel(**dict(SMALL, num_layers=1))
    tm.initialize(device="cpu")
    tamp.convert_hybrid_block(tm, "bfloat16")
    assert str(jm.pos_enc.data().dtype) == "bfloat16"
    assert tm.pos_enc._tensor().dtype == torch.bfloat16
    assert not tm.pos_enc._tensor().requires_grad
    from_jax_params(tm, jax_params(jm))
    assert tm.pos_enc._tensor().dtype == torch.bfloat16


def test_transformer_base_is_bench_recipe():
    """``transformer_base(32000, 32000)``: 6 + 6 layers of 512 units, 30
    LayerNorms, vocabulary 32000; ``pos_enc`` (max_len, 512) fp32."""
    m = transformer_base(32000, 32000, max_len=128, dropout=0.1)
    names = [n[len(m.prefix):] for n in m.collect_params()]
    assert sum(n.endswith("_gamma") for n in names) == 30
    assert m.pos_enc.shape == (128, 512)
    m.pos_enc.initialize(device="cpu")
    assert m.pos_enc._tensor().dtype == torch.float32
