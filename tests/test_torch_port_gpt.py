"""The port's GPT against the JAX package's: logits, the K/V a prefill
collects, the cache write, prefill + step and the per-slot decode step, and
greedy generation, on a small GPT (2 layers, 128 units, 2 heads of 64, vocab
256, max_length 512) whose weights the port takes from the JAX model.
Tolerances: fp32 1e-4, bf16 0.05 absolute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu.ops import attention as jattention
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.models.gpt import GPTModel, gpt2_small, gpt_nano
from mxnet_tpu_torch.ops import attention as tattention
from mxnet_tpu_torch.ops import functional as F
from torch_port_helpers import (SMALL_GPT, jax_gpt, jax_trace_state,  # noqa: F401
                                port_gpt_from)
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


def _tokens(seed, batch, T, vocab=SMALL_GPT["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, (batch, T)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("bf16,tol", [(False, 1e-4), (True, 0.05)])
def test_logits_match_jax(jax_trace_state, bf16, tol):  # noqa: F811
    jm = jax_gpt(bf16)
    tm = port_gpt_from(jm)
    toks = _tokens(0, 2, 24)
    want = _np(jm(nd.array(toks, dtype="int32")).asnumpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


def test_structure_and_amp_keep_the_jax_names_and_fp32_norms():
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    assert sorted(tm._collect_params_with_prefix()) == \
        sorted(jm._collect_params_with_prefix())
    tamp.convert_hybrid_block(tm, "bfloat16")
    for name, p in tm._collect_params_with_prefix().items():
        norm = name.endswith(("gamma", "beta"))
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
    big = gpt2_small()
    assert (big._units, len(big.blocks), big._max_len) == (768, 12, 1024)
    assert big.blocks[0].attn._heads == 12
    assert gpt_nano()._units == 64


def test_forward_collect_kv_matches_jax(jax_trace_state):  # noqa: F811
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    toks = _tokens(1, 2, 12)
    jl, jkv = jm.forward_collect_kv(nd, nd.array(toks, dtype="int32"))
    with torch.no_grad():
        tl, tkv = tm.forward_collect_kv(F, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl.asnumpy()), atol=1e-4)
    assert len(tkv) == len(jkv) == SMALL_GPT["num_layers"]
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        assert tuple(tk.shape) == (2, 2, 12, 64)
        np.testing.assert_allclose(_np(tk), _np(jk.asnumpy()), atol=1e-4)
        np.testing.assert_allclose(_np(tv), _np(jv.asnumpy()), atol=1e-4)


@pytest.mark.parametrize("index", [0, 5, 14, 100, "rows", "rows clamped",
                                   "0-d tensor"])
def test_cache_write_matches_jax_in_place(index):
    """A scalar index and a per-row (B,) index, in range and past the
    capacity: the start clamps to C - T as lax.dynamic_update_slice's does.
    The port writes into the cache it was given."""
    rng = np.random.RandomState(2)
    cache = rng.randn(3, 2, 16, 4).astype(np.float32)
    update = rng.randn(3, 2, 3, 4).astype(np.float32)
    idx = {"rows": np.array([0, 7, 13], np.int32),
           "rows clamped": np.array([15, 2, 40], np.int32),
           "0-d tensor": np.array(9, np.int32)}.get(index, index)
    want = np.asarray(jattention.cache_write(jnp.asarray(cache),
                                             jnp.asarray(update),
                                             jnp.asarray(idx)))
    t_cache = torch.from_numpy(cache.copy())
    t_idx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
    out = tattention.cache_write(t_cache, torch.from_numpy(update), t_idx)
    assert out is t_cache
    np.testing.assert_array_equal(out.numpy(), want)


def test_cache_write_casts_to_the_cache_dtype():
    cache = torch.zeros(1, 1, 4, 2, dtype=torch.bfloat16)
    tattention.cache_write(cache, torch.full((1, 1, 1, 2), 1.5), 3)
    assert cache.dtype == torch.bfloat16 and float(cache[0, 0, 3, 0]) == 1.5


def test_prefill_step_and_decode_step_fixed_match_jax(
        jax_trace_state):  # noqa: F811
    """prefill + step (one position for all rows) and decode_step_fixed
    (each slot at its own position) against the JAX model's, per-slot
    logits within 1e-4; the caches are written in place and keep their
    shapes."""
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    toks = _tokens(3, 2, 10)
    jc = jm.init_cache(2, capacity=16)
    tc = tm.init_cache(2, capacity=16)
    buffers = [c[0] for c in tc]
    jl, jc = jm.prefill(nd.array(toks[:, :4], dtype="int32"), jc)
    tl, tc = tm.prefill(torch.from_numpy(toks[:, :4]), tc)
    np.testing.assert_allclose(_np(tl), _np(jl.asnumpy()), atol=1e-4)
    for t in range(4, 10):
        jl, jc = jm.step(nd.array(toks[:, t:t + 1], dtype="int32"), jc, t)
        tl, tc = tm.step(torch.from_numpy(toks[:, t:t + 1]), tc, t)
        np.testing.assert_allclose(_np(tl), _np(jl.asnumpy()), atol=1e-4,
                                   err_msg="step %d" % t)
    assert all(a is b[0] for a, b in zip(buffers, tc))
    for (jk, jv, _), (tk, tv, n) in zip(jc, tc):
        assert n == 10
        np.testing.assert_allclose(_np(tk), _np(jk.asnumpy()), atol=1e-4)

    # per-slot positions: slot 0 at 10, slot 1 at 6 (its later positions
    # hold stale rows the mask must hide)
    valid = np.array([10, 6], np.int32)
    step_tok = np.array([7, 99], np.int32)
    jl, jk, jv = jm.decode_step_fixed(nd, nd.array(step_tok, dtype="int32"),
                                      [c[0] for c in jc], [c[1] for c in jc],
                                      nd.array(valid, dtype="int32"))
    with torch.no_grad():
        tl, tk, tv = tm.decode_step_fixed(
            F, torch.from_numpy(step_tok), [c[0] for c in tc],
            [c[1] for c in tc], torch.from_numpy(valid))
    np.testing.assert_allclose(_np(tl), _np(jl.asnumpy()), atol=1e-4)
    for a, b in zip(tk, jk):
        np.testing.assert_allclose(_np(a), _np(b.asnumpy()), atol=1e-4)


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_greedy_matches_jax(jax_trace_state, use_cache):  # noqa: F811
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    toks = _tokens(4, 2, 9)
    want = jm.generate(nd.array(toks, dtype="int32"), max_new_tokens=8,
                       use_cache=use_cache).asnumpy()
    got = tm.generate(toks, max_new_tokens=8, use_cache=use_cache,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_runs_where_the_parameters_are():
    tm = GPTModel(**SMALL_GPT)
    tm.initialize(device="cpu")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        tm.generate(_tokens(5, 1, 4), device="meta")


def test_300_token_bf16_prompt_takes_flash_and_matches_jax(
        jax_trace_state, monkeypatch):  # noqa: F811
    """A 300-token bf16 prompt takes the causal flash route (its plain
    version on the CPU) in every layer; the logits and the prefill's K/V
    agree with the JAX package's reference attention within 0.05."""
    jm = jax_gpt(True)
    tm = port_gpt_from(jm)
    calls = []
    flash = tattention.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw["causal"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(tattention, "flash_attention", spy)
    toks = _tokens(6, 1, 300)
    jl, jkv = jm.forward_collect_kv(nd, nd.array(toks, dtype="int32"))
    with torch.no_grad():
        tl, tkv = tm.forward_collect_kv(F, torch.from_numpy(toks))
    assert calls == [((1, 2, 300, 64), True)] * SMALL_GPT["num_layers"]
    np.testing.assert_allclose(_np(tl), _np(jl.asnumpy()), atol=0.05)
    for (tk, tv), (jk, jv) in zip(tkv, jkv):
        np.testing.assert_allclose(_np(tk), _np(jk.asnumpy()), atol=0.05)
        np.testing.assert_allclose(_np(tv), _np(jv.asnumpy()), atol=0.05)
