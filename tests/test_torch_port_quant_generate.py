"""Quantized generative serving of the port on the CPU against the JAX
package's: the int8 KV-page ops bit for bit (a scalar and a per-row
index, one past the capacity, a scale that grows, a page never written),
a prompt page's quantization, ``decode_step_fixed_quant`` on a small GPT
(fp32 and bf16), and ``GenerativeServer(quantize="int8")``: greedy
streams equal to the JAX server's, prefix hits equal to their misses,
int8 pages at most 0.55x the bf16 bytes, and fp8 weights.

The JAX step runs op by op (``jax.disable_jit``), as its source reads: a
jitted JAX program keeps bf16 quotients in fp32 and multiplies by a
constant's reciprocal where the source divides (see
tests/test_torch_port_quant.py)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.ops import attention as jattention
from mxnet_tpu.quantization import quantize_model as jax_quantize_model
from mxnet_tpu.serve.decoder import GenerativeServer as JaxServer
from mxnet_tpu_torch.ops import attention as tattention
from mxnet_tpu_torch.ops import functional as F
from mxnet_tpu_torch.quantization import quantize_model
from mxnet_tpu_torch.serve import GenerativeServer, ServeError
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_trace_state, jax_trace_state_module,
                                port_gpt_from)
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

NEW = 8
LENGTHS = (3, 17, 40, 9)


def _case(index):
    """cache (3, 2, 16, 4) int8, scale (3, 2, 1, 1) with row 1 never
    written (0), an update (3, 2, T, 4) and the index."""
    rng = np.random.RandomState(12)
    cache = rng.randint(-127, 128, (3, 2, 16, 4)).astype(np.int8)
    scale = (rng.rand(3, 2, 1, 1) * 0.05).astype(np.float32)
    scale[1] = 0.0
    cache[1] = 0
    T = 2 if index == "two rows" else 1
    update = rng.randn(3, 2, T, 4).astype(np.float32)
    if index == "scale grows":
        update *= 40.0  # amax / 127 above every old scale: ratio < 1
    idx = {"rows": np.array([0, 7, 13], np.int32),
           "rows clamped": np.array([15, 2, 40], np.int32),
           "scale grows": np.array([3, 0, 15], np.int32),
           "two rows": 14, "0-d": np.array(9, np.int32)}.get(index, index)
    return cache, scale, update, idx


CASES = [0, 5, 100, "0-d", "rows", "rows clamped", "scale grows",
         "two rows"]


@pytest.mark.parametrize("index", CASES)
def test_quant_cache_ops_bit_equal_to_jax(index):
    cache, scale, update, idx = _case(index)
    j_idx = jnp.asarray(idx)
    jc, js = jattention.quant_cache_write(jnp.asarray(cache),
                                          jnp.asarray(scale),
                                          jnp.asarray(update), j_idx)
    jc2, js2, jdeq = jattention.quant_cache_write_read(
        jnp.asarray(cache), jnp.asarray(scale), jnp.asarray(update), j_idx)
    t_idx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
    tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scale.copy())
    out_c, out_s = F.quant_cache_write(tc, ts, torch.from_numpy(update),
                                       t_idx)
    assert out_c is tc and out_s is ts  # in place
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tc2, ts2 = torch.from_numpy(cache.copy()), torch.from_numpy(scale.copy())
    out_c2, out_s2, deq = F.quant_cache_write_read(
        tc2, ts2, torch.from_numpy(update), t_idx)
    assert out_c2 is tc2 and out_s2 is ts2
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    # the fused read equals the unfused one, and JAX's dequant
    np.testing.assert_array_equal(
        F.dequant_cache(tc2, ts2).numpy(),
        np.asarray(jattention.dequant_cache(jc2, js2)))
    np.testing.assert_array_equal(deq.numpy(),
                                  F.dequant_cache(tc2, ts2).numpy())
    if index == "scale grows":
        assert np.all(ts.numpy() >= scale) and np.any(ts.numpy() > scale)


def test_a_page_never_written_takes_the_new_scale():
    """Row 1's scale is 0: ratio 0 clears its old page and the update is
    quantized at its own amax / 127."""
    cache, scale, update, idx = _case(4)
    tc = torch.from_numpy(cache.copy())
    ts = torch.from_numpy(scale.copy())
    F.quant_cache_write(tc, ts, torch.from_numpy(update), idx)
    amax = np.abs(update[1]).max(axis=(1, 2))
    np.testing.assert_array_equal(ts.numpy()[1].reshape(-1),
                                  np.maximum(amax / np.float32(127.0),
                                             np.float32(1e-8)))
    assert np.abs(tc.numpy()[1, :, 4]).max() == 127
    assert not tc.numpy()[1, :, :4].any() and not tc.numpy()[1, :, 5:].any()


@pytest.mark.parametrize("plen", [1, 5, 8])
def test_prompt_page_quantization_bit_equal(plen):
    page = np.random.RandomState(plen).randn(1, 2, 8, 4).astype(np.float32)
    page[:, :, plen:] *= 100.0  # padding must not widen the scale
    (jq, js), = JaxServer._quantize_pages([jnp.asarray(page)],
                                          jnp.int32(plen), 8)
    tq, ts = tattention.quantize_page(torch.from_numpy(page), plen)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _pages(seed, L, B, H, C, D):
    rng = np.random.RandomState(seed)
    pages = [rng.randint(-127, 128, (B, H, C, D)).astype(np.int8)
             for _ in range(2 * L)]
    scales = [(rng.rand(B, H, 1, 1) * 0.02).astype(np.float32)
              for _ in range(2 * L)]
    scales[0][1] = 0.0  # slot 1's layer-0 K page never written
    return pages, scales


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_decode_step_fixed_quant_matches_jax(jax_trace_state, bf16):  # noqa
    """Three slots at positions 5, 0 and 31 (the last one past nothing:
    the capacity's end) over random int8 pages. The written pages and
    scales come from the same quantized weights in both; an int8 element
    may differ only by one step (a rounding at .5 that an fp32 ulp
    elsewhere flips), and no element does here. The logits, fp32 in both
    (a quantized bf16 model computes in fp32 after its first quantized
    Dense), agree within 1e-4 absolute, the fp32 limit of the unquantized
    step (tests/test_torch_port_gpt.py): with no flipped rounding nothing
    larger than fp32 summation order separates them."""
    jm = jax_gpt(bf16)
    tm = port_gpt_from(jm)
    jax_quantize_model(jm)
    quantize_model(tm)
    L, B, H, C, D = 2, 3, 2, 32, 64
    pages, scales = _pages(4, L, B, H, C, D)
    valid = np.array([5, 0, 31], np.int32)
    tok = np.array([7, 99, 3], np.int32)
    with jax.disable_jit():
        jl, jk, jks, jv, jvs = jm.decode_step_fixed_quant(
            nd, nd.array(tok, dtype="int32"),
            [nd.array(a) for a in pages[:L]],
            [nd.array(a) for a in scales[:L]],
            [nd.array(a) for a in pages[L:]],
            [nd.array(a) for a in scales[L:]],
            nd.array(valid, dtype="int32"))
    tp = [torch.from_numpy(a.copy()) for a in pages]
    ts = [torch.from_numpy(a.copy()) for a in scales]
    with torch.no_grad():
        tl, tk, tks, tv, tvs = tm.decode_step_fixed_quant(
            F, torch.from_numpy(tok), tp[:L], ts[:L], tp[L:], ts[L:],
            torch.from_numpy(valid))
    assert all(a is b for a, b in zip(tk + tv, tp[:L] + tp[L:]))
    assert all(a is b for a, b in zip(tks + tvs, ts[:L] + ts[L:]))
    jl = np.asarray(jl.asnumpy(), np.float32)
    assert tl.dtype == torch.float32 and tl.shape == (B, SMALL_GPT[
        "vocab_size"])
    for got, want in zip(tk + tv, jk + jv):
        step = np.abs(got.numpy().astype(np.int32)
                      - np.asarray(want.asnumpy()).astype(np.int32))
        assert step.max() <= 1
        assert not step.any(), "a flipped rounding: %d" % step.sum()
    for got, want in zip(tks + tvs, jks + jvs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want.asnumpy()),
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=0)


def _tokens_of(prompts, srv_factory):
    with srv_factory() as srv:
        handles = [srv.submit(p, max_new_tokens=NEW) for p in prompts]
        return [h.result(600) for h in handles], srv.stats()


@pytest.fixture(scope="module")
def shared(jax_trace_state_module):  # noqa: F811
    """A quantized JAX server's greedy streams, and the port's model on the
    same fp32 weights."""
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, SMALL_GPT["vocab_size"], n).astype(np.int32)
               for n in LENGTHS]
    want, _ = _tokens_of(prompts, lambda: mx.serve.GenerativeServer(
        jm, slots=2, timeout_ms=600000.0, quantize="int8"))
    return {"prompts": prompts, "want": want, "port_model": tm}


def _server(model, **kw):
    kw.setdefault("timeout_ms", 600000.0)
    return GenerativeServer(model, device="cpu", **kw)


def test_quantized_greedy_streams_match_jax_server(shared):
    """Two slots, four requests joining and leaving: every stream equals
    the quantized JAX server's (the two quantize the same weights bit for
    bit and run the same int8 arithmetic; no step here comes near a tie,
    the margin PR 5's comparison allows)."""
    got, stats = _tokens_of(shared["prompts"], lambda: _server(
        shared["port_model"], slots=2, quantize="int8"))
    assert got == shared["want"]
    assert stats["quantize"] == "int8" and stats["errors"] == 0
    assert stats["prefills"] == len(LENGTHS)


def _pump(srv, streams, ticks=200):
    for _ in range(ticks):
        srv.step()
        if all(s.done() for s in streams):
            return
        time.sleep(0.002)
    raise AssertionError("streams did not finish in %d ticks" % ticks)


def test_quantized_prefix_hit_equals_miss_and_bytes(shared):
    """A hit injects the stored fp pages requantized (the largest element
    gives the same scale again) and streams what the miss streamed; the
    int8 pages with their scales take at most 0.55x the bf16 bytes."""
    srv = _server(shared["port_model"], slots=2, quantize="int8")
    p = shared["prompts"][1]
    s1 = srv.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s1])
    entry = srv.prefix._store[srv.prefix.key(p)]
    assert entry[0].dtype == torch.float32  # stored dequantized
    s2 = srv.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s2])
    assert (srv.prefix.misses, srv.prefix.hits) == (1, 1)
    assert s1.result(1) == s2.result(1) == shared["want"][1]
    # extract after inject gives the stored pages back exactly
    slot = srv.cache.acquire("probe")
    srv._inject(slot, entry, 0, 0.0)
    ks, vs = srv._extract(slot, entry[0].shape[2])
    srv.cache.release(slot)
    np.testing.assert_array_equal(ks.numpy(), entry[0].numpy())
    np.testing.assert_array_equal(vs.numpy(), entry[1].numpy())
    cache = srv.cache
    assert cache.k[0].dtype == torch.int8
    assert tuple(cache.k_scale[0].shape) == (2, 2, 1, 1)
    ratio = cache.nbytes() / cache.nbytes_unquantized(itemsize=2)
    assert ratio <= 0.55, ratio
    stats = srv.stats()
    assert stats["kv_cache_bytes"] == cache.nbytes()
    assert stats["kv_cache_bytes_unquantized"] == cache.nbytes_unquantized()
    srv.stop()


def test_quantized_capacity_growth_keeps_the_scales(shared):
    """A migration pads the int8 pages and carries the scales (they do not
    depend on the capacity): the short stream is undisturbed."""
    srv = _server(shared["port_model"], slots=2, quantize="int8")
    s1 = srv.submit(shared["prompts"][0], max_new_tokens=NEW)
    time.sleep(0.05)
    srv.step()
    scales = [s.clone() for s in srv.cache.k_scale]
    kept = srv.cache.k_scale[0]
    assert srv.cache.capacity == 16
    s2 = srv.submit(shared["prompts"][2], max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s1, s2])
    assert srv.cache.capacity == 64 and srv.cache.migrations == 1
    assert srv.cache.k_scale[0] is kept
    assert np.all(srv.cache.k_scale[0].numpy() >= 0) and scales
    assert s1.result(1) == shared["want"][0]
    assert s2.result(1) == shared["want"][2]
    srv.stop()


@pytest.mark.parametrize("mode", ["e4m3", "e5m2"])
def test_fp8_weight_serving_is_reproducible(shared, mode):
    """fp8 weights: a greedy and a sampled stream, the same when served
    again. (A quantized stream depends on its companions: each Dense
    quantizes its activations with one scale over every slot, as in JAX,
    so a stream is reproducible with the same companions only.)"""
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.gpt import GPTModel
    from torch_port_helpers import jax_params

    model = from_jax_params(GPTModel(**SMALL_GPT),
                            jax_params(jax_gpt(False)))
    p, q = shared["prompts"][1], shared["prompts"][3]
    runs = []
    for _ in range(2):
        with _server(model, slots=2, top_k=8, quantize=mode) as srv:
            a = srv.submit(p, max_new_tokens=NEW)
            b = srv.submit(q, max_new_tokens=NEW, temperature=0.9, seed=4)
            runs.append((a.result(600), b.result(600)))
            assert srv.stats()["quantize"] == mode
    assert runs[0] == runs[1]
    assert all(0 <= t < SMALL_GPT["vocab_size"] for t in runs[0][0])
    assert len(runs[0][1]) == NEW


def test_quantize_needs_the_decode_protocol():
    class NoQuant:
        def decode_state_spec(self):
            return {}

    with pytest.raises(ServeError, match="decode_step_fixed_quant"):
        GenerativeServer(NoQuant(), quantize="int8", device="cpu")
