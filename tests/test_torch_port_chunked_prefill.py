"""Chunked prefill of the port on the CPU against the JAX package's, on the
same weights (the small GPT of tests/torch_port_helpers.py, fp32): greedy
streams of prompts filled one chunk a tick equal to the whole-prompt
path's and to the JAX chunked server's, alone and with speculation;
``ceil(plen / tc)`` chunks a prompt; the chunk size rounding and its
refusal below ``spec_k``; the streams in flight gaining a token on the
ticks a long prompt joins over; int8 pages and scales equal to the JAX
server's after the same ticks; a deadline passed in the middle of a
prefill; the prefix cache bypassed; the chunk programs made by warmup and
never after; ``itl_prefill``."""
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.serve import decoder as jax_decoder
from mxnet_tpu_torch.serve import (GenerativeServer, NGramDraft, ServeError,
                                   ServeTimeout)
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_rng_kept, jax_trace_state_module,
                                port_gpt_from)
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

NEW = 8
TC = 32
LENGTHS = (100, 9, 33, 40)
# the JAX model's weights: drawn from this seed, so every run holds the
# same case whichever files ran before in the worker (unseeded, the share
# of int8 page elements a rounding apart moved with the draw)
SEED = 0


def _prompts():
    rng = np.random.RandomState(51)
    return [rng.randint(0, SMALL_GPT["vocab_size"], n).astype(np.int32)
            for n in LENGTHS]


def _wait_joined(srv, n):
    deadline = time.perf_counter() + 60.0
    while len(srv._join_q) < n:
        assert time.perf_counter() < deadline, "the admission thread stalled"
        time.sleep(0.002)


def drive(srv, waves, new=NEW, ticks_between=2, max_ticks=400):
    """Waves of requests: each wave submitted and in the join queue, then
    ``ticks_between`` ticks before the next; then ticks until every stream
    finishes. The server is stopped. Returns (streams, stats)."""
    streams = []
    for i, wave in enumerate(waves):
        streams += [srv.submit(p, max_new_tokens=new, seed=len(streams) + j)
                    for j, p in enumerate(wave)]
        _wait_joined(srv, len(wave))
        if i + 1 < len(waves):
            for _ in range(ticks_between):
                srv.step()
    for _ in range(max_ticks):
        srv.step()
        if all(s.done() for s in streams):
            break
    stats = srv.stats()
    srv.stop()
    return [s.result(timeout_s=1) for s in streams], stats


def _waves(prompts):
    """Two short prompts decoding, then the long ones join."""
    return [[prompts[1], prompts[2]], [prompts[0], prompts[3]]]


@pytest.fixture(scope="module")
def shared(jax_trace_state_module, jax_rng_kept):  # noqa: F811
    mx.random.seed(SEED)
    jm = jax_gpt(False)
    prompts = _prompts()
    want = {}
    for name, kw in (("chunked", {}), ("chunked_ngram",
                                       {"draft": mx.serve.NGramDraft()})):
        want[name] = drive(mx.serve.GenerativeServer(
            jm, slots=4, timeout_ms=600000.0, prefill_chunk=TC, **kw),
            _waves(prompts))[0]
    return {"prompts": prompts, "want": want, "jax_model": jm,
            "port_model": port_gpt_from(jm)}


def _server(model, **kw):
    kw.setdefault("timeout_ms", 600000.0)
    return GenerativeServer(model, device="cpu", **kw)


@pytest.mark.parametrize("tc", [TC, 64])
def test_chunked_streams_equal_whole_prompt_and_jax(shared, tc):
    model = shared["port_model"]
    got, stats = drive(_server(model, slots=4, prefill_chunk=tc),
                       _waves(shared["prompts"]))
    whole, wstats = drive(_server(model, slots=4),
                          _waves(shared["prompts"]))
    assert got == whole == shared["want"]["chunked"]
    chunked = [n for n in LENGTHS if n > tc]
    assert stats["prefill_chunks"] == sum(-(-n // tc) for n in chunked)
    assert stats["prefills"] == wstats["prefills"] == len(LENGTHS)
    assert stats["errors"] == 0 and stats["prefill_chunk"] == tc


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_chunked_prefill_composes_with_speculation(shared, kind):
    model = shared["port_model"]
    draft = NGramDraft() if kind == "ngram" else port_gpt_from(
        jax_gpt(False, num_layers=1), num_layers=1)
    got, stats = drive(_server(model, slots=4, prefill_chunk=TC,
                               draft=draft), _waves(shared["prompts"]))
    whole, _ = drive(_server(model, slots=4), _waves(shared["prompts"]))
    assert got == whole
    if kind == "ngram":
        assert got == shared["want"]["chunked_ngram"]
    assert stats["prefill_chunks"] == 4 + 2 + 2 and stats["spec_rounds"] > 0


@pytest.mark.parametrize("plen", [32, 33, 64, 100, 300])
def test_a_prompt_takes_ceil_plen_over_tc_chunks(shared, plen):
    prompt = np.random.RandomState(plen).randint(
        0, SMALL_GPT["vocab_size"], plen).astype(np.int32)
    got, stats = drive(_server(shared["port_model"], slots=1,
                               prefill_chunk=TC), [[prompt]])
    whole, _ = drive(_server(shared["port_model"], slots=1), [[prompt]])
    assert got == whole
    assert stats["prefill_chunks"] == (-(-plen // TC) if plen > TC else 0)
    assert stats["prefills"] == 1


def test_chunk_size_rounding_and_refusal_below_spec_k(shared):
    model = shared["port_model"]
    for asked, got in ((20, 32), (3, 8), (64, 64)):
        srv = _server(model, prefill_chunk=asked)
        assert srv.stats()["prefill_chunk"] == got
        srv.stop()
    with pytest.raises(ServeError, match="spec_k"):
        _server(model, prefill_chunk=4, draft=NGramDraft(), spec_k=16)
    srv = _server(model, prefill_chunk=4, draft=NGramDraft(), spec_k=8)
    srv.stop()


def test_streams_in_flight_advance_while_a_long_prompt_joins(shared):
    """Four streams decoding; a 256-token prompt joins in chunks of 64
    (four chunk ticks): each stream in flight gains a token on at least 3
    of the 4 chunk ticks (here on all of them: one chunk, then one decode
    step, a tick), and the steps under the prefill land in
    ``itl_prefill``."""
    model = shared["port_model"]
    rng = np.random.RandomState(7)
    short = [rng.randint(0, SMALL_GPT["vocab_size"], 12).astype(np.int32)
             for _ in range(4)]
    long_p = rng.randint(0, SMALL_GPT["vocab_size"], 256).astype(np.int32)
    srv = _server(model, slots=5, prefill_chunk=64)
    streams = [srv.submit(p, max_new_tokens=40) for p in short]
    _wait_joined(srv, 4)
    srv.step()
    srv.step()
    joiner = srv.submit(long_p, max_new_tokens=4)
    _wait_joined(srv, 1)
    gains, chunks = [], []
    for _ in range(4):
        before = [len(s.tokens) for s in streams]
        c0 = srv.metrics.prefill_chunks
        srv.step()
        chunks.append(srv.metrics.prefill_chunks - c0)
        gains.append([len(s.tokens) - b for s, b in zip(streams, before)])
    assert chunks == [1, 1, 1, 1]
    for i in range(4):
        assert sum(g[i] > 0 for g in gains) >= 3, gains
    # the final chunk's first token, then that tick's decode step's
    assert len(joiner.tokens) == 2
    stats = srv.stats()
    assert stats["itl_prefill_p50_ms"] is not None
    assert stats["chunk_queue_depth"] == 0
    srv.stop()


def test_int8_pages_and_scales_equal_jax_after_the_same_ticks(
        shared, monkeypatch):
    """int8 serving with chunks: after the same ticks, the JAX server's
    streams, pages and scales (it runs op by op here: its programs
    unjitted, under ``jax.disable_jit``, as the port's step runs). The
    parity traps are kept on both sides: the scale of a page is a running
    max that a decode step's write for a slot waiting for its chunks moves,
    and the final chunk's padding rows join its amax.

    The streams are equal. A scale is amax / 127 of rows the two compute
    in another order of fp32 sums: a few fp32 steps apart (the limit of
    tests/test_torch_port_quant_generate.py). Over many ticks such a
    difference, or one in a LayerNorm's output that moves an activation's
    quantization at .5, puts a few page elements one rounding on the other
    side: at most 1 in 1000 elements, each within 3 int8 steps (a chunk
    written at the wrong offset, a scale not wiped or a masked slot's
    write left out moves whole rows, far more)."""
    monkeypatch.setattr(jax_decoder.GenerativeServer, "_jit",
                        lambda self, fn, donate, hint="": fn)
    prompts = shared["prompts"]
    jq = jax_gpt(False)
    for p_to, p_from in zip(jq.collect_params().values(),
                            shared["jax_model"].collect_params().values()):
        p_to.set_data(p_from.data())
    jsrv = mx.serve.GenerativeServer(jq, slots=4, timeout_ms=600000.0,
                                     quantize="int8", prefill_chunk=TC,
                                     prefix_cache=False)
    with jax.disable_jit():
        want, _ = drive(jsrv, _waves(prompts), new=4)
    srv = _server(port_gpt_from(shared["jax_model"]), slots=4,
                  quantize="int8", prefill_chunk=TC, prefix_cache=False)
    got, stats = drive(srv, _waves(prompts), new=4)
    assert got == want
    assert stats["prefill_chunks"] == 4 + 2 + 2
    jc, c = jsrv.cache, srv.cache
    assert c.capacity == jc.capacity
    for mine, theirs in zip(c.k + c.v, list(jc.k) + list(jc.v)):
        step = np.abs(mine.numpy().astype(np.int32)
                      - np.asarray(theirs).astype(np.int32))
        assert step.max() <= 3 and (step > 0).mean() <= 1e-3, \
            (int(step.max()), int((step > 0).sum()))
    for mine, theirs in zip(c.k_scale + c.v_scale,
                            list(jc.k_scale) + list(jc.v_scale)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=0)


def test_the_first_chunk_wipes_the_slots_scale(shared):
    """A reused slot's page starts afresh: the first chunk (pos0 0) drops
    the scale the last stream left, a later chunk keeps the running
    max."""
    srv = _server(port_gpt_from(shared["jax_model"]), slots=1,
                  quantize="int8", prefill_chunk=TC)
    srv.cache.ensure_capacity(128)
    prompt = shared["prompts"][0]
    for s in srv.cache.k_scale + srv.cache.v_scale:
        s.fill_(100.0)
    for pos0, kept in ((0, False), (TC, True)):
        srv._chunk_tokens.copy_(torch.from_numpy(
            prompt[None, pos0:pos0 + TC].astype(np.int64)))
        srv._chunk_ctl.copy_(torch.tensor([0, pos0, prompt.size, 0]))
        before = [s.clone() for s in srv.cache.k_scale]
        srv._run_chunk(False)
        after = srv.cache.k_scale
        if kept:
            assert all(bool((a >= b).all()) for a, b in zip(after, before))
        else:
            assert all(float(a.max()) < 1.0 for a in after)
    srv.stop()


def test_a_deadline_in_the_middle_of_a_prefill_releases_the_slot(shared):
    srv = _server(shared["port_model"], slots=1, prefill_chunk=TC)
    doomed = srv.submit(shared["prompts"][0], max_new_tokens=4,
                        timeout_ms=200.0)
    _wait_joined(srv, 1)
    srv.step()  # the job and its first chunk
    assert srv.stats()["chunk_queue_depth"] == 1
    time.sleep(0.25)
    srv.step()
    with pytest.raises(ServeTimeout, match="mid-prefill"):
        doomed.result(1)
    assert srv.cache.num_active == 0 and not srv._chunk_jobs
    # the slot serves the next request
    s = srv.submit(shared["prompts"][1], max_new_tokens=4)
    _wait_joined(srv, 1)
    for _ in range(20):
        srv.step()
        if s.done():
            break
    assert len(s.result(1)) == 4 and srv.stats()["timeouts"] == 1
    srv.stop()


def test_chunked_prompts_bypass_the_prefix_cache(shared):
    p = shared["prompts"][0]
    got, stats = drive(_server(shared["port_model"], slots=2,
                               prefill_chunk=TC), [[p], [p]])
    assert got[0] == got[1]
    assert stats["prefix_entries"] == 0 and stats["prefix_hits"] == 0
    assert stats["prefill_chunks"] == 2 * 4


def test_chunk_programs_made_by_warmup_and_never_after(shared):
    srv = _server(shared["port_model"], slots=4, prefill_chunk=TC)
    srv.warmup(prompt_buckets=(9, 33), max_tokens=128)
    assert sorted(k for k in srv._steps.keys() if k[0] == "chunk") == [
        ("chunk", TC, 128, False), ("chunk", TC, 128, True)]
    c0 = srv._steps.captures
    streams = [srv.submit(p, max_new_tokens=NEW, temperature=t, seed=3)
               for p, t in zip(shared["prompts"], (0.8, 0.0, 0.0, 0.7))]
    _wait_joined(srv, len(streams))
    for _ in range(200):
        srv.step()
        if all(s.done() for s in streams):
            break
    assert srv._steps.captures == c0 and srv._steps.drops == 0
    stats = srv.stats()
    assert stats["step_replays"] == stats["decode_steps"] + \
        stats["prefill_chunks"] + 2  # and warmup's two chunks
    srv.stop()


def test_the_eager_chunk_equals_the_program_chunk(shared):
    srv = _server(shared["port_model"], slots=2, prefill_chunk=TC,
                  quantize="int8")
    slot = srv.cache.acquire("probe")
    srv.cache.ensure_capacity(128)
    prompt = shared["prompts"][0]
    srv._chunk_tokens.copy_(torch.from_numpy(
        prompt[None, TC:2 * TC].astype(np.int64)))
    srv._chunk_ctl.copy_(torch.tensor([slot, TC, prompt.size, 0]))
    c = srv.cache
    bufs = [srv._tok, c.valid] + c.k + c.v + c.k_scale + c.v_scale
    saved = [t.clone() for t in bufs]
    runs = []
    for eager in (False, True):
        for dst, src in zip(bufs, saved):
            dst.copy_(src)
        logits = srv._run_chunk(False, eager=eager).clone()
        runs.append([logits] + [t.clone() for t in bufs])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert int(runs[0][2][slot]) == 2 * TC  # valid parked at the frontier
    srv.cache.release(slot)
    srv.stop()
