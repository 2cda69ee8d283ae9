"""Speculative decode of the port on the CPU against the JAX package's, on
the same weights (a small GPT: 2 layers, 128 units, 2 heads of 64, vocab
256, max_length 512, fp32; its drafts a 1-layer GPT of the same widths):
``ngram_propose`` on seeded histories; ``decode_step_speculative`` and its
int8 form for windows of 1 to 4 rows at per-slot valid lengths (logits
within 1e-4, fp32 pages within 1e-4, int8 pages exact and their scales
within a few fp32 steps; K = 1
equal to ``decode_step_fixed`` bit for bit); then ``GenerativeServer(
draft=...)``: greedy streams with ``NGramDraft`` and with a ``ModelDraft``
equal to the JAX server's with the same draft and to the port's plain
server's, fp32 and int8; sampled streams equal to plain decode per (seed,
position); ``spec_k=1``; requests joining and leaving in the middle of
speculation; the capacity margin refused at the door; the option checks;
the verify and draft programs made once each and never in steady state,
and dropped together by a capacity migration.

Both servers are driven tick by tick from the test (``step()``) with every
request in the join queue before the first tick, so the two run the same
schedule: an int8 stream depends on its companions (one activation scale
over every slot)."""
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.quantization import quantize_model as jax_quantize_model
from mxnet_tpu.serve.speculative import ngram_propose as jax_ngram_propose
from mxnet_tpu_torch.base import DeviceError
from mxnet_tpu_torch.ops import functional as F
from mxnet_tpu_torch.quantization import quantize_model
from mxnet_tpu_torch.serve import (CacheError, GenerativeServer, ModelDraft,
                                   NGramDraft, ServeError)
from mxnet_tpu_torch.serve.speculative import ngram_propose
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_trace_state, jax_trace_state_module,
                                port_gpt_from)
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

NEW = 10
DRAFT = dict(num_layers=1)


def _prompts():
    """A repetitive prompt (a pattern the n-gram draft predicts), two
    random ones (one 300 tokens: capacity 512)."""
    rng = np.random.RandomState(41)
    pattern = rng.randint(0, SMALL_GPT["vocab_size"], 6)
    return [np.tile(pattern, 5).astype(np.int32),
            rng.randint(0, SMALL_GPT["vocab_size"], 17).astype(np.int32),
            rng.randint(0, SMALL_GPT["vocab_size"], 300).astype(np.int32)]


def drive(srv, prompts, new=NEW, temps=None, ticks=400):
    """Every request submitted and in the join queue, then ticks until all
    finish; the server is stopped. Returns (streams, stats)."""
    temps = temps or [0.0] * len(prompts)
    streams = [srv.submit(p, max_new_tokens=new, temperature=t, seed=i)
               for i, (p, t) in enumerate(zip(prompts, temps))]
    deadline = time.perf_counter() + 60.0
    while len(srv._join_q) < len(prompts):
        assert time.perf_counter() < deadline, "the admission thread stalled"
        time.sleep(0.002)
    for _ in range(ticks):
        srv.step()
        if all(s.done() for s in streams):
            break
    stats = srv.stats()
    srv.stop()
    return [s.result(timeout_s=1) for s in streams], stats


@pytest.fixture(scope="module")
def shared(jax_trace_state_module):  # noqa: F811
    """The JAX target and draft and their port copies; the JAX servers'
    greedy streams with each draft, fp32 and int8."""
    jm, jd = jax_gpt(False), jax_gpt(False, **DRAFT)
    jq = jax_gpt(False)
    for p_to, p_from in zip(jq.collect_params().values(),
                            jm.collect_params().values()):
        p_to.set_data(p_from.data())
    prompts = _prompts()
    want = {}
    for mode, target in ((None, jm), ("int8", jq)):
        for kind in ("ngram", "model"):
            draft = mx.serve.NGramDraft() if kind == "ngram" \
                else mx.serve.ModelDraft(jd)
            want[(mode, kind)] = drive(mx.serve.GenerativeServer(
                target, slots=3, timeout_ms=600000.0, quantize=mode,
                draft=draft), prompts)[0]
    return {"prompts": prompts, "want": want, "target": port_gpt_from(jm),
            "draft": port_gpt_from(jd, **DRAFT), "jax_target": jm,
            "jax_draft": jd}


def _server(model, **kw):
    kw.setdefault("timeout_ms", 600000.0)
    return GenerativeServer(model, device="cpu", **kw)


def _port(shared, quantize):
    """The port's target on the shared weights, quantized in place for
    int8 (a fresh copy: quantization replaces its Dense layers)."""
    if quantize is None:
        return shared["target"]
    from torch_port_helpers import port_gpt_from as copy

    return copy(shared["jax_target"])


def _draft(shared, kind):
    return NGramDraft() if kind == "ngram" else ModelDraft(shared["draft"])


# ------------------------------------------------------------ ngram draft
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_ngram_propose_matches_jax(order):
    rng = np.random.RandomState(order)
    for _ in range(200):
        history = rng.randint(0, rng.randint(1, 6),
                              rng.randint(0, 40)).tolist()
        n = int(rng.randint(0, 6))
        assert ngram_propose(history, n, order) == \
            jax_ngram_propose(history, n, order), (history, n)
    assert ngram_propose([1, 2, 3, 1, 2, 3, 1], 3) == [2, 3, 1]
    assert ngram_propose([], 2) == [0, 0]


def test_ngram_draft_fills_the_drafts_buffer(shared):
    srv = _server(shared["target"], slots=3, draft=NGramDraft(), spec_k=3)
    out = srv._draft.propose([[5, 6, 5, 6], [], [9]], 3)
    assert out.tolist() == [[5, 6], [0, 0], [9, 9]]
    assert srv._drafts.tolist() == out.tolist()
    assert srv._drafts.dtype == torch.int32
    srv.stop()


# ------------------------------------------------------- the wide step
def _caches(seed, L, B, H, C, D, quant):
    rng = np.random.RandomState(seed)
    if not quant:
        return [rng.randn(B, H, C, D).astype(np.float32)
                for _ in range(2 * L)], None
    pages = [rng.randint(-127, 128, (B, H, C, D)).astype(np.int8)
             for _ in range(2 * L)]
    scales = [(rng.rand(B, H, 1, 1) * 0.02).astype(np.float32)
              for _ in range(2 * L)]
    scales[0][1] = 0.0  # slot 1's layer-0 K page never written
    return pages, scales


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_decode_step_speculative_matches_jax(jax_trace_state, K,  # noqa
                                             quant):
    """Three slots at valid lengths 5, 0 and 27 (capacity 32: the last
    window ends at the capacity's last position) over random pages: the
    logits (B, K, V) within 1e-4, the pages written in place (fp32 within
    1e-4; int8 pages exact, their scales within a few fp32 steps). The int8
    JAX step runs op by op, as tests/test_torch_port_quant_generate.py
    runs it."""
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    L, B, H, C, D = 2, 3, 2, 32, 64
    pages, scales = _caches(K, L, B, H, C, D, quant)
    valid = np.array([5, 0, 32 - K], np.int32)
    rng = np.random.RandomState(100 + K)
    tok = rng.randint(0, SMALL_GPT["vocab_size"], (B, K)).astype(np.int32)
    tp = [torch.from_numpy(a.copy()) for a in pages]
    if quant:
        jax_quantize_model(jm)
        quantize_model(tm)
        ts = [torch.from_numpy(a.copy()) for a in scales]
        with jax.disable_jit():
            jl, jk, jks, jv, jvs = jm.decode_step_speculative_quant(
                nd, nd.array(tok, dtype="int32"),
                [nd.array(a) for a in pages[:L]],
                [nd.array(a) for a in scales[:L]],
                [nd.array(a) for a in pages[L:]],
                [nd.array(a) for a in scales[L:]],
                nd.array(valid, dtype="int32"))
        with torch.no_grad():
            tl, tk, tks, tv, tvs = tm.decode_step_speculative_quant(
                F, torch.from_numpy(tok), tp[:L], ts[:L], tp[L:], ts[L:],
                torch.from_numpy(valid))
        assert all(a is b for a, b in zip(tks + tvs, ts[:L] + ts[L:]))
        for got, want in zip(tk + tv, jk + jv):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want.asnumpy()))
        # a scale is amax / 127 of the new K or V rows, which the two
        # compute in another order of fp32 products and sums: a few fp32
        # steps apart, the limit of decode_step_fixed_quant's scales
        # (tests/test_torch_port_quant_generate.py)
        for got, want in zip(tks + tvs, jks + jvs):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(want.asnumpy()),
                                       rtol=1e-6, atol=0)
    else:
        jl, jk, jv = jm.decode_step_speculative(
            nd, nd.array(tok, dtype="int32"),
            [nd.array(a) for a in pages[:L]],
            [nd.array(a) for a in pages[L:]],
            nd.array(valid, dtype="int32"))
        with torch.no_grad():
            tl, tk, tv = tm.decode_step_speculative(
                F, torch.from_numpy(tok), tp[:L], tp[L:],
                torch.from_numpy(valid))
        for got, want in zip(tk + tv, jk + jv):
            np.testing.assert_allclose(got.numpy(), want.asnumpy(),
                                       atol=1e-4, rtol=0)
    assert all(a is b for a, b in zip(tk + tv, tp[:L] + tp[L:]))
    assert tuple(tl.shape) == (B, K, SMALL_GPT["vocab_size"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.asnumpy(),
                                                      np.float32),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_a_window_of_one_is_decode_step_fixed_bitwise(quant):
    tm = port_gpt_from(jax_gpt(False))
    if quant:
        quantize_model(tm)
    L, B, H, C, D = 2, 3, 2, 32, 64
    pages, scales = _caches(9, L, B, H, C, D, quant)
    valid = torch.tensor([5, 0, 31], dtype=torch.int32)
    tok = torch.tensor([7, 99, 3], dtype=torch.int32)
    runs = []
    for wide in (False, True):
        tp = [torch.from_numpy(a.copy()) for a in pages]
        ts = [torch.from_numpy(a.copy()) for a in scales] if quant else []
        x = tok[:, None] if wide else tok
        with torch.no_grad():
            if quant:
                fn = tm.decode_step_speculative_quant if wide \
                    else tm.decode_step_fixed_quant
                logits = fn(F, x, tp[:L], ts[:L], tp[L:], ts[L:], valid)[0]
            else:
                fn = tm.decode_step_speculative if wide \
                    else tm.decode_step_fixed
                logits = fn(F, x, tp[:L], tp[L:], valid)[0]
        runs.append((logits.reshape(B, -1), tp + ts))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ------------------------------------------------------------ the server
@pytest.mark.parametrize("kind", ["ngram", "model"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
def test_greedy_streams_match_jax_and_plain(shared, quantize, kind):
    """The same requests, the same ticks: the port with a draft streams
    what the JAX server with the same draft streams, and what the port's
    plain server streams."""
    model = _port(shared, quantize)
    got, stats = drive(_server(model, slots=3, quantize=quantize,
                               draft=_draft(shared, kind)),
                       shared["prompts"])
    plain, _ = drive(_server(model, slots=3, quantize=quantize),
                     shared["prompts"])
    assert got == shared["want"][(quantize, kind)]
    assert got == plain
    assert stats["spec_rounds"] == stats["decode_steps"] > 0
    assert 0 <= stats["accepted_tokens"] <= stats["drafted_tokens"]
    # a round counts every token it emits, some past a budget (as in JAX)
    assert stats["tokens"] >= NEW * len(shared["prompts"])
    assert stats["draft"] == ("NGramDraft" if kind == "ngram"
                              else "ModelDraft")
    if kind == "ngram":
        # the repetitive prompt's pattern is predicted
        assert stats["accepted_tokens"] > 0


def test_a_draft_of_the_target_itself_accepts_every_greedy_draft(shared):
    model = shared["target"]
    got, stats = drive(_server(model, slots=3, draft=model),
                       shared["prompts"], new=12)
    plain, _ = drive(_server(model, slots=3), shared["prompts"], new=12)
    assert got == plain
    # every drafted token of a round is the target's own greedy token;
    # only a stream that ends in the middle of a window leaves some unused
    assert stats["accept_rate"] == 1.0
    assert stats["decode_steps"] < 12


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_sampled_streams_equal_plain_per_seed_and_position(shared, kind):
    temps = [0.9, 0.0, 0.7]
    model = shared["target"]
    got, stats = drive(_server(model, slots=3, top_k=8,
                               draft=_draft(shared, kind)),
                       shared["prompts"], temps=temps)
    plain, _ = drive(_server(model, slots=3, top_k=8), shared["prompts"],
                     temps=temps)
    assert got == plain
    assert stats["spec_rounds"] > 0


def test_spec_k_1_is_plain_decode(shared):
    model = shared["target"]
    got, stats = drive(_server(model, slots=3, draft=NGramDraft(),
                               spec_k=1), shared["prompts"])
    plain, pstats = drive(_server(model, slots=3), shared["prompts"])
    assert got == plain
    assert stats["decode_steps"] == pstats["decode_steps"]
    assert stats["drafted_tokens"] == 0 and stats["accept_rate"] is None


def test_join_and_leave_in_the_middle_of_speculation(shared):
    """Two slots, five requests with budgets of 3 to 14 tokens and an
    EOS: requests join between rounds and leave in the middle of a window;
    each stream is the plain server's."""
    model = shared["target"]
    prompts = shared["prompts"] + shared["prompts"][:2]
    budgets = [5, 14, 3, 9, 7]

    def run(**kw):
        srv = _server(model, slots=2, eos_id=int(shared["want"][
            (None, "ngram")][1][6]), **kw)
        with srv:
            streams = [srv.submit(p, max_new_tokens=n, seed=i)
                       for i, (p, n) in enumerate(zip(prompts, budgets))]
            return [s.result(600) for s in streams], srv.stats()

    plain, _ = run()
    for kind in ("ngram", "model"):
        got, stats = run(draft=_draft(shared, kind))
        assert got == plain, kind
        assert stats["completed"] == len(prompts) and stats["errors"] == 0
    assert len(plain[1]) <= 7, "the EOS ends the second stream early"


def test_the_capacity_margin_is_refused_at_the_door(shared):
    """A window writes through valid + spec_k - 1: 500 + 10 tokens fit a
    max_length of 512 without a draft, not with spec_k 4."""
    prompt = np.zeros(500, np.int32)
    plain = _server(shared["target"], slots=1)
    plain.submit(prompt, max_new_tokens=10)
    plain.stop()
    srv = _server(shared["target"], slots=1, draft=NGramDraft())
    with pytest.raises(CacheError):
        srv.submit(prompt, max_new_tokens=10)
    srv.submit(prompt, max_new_tokens=9)
    srv.stop()


def test_option_checks(shared):
    class Plain:
        def decode_state_spec(self):
            return {}

        def decode_step_fixed_quant(self):
            pass

        def decode_step_speculative(self):
            pass

    with pytest.raises(ServeError, match="decode_step_speculative_quant"):
        GenerativeServer(Plain(), quantize="int8", draft=NGramDraft(),
                         device="cpu")
    del Plain.decode_step_speculative
    with pytest.raises(ServeError, match="decode_step_speculative"):
        GenerativeServer(Plain(), draft=NGramDraft(), device="cpu")
    from mxnet_tpu_torch.models.gpt import GPTModel

    short = GPTModel(**dict(SMALL_GPT, num_layers=1, max_length=256))
    short.initialize(device="cpu")
    with pytest.raises(ServeError, match="max_length"):
        _server(shared["target"], draft=short)
    srv = _server(shared["target"], draft=shared["draft"])
    assert isinstance(srv._draft, ModelDraft), "a bare model is wrapped"
    assert srv._draft.model is shared["draft"]
    srv.stop()


def test_without_a_device_it_needs_cuda(shared, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        GenerativeServer(shared["target"], draft=NGramDraft(),
                         prefill_chunk=64)


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_programs_made_once_and_none_in_steady_state(shared, kind):
    """warmup makes the greedy and the sampled verify program (and the
    draft's round); traffic, greedy and sampled, makes none: one verify
    replay a round, one draft replay a round."""
    srv = _server(shared["target"], slots=3, draft=_draft(shared, kind))
    srv.warmup(prompt_buckets=(17, 30, 300), max_tokens=310 + NEW)
    steps = srv._steps
    assert sorted(steps.keys()) == [("verify", 512, 4, False),
                                    ("verify", 512, 4, True)]
    draft_steps = srv._draft._steps if kind == "model" else None
    if draft_steps is not None:
        assert draft_steps.keys() == [("draft", 512)]
        assert draft_steps.captures == 1
    c0, r0 = steps.captures, steps.replays
    rounds0 = srv.stats()["spec_rounds"]
    dr0 = draft_steps.replays if draft_steps is not None else 0
    _, stats = drive(srv, shared["prompts"], temps=[0.0, 0.8, 0.0])
    rounds = stats["spec_rounds"] - rounds0
    assert steps.captures == c0 and steps.drops == 0
    assert steps.replays - r0 == rounds > 0
    if draft_steps is not None:
        assert draft_steps.captures == 1 and draft_steps.drops == 0
        assert draft_steps.replays - dr0 == rounds
        assert stats["draft_step_replays"] == draft_steps.replays


def test_a_migration_drops_both_program_sets(shared):
    """A 300-token request joining a short one grows the target's pages
    and the draft's: each StepPrograms drops its programs and makes them
    again; the streams are the plain server's."""
    model = shared["target"]
    prompts = shared["prompts"][1:]

    def run(**kw):
        srv = _server(model, slots=2, **kw)
        s1 = srv.submit(prompts[0], max_new_tokens=NEW)
        time.sleep(0.05)
        srv.step()
        cap = srv.cache.capacity
        s2 = srv.submit(prompts[1], max_new_tokens=NEW)
        time.sleep(0.05)
        for _ in range(200):
            srv.step()
            if s1.done() and s2.done():
                break
        srv.stop()
        return [s1.result(1), s2.result(1)], srv, cap

    plain, _, _ = run()
    got, srv, cap = run(draft=shared["draft"])
    assert got == plain
    assert (cap, srv.cache.capacity) == (32, 512)
    assert srv._draft.cache.capacity == 512
    assert srv._steps.drops == 1 and srv._draft._steps.drops == 1
    assert srv._steps.keys() == [("verify", 512, 4, False)]
    assert srv._draft._steps.keys() == [("draft", 512)]


def test_the_eager_verify_step_equals_the_program_step(shared):
    """From one saved state, a verify step through the program and the
    eager one give the same logits, emitted tokens, valid lengths and
    pages (int8)."""
    model = _port(shared, "int8")
    srv = _server(model, slots=3, quantize="int8", draft=NGramDraft())
    for i, p in enumerate(shared["prompts"]):
        srv.submit(p, max_new_tokens=20, seed=i)
    while len(srv._join_q) < 3:
        time.sleep(0.002)
    srv._admit_pending()
    srv._propose(srv._active_mask())
    c = srv.cache
    bufs = [srv._tok, c.valid, srv._emit] + c.k + c.v + c.k_scale + c.v_scale
    saved = [t.clone() for t in bufs]
    runs = []
    for eager in (False, True):
        for dst, src in zip(bufs, saved):
            dst.copy_(src)
        logits = srv._run_verify(eager=eager).clone()
        runs.append([logits] + [t.clone() for t in bufs])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert int(runs[0][3][:, -1].sum()) >= 3  # every live slot emitted
    srv.stop()


def test_stats_carry_the_speculative_keys(shared):
    _, stats = drive(_server(shared["target"], slots=3, draft=NGramDraft(),
                             spec_k=3), shared["prompts"])
    for key in ("spec_rounds", "drafted_tokens", "accepted_tokens",
                "accept_rate", "spec_k", "draft", "prefill_chunks",
                "prefill_chunk"):
        assert key in stats, key
    assert stats["spec_k"] == 3 and stats["prefill_chunk"] is None
    assert stats["accept_rate"] == round(
        stats["accepted_tokens"] / stats["drafted_tokens"], 4)
