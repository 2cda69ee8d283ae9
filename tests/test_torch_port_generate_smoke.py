"""A CPU rehearsal of ``chip_smoke.py``'s ``phase_generate`` with a small
GPT (2 layers, 128 units, 2 heads of 64, GPT-2's vocab and context) and 16
new tokens a request: both bursts, the greedy streams against batch-1
``generate``, prefix hits, sampled streams across bursts, the prefill with
the kernels (here their plain versions) against the plain versions, the
weight swap. Both planted faults must read above the phase's limit. The
kernels do not launch on the CPU, so the launch counts read 0 and only
their check fails."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.serve import GenerativeServer
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def small_phase(monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG, units=128,
                                               num_layers=2, num_heads=2))
    monkeypatch.setattr(cs, "GPT_NEW_TOKENS", 16)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_phase_generate_on_the_cpu(small_phase):
    srv, _, res = cs.phase_generate(torch.device("cpu"))
    srv.stop()
    assert (res["prefills"], res["prefix_hits"]) == (19, 5)
    assert res["flash_prefills"] == 9
    assert res["greedy_tokens_compared"] == 18 * 16
    # the first greedy stream, driven again alone, in any case
    assert res["served_logits_vs_reference"]["streams"] >= 1
    assert res["served_logits_vs_reference"]["worst_ratio"] <= 1.0
    assert [p["bucket"] for p in res["prefill_vs_plain"]] == [256, 512, 1024]
    for prefill in res["prefill_vs_plain"]:
        assert prefill["worst"][0] == 0.0  # the same plain versions both ways
        for name, (ratio, where) in prefill["faults"].items():
            assert ratio > 1.0, (prefill["bucket"], name, ratio, where)
    assert not any(res["launches"].values())
    with pytest.raises(cs.SmokeFailure, match="layernorm launches 0"):
        cs.check_generate_launches(res)


def test_greedy_comparison_parts_only_at_a_near_tie():
    ref = [1, 2, 3, 4]
    logits = np.zeros((4, 10), np.float32)
    logits[np.arange(4), ref] = 1.0
    logits[1, 7] = 1.0 - 2 * cs.GREEDY_TIE_TOL    # a clear lead
    logits[2, 9] = 1.0 - cs.GREEDY_TIE_TOL / 2    # a near-tie
    logits[2, 5] = 1.0 - cs.GREEDY_TIE_TOL / 4    # nearer, not the one served
    assert cs.compare_greedy([1, 2, 3, 4], ref, logits, "same") == (4, None)
    n, margin = cs.compare_greedy([1, 2, 9, 9], ref, logits, "tie")
    assert (n, margin) == (3, pytest.approx(cs.GREEDY_TIE_TOL / 2))
    with pytest.raises(cs.SmokeFailure, match="token 1"):
        cs.compare_greedy([1, 7, 3, 4], ref, logits, "clear lead")
    # the margin is that of the served token, not the top-2's
    with pytest.raises(cs.SmokeFailure, match="token 2"):
        cs.compare_greedy([1, 2, 0, 4], ref, logits, "far from the top")


def test_served_logits_catch_another_prompts_reference(small_phase):
    """The served step's logits of one prompt agree with its own batch-1
    reference, and read above the limit against another prompt's."""
    dev = torch.device("cpu")
    model = cs._gpt_model(dev, cs.SEED)
    srv = GenerativeServer(model, slots=cs.GPT_SLOTS, top_k=cs.GPT_TOP_K,
                           device=dev)
    rng = np.random.RandomState(3)
    a, b = (rng.randint(0, cs.GPT_CONFIG["vocab_size"], n).astype(np.int32)
            for n in (40, 300))
    toks, logits = cs.served_logits(srv, a, 6)
    ref_a, logits_a = cs.greedy_reference(model, a, 6, dev)
    assert toks == ref_a
    ratio, _ = cs.check_served_logits(srv, a, toks, logits_a, 6, "own")
    assert ratio <= 1.0
    _, logits_b = cs.greedy_reference(model, b, 6, dev)
    assert cs.rms_ratio(logits, logits_b, cs.GEN_TOL) > 1.0
    with pytest.raises(cs.SmokeFailure, match="disagree"):
        cs.check_served_logits(srv, a, toks, logits_b, 6, "other")


def test_requests_cover_the_buckets_and_repeats():
    bursts = cs._gpt_requests(cs.GPT_CONFIG["vocab_size"])
    assert [len(b) for b in bursts] == [12, 12]
    for burst in bursts:
        lengths = [len(p) for p, _, _ in burst]
        assert sum(n > 256 for n in lengths) >= 4
        assert sum(n <= 128 for n in lengths) >= 4
        assert sum(1 for _, temp, _ in burst if temp) == 3
    assert bursts[0][11][0] is bursts[0][1][0]
    assert bursts[1][8][0] is bursts[0][0][0]
    sampled = [r for r in bursts[1] if r[1]]
    assert all(any(r is s for s in bursts[0]) for r in sampled)
