"""A CPU rehearsal of ``chip_smoke.py``'s speculative-decode and
chunked-prefill phases with a small GPT (2 layers, 128 units, 2 heads of
64, GPT-2's vocab and context) and 16 new tokens a request:
``phase_speculative`` (the plain server's logits recorded, NGramDraft,
the target as its own draft, a 2-layer draft, int8), ``phase_chunked_
prefill`` and ``phase_graph`` with ``spec_programs_against_eager``. The
kernels do not launch on the CPU, so their launch counts read 0: those
checks, and only those, fail here. Then the rules the phases hold
streams to: a parting only at a near-tie of the plain server's own
logits, greedy or sampled."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG, units=128,
                                               num_layers=2, num_heads=2))
    monkeypatch.setattr(cs, "GPT_NEW_TOKENS", 16)
    monkeypatch.setattr(cs, "STEP_LN", 2 * 2 + 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_speculative_and_chunked_phases_on_the_cpu(small):
    dev = torch.device("cpu")
    spec, plains = cs.phase_speculative(dev)
    for name in ("bf16", "int8"):
        r = spec[name]["ngram"]
        assert r["rounds"] > 0 and r["captures"] == 0
        assert r["replays"] == r["rounds"]
        assert r["vs_plain"]["compared"] > 0
    assert spec["bf16"]["ngram"]["vs_plain"]["parted"] == 0  # fp32 here
    assert spec["bf16"]["self_draft"]["accept_rate"] == 1.0
    two = spec["bf16"]["draft_2_layers"]
    assert two["draft_replays"] == two["rounds"] and two["draft_captures"] == 0
    chunked = cs.phase_chunked_prefill(dev, plains)
    for name in ("bf16", "int8"):
        r = chunked[name]
        assert r["chunks"] == 4
        assert all(all(g) for g in r["gains_on_chunk_ticks"])
        assert r["vs_unchunked"]["compared"] > 0
    assert chunked["bf16"]["vs_unchunked"]["parted"] == 0
    # the launch counts, and only they, read 0 on the CPU
    assert small and all("launch" in w for w in small)


def test_spec_programs_against_eager_on_the_cpu(small):
    dev = torch.device("cpu")
    model = cs._gpt_model(dev, cs.SEED + 12)
    rng = np.random.RandomState(cs.SEED + 11)
    prompts = [rng.randint(0, cs.GPT_CONFIG["vocab_size"], n).astype(
        np.int32) for n in cs.GRAPH_PROMPTS]
    r = cs.spec_programs_against_eager(dev, model, "int8", prompts)
    for kind in ("verify_greedy", "verify_sampled", "draft_round",
                 "chunk_greedy", "chunk_sampled"):
        assert r[kind]["graph_equals_eager"], kind
        assert r[kind]["steady_captures"] == 0, kind
    assert sorted(map(tuple, r["keys"])) == [
        ("chunk", "256", "512", "False"), ("chunk", "256", "512", "True"),
        ("verify", "512", "4", "False"), ("verify", "512", "4", "True")]


def test_phase_graph_on_the_cpu(small, monkeypatch):
    """The whole phase: the decode step (greedy, sampled, after a
    migration, after a swap) and the new programs, each against its eager
    run (the host walls, a card reading, left out)."""
    monkeypatch.setattr(cs, "step_walls", lambda srv, n=10: dict.fromkeys(
        ("graph", "eager", "graph_events", "eager_events"), 0.0))
    r = cs.phase_graph(torch.device("cpu"))
    for mode in ("bf16", "int8"):
        for case in ("greedy", "sampled", "after_migration", "after_swap"):
            assert r[mode][case]["graph_equals_eager"], (mode, case)
            assert r[mode][case]["max_abs_logit_diff"] == 0.0
        assert r[mode]["speculative"]["chunk_sampled"]["graph_equals_eager"]
    assert small and all("launch" in w for w in small)


def test_spec_requests_repeat_their_patterns():
    reqs = cs._spec_requests(cs.GPT_CONFIG["vocab_size"])
    assert len(reqs) == 12
    for (prompt, temp, seed), (pat, n, t, s) in zip(reqs, cs.SPEC_REPEATS):
        assert len(prompt) == n and 200 <= n <= 900 and 16 <= pat <= 64
        assert np.array_equal(prompt[pat:], prompt[:-pat])
        assert (temp, seed) == (t, s)
    assert [len(p) for p, _, _ in reqs[6:]] == [300, 16, 450, 48, 600, 100]
    assert sum(1 for _, t, _ in reqs if t) == 4


def test_a_parting_is_held_to_the_plain_servers_own_logits():
    tol = cs.GREEDY_TIE_TOL
    row = torch.zeros(50)
    row[3], row[7], row[9] = 1.0, 1.0 - tol / 2, 1.0 - 2 * tol
    req = (np.zeros(5, np.int32), 0.0, 0)
    rows = [row] * 3
    assert cs.compare_to_plain([3, 3, 3], [3, 3, 3], rows, req, "same") \
        == (3, None)
    n, margin = cs.compare_to_plain([3, 7, 1], [3, 3, 3], rows, req, "tie")
    assert (n, margin) == (2, pytest.approx(tol / 2))
    with pytest.raises(cs.SmokeFailure, match="token 1"):
        cs.compare_to_plain([3, 9, 3], [3, 3, 3], rows, req, "clear lead")
    # a looser limit (the int8 one) takes the same parting
    assert cs.compare_to_plain([3, 9], [3, 3], rows, req, "int8",
                               tol=4 * tol)[0] == 2


def test_a_sampled_parting_is_held_to_the_sampler_scores():
    """At temperature 0.8 the plain server drew b from its scores (logit /
    temp + Gumbel noise of (seed, position)); a token whose score trails
    b's by a hair is a near-tie, one far behind is not, and a token below
    the top-k cut is as far as its distance to the cut."""
    from mxnet_tpu_torch.serve.decoder import sample_tokens

    V, temp, seed, pos = 64, 0.8, 5, 11
    g = torch.Generator().manual_seed(2)
    row = torch.randn(V, generator=g)
    args = (torch.tensor([seed]), torch.tensor([pos]), torch.tensor([temp]),
            cs.GPT_TOP_K)
    b = int(sample_tokens(row[None], *args)[0])
    assert cs.sampler_margin(row, b, b, temp, seed, pos) == 0.0
    others = [a for a in range(V) if a != b]
    margins = {a: cs.sampler_margin(row, a, b, temp, seed, pos)
               for a in others}
    assert all(m > 0 for m in margins.values())
    # nudging the nearest rival's logit by a bit more than its margin
    # makes the sampler take it
    a = min(margins, key=margins.get)
    bumped = row.clone()
    bumped[a] += margins[a] * 1.01 + 1e-6
    bumped[b] -= 1e-6
    assert int(sample_tokens(bumped[None], *args)[0]) == a
    # a token far below the cut is far from a tie
    low = int(torch.argmin(row))
    kth = float(torch.topk(row, cs.GPT_TOP_K).values[-1])
    assert margins[low] >= kth - float(row[low]) > 0
