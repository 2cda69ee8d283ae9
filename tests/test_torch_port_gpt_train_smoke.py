"""A CPU rehearsal of ``chip_smoke.py``'s GPT-2 training and snapshot
phases with a small GPT (2 layers, 128 units, 2 heads of 64):
``phase_gpt_train`` (vocab 1001, batch 1 of 256 tokens: the step, the
plain-version comparison and the planted faults), ``phase_gpt_train_timing``
(each kernel held to its plain version at the step's shapes; the timing
itself a card reading, left out) and ``phase_snapshot`` (GPT-2's vocab
and context, 8 new tokens). The kernels do not launch on the CPU, so
their launch counts read 0: those checks, and only those, fail here."""
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.gpt as gpt
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_attention_fwd",
           "flash_attention_bwd", "softmax_xent_fwd", "softmax_xent_bwd")


@pytest.fixture
def small(monkeypatch):
    cfg = dict(cs.GPT_CONFIG, units=128, num_layers=2, num_heads=2)
    monkeypatch.setattr(cs, "GPT_CONFIG", cfg)
    monkeypatch.setattr(cs, "GPT_NEW_TOKENS", 8)
    monkeypatch.setattr(gpt, "gpt2_small",
                        lambda **kw: gpt.GPTModel(**dict(cfg, dropout=0.1)))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_gpt_train_phases_on_the_cpu(small, monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG,
                                               vocab_size=1001))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 1, "seq": 256})
    monkeypatch.setattr(cs, "GPT_TRAIN_STEPS", 2)
    monkeypatch.setattr(cs, "TIMED_STEPS", 1)
    monkeypatch.setattr(cs, "time_ms", lambda *fns, **kw: [0.0] * len(fns))
    step, r = cs.phase_gpt_train(torch.device("cpu"))
    assert len(r["losses"]) == 3 and r["tokens_per_s"] > 0
    # the plain step against itself reads 0; each planted fault is caught,
    # the plain step run again is not
    assert r["vs_plain"]["loss_err"] == 0.0
    for name, override in cs.GPT_PLANTED_FAULTS.items():
        assert r["planted_faults"][name]["caught"] == bool(override), name
    assert not r["planted_faults"]["none (the plain step again)"]["caught"]
    records = [{"name": n} for n in KERNELS]
    cs.phase_gpt_train_timing(torch.device("cpu"), records, r)
    for rec in records:
        g = rec["gpt_train"]
        assert g["check"] and g["bound_ms"] > 0 and g["launches"] == 0
    assert records[3]["gpt_train"]["shape"] == [1, 2, 256, 64]
    # the launch counts, and only they, read 0 on the CPU
    assert small and all("launch" in w for w in small)


def test_snapshot_phase_on_the_cpu(small):
    out = cs.phase_snapshot(torch.device("cpu"))
    for name, kinds in (("bf16", {"verify", "chunk"}), ("int8", {"decode"})):
        r = out[name]
        assert kinds <= {k.split("@")[0] for k in r["keys"]}, name
        assert r["captures_in_first_request_after_load"] == 0
        assert r["cold_captures_in_first_request"] > 0
        assert r["cold_from_artifact_captures_in_first_request"] > 0
        assert r["loaded_vs_reference"]["compared"] > 0
    assert out["bf16"]["streams_equal_to_original"] == out["bf16"]["streams"]
    assert not small
