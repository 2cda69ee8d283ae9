"""A CPU rehearsal of ``chip_smoke.py``'s ModelServer, bad-id and optimizer
phases on small models: ``phase_serve`` and ``phase_serve_graph`` (a
2-layer BERT of 128 units at BERT's vocab, seq 256; bf16, then int8 through
``phase_serve_quant``), ``phase_bad_ids`` (a 2-layer GPT at GPT-2's vocab),
``phase_optimizers`` and ``phase_gpt_train_optimizers`` (a 2-layer GPT at
vocab 1001, batch 1 of 64 tokens). Each planted fault (a replay on stale
input buffers, a swap that rebinds the parameters, a LAMB step without its
trust ratio) must be caught. The kernels do not launch on the CPU, so
their launch counts read 0: those checks, and only those, fail here; the
device timings are card readings, left out."""
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.0


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "SEQ", 256)
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG, units=128,
                                               num_layers=2, num_heads=2))
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512:
                        bert.BERTModel(vocab_size=cs.VOCAB, units=128,
                                       hidden_size=256, num_layers=2,
                                       num_heads=2, dropout=dropout,
                                       max_length=max_length))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(cs, "bucket_device_ms", lambda pool, b: (0.0, 0.0))
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def _held(r):
    assert all(r["replay_vs_eager_bitwise"].values())
    assert r["stale_buffers_fault_caught"]
    swap = r["swap"]
    assert swap["failed"] == 0 and not swap["mixed"]
    assert swap["late_on_old"] == 0 and swap["bad_file_refused"]
    assert swap["rebinding_fault_caught"]
    assert r["retune"]["buckets"] == [1, 8]
    assert r["retune"]["graphs"]["captures"] == 2


def test_serve_graph_phases_on_the_cpu(small):
    srv = cs.phase_serve(CPU)[-1]
    _held(cs.phase_serve_graph(CPU, srv, "bf16 BERT server"))
    srv = cs.phase_serve_quant(CPU)[-1]
    _held(cs.phase_serve_graph(CPU, srv, "int8 BERT server", "int8"))
    assert small and all("launch" in w for w in small)


def test_bad_ids_phase_on_the_cpu(small):
    out = cs.phase_bad_ids(CPU, cs._gpt_model(CPU, cs.SEED))
    assert out["good_equals_solo"] and out["negative_equals_wrapped"]
    assert out["past_end_tokens"] == [0] * cs.BAD_ID_NEW_TOKENS
    assert out["errors"] == 0 and not small


def test_optimizer_phases_on_the_cpu(small, monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG,
                                               vocab_size=1001))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 1, "seq": 64})
    res = cs.phase_optimizers(CPU)
    assert sorted(res) == sorted(cs.OPTIMIZER_KW)
    # the same code on the same device both ways: no error at all
    assert all(r["worst_update_error"] == 0.0 for r in res.values())
    assert res["lamb"]["planted_no_trust_ratio"] > cs.OPTIM_STEP_TOL
    steps, out = cs.phase_gpt_train_optimizers(CPU)
    sched = out["sgd_cosine"]["learning_rates"]
    assert sched[0] < sched[1] < sched[2]  # the warmup, then the cosine
    assert out["lamb"]["learning_rates"] == [1e-3] * cs.GPT_TRAIN_STEPS
    assert sorted(steps) == ["lamb", "sgd_cosine"]
    assert small and all("launch" in w for w in small)
