"""A CPU rehearsal of ``chip_smoke.py``'s ``phase_model_parallel`` and
``phase_tp_compute`` at small sizes, over a gloo group of one rank: a
small GPT (2 layers, 128 units, 2 heads of 64, batch 1 of 256 tokens, one
step) in ``sequence_parallel_scope``, the n = 4 ring replayed at (1, 2,
256, 64), the FFN step, ``moe_ffn``, 1F1B and ``SyncBatchNorm``; then
the tp = 4 replay, the vocabulary-parallel loss and the tp = 1 step. The
kernels do not launch on the CPU, so their launch counts read 0: those
checks, and only those, fail here."""
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.parallel import distributed
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, units=128, num_layers=2, num_heads=2,
        vocab_size=1001))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 1, "seq": 256})
    monkeypatch.setattr(cs, "GPT_TRAIN_STEPS", 1)
    monkeypatch.setattr(cs, "MP_RING", {"batch": 1, "heads": 2, "seq": 256,
                                        "head_dim": 64, "n": 4})
    monkeypatch.setattr(cs, "MP_FFN", {"units": 64, "hidden": 256,
                                       "tokens": 128})
    monkeypatch.setattr(cs, "MOE", dict(cs.MOE, units=64, hidden=128,
                                        tokens=256))
    monkeypatch.setattr(cs, "PIPE", {"micro": 4, "batch": 1, "seq": 64})
    monkeypatch.setattr(cs, "SYNC_BN_SHAPE", (8, 16, 8, 8))
    monkeypatch.setattr(cs, "device_step_ms", lambda fn, n: (0.0, 0.0))
    monkeypatch.setattr(cs, "time_ms", lambda *fns, **kw: [0.0] * len(fns))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    yield failed
    distributed.shutdown()


def test_model_parallel_phase_on_the_cpu(small):
    r = cs.phase_model_parallel(torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    for impl in ("ring", "ulysses"):
        g = r["gpt2_sp1"][impl]
        assert g["first_loss_bitwise"] and g["unreached_equal"]
        # the plain versions are deterministic: no place differs
        assert g["differs"] == [0] and g["grads"]["worst_grad_rel_l2"] == 0
    for case in r["ring_n4"]["cases"]:
        assert all(case["within"].values()) and case["planted_caught"]
        assert case["skipped"] == (6 if case["causal"] else 0)
    assert r["tp_step"]["bitwise"] and r["sync_bn_dp1"]["bitwise"]
    assert r["moe_ep1"]["rel_l2"] <= cs.MOE_REL_TOL
    assert r["pipeline_pp1"]["worst_grad_rel_l2"] <= cs.PIPE_REL_TOL
    # the launch counts, and only they, read 0 on the CPU
    assert small and all("launch" in w for w in small)


def test_tp_compute_phase_on_the_cpu(small, monkeypatch):
    """``phase_tp_compute`` at 4 heads of 32 (so tp = 4 splits them), a
    vocabulary the axis does not divide (as GPT-2's) and a (16, 2 x 500)
    MLM head: the replay within twice the unsplit error of fp32, the
    planted merge fault caught, the tp = 1 step's first loss bit for bit;
    only the launch counts fail."""
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(cs.GPT_CONFIG, num_heads=4))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 2, "seq": 64})
    monkeypatch.setattr(cs, "TP_XENT", {"rows": 16, "vocab": 1000, "n": 2})
    r = cs.phase_tp_compute(torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    rep = r["gpt2_tp4_replay"]
    assert rep["paths"] == {"split": 4, "gathered": 0, "gathered_leaves": 0}
    assert all(v[2] <= cs.TP_ERR_RATIO for v in rep["errors"].values())
    x = r["bert_mlm_xent_tp2"]
    assert all(x["within"].values()) and x["planted_caught"]
    st = r["train_step_tp1"]
    assert st["first_loss_bitwise"] and st["unreached_equal"]
    assert st["paths"]["gathered_leaves"] == 0
    assert small and all("launch" in w for w in small)
