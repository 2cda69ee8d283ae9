"""A CPU rehearsal of ``chip_smoke.py``'s A.11 phases with small models in
place of bench.py's: a 2 x 16 tied LSTM over a vocabulary of 100 (batch 4
x bptt 5), SSD at 64 x 64 with two scales (batch 4, 3 boxes an image), a
1 + 1 layer Transformer of 32 units over a vocabulary of 64 (batch 4 of
6 + 5 tokens): ``phase_lstm_train`` (the plain-version comparison and its
planted faults: the gates swapped, the xent dx's last columns dropped),
``phase_lstm_infer``, ``phase_ssd_train`` (the loss falls; the batch-2
step against the CPU), ``phase_ssd_detect``, ``phase_nmt_train``,
``phase_nmt_translate`` and ``phase_a11_timing`` (each kernel held to its
plain version at the path's shape). The kernels do not launch on the CPU,
so their launch counts read 0: those checks, and only those, fail here;
the timings are card readings, left out."""
import contextlib

import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.models import lstm_lm, ssd, transformer
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "LSTM_RECIPE", {"vocab": 100, "batch": 4,
                                            "bptt": 5})
    monkeypatch.setattr(cs, "NMT_RECIPE", {"vocab": 64, "batch": 4,
                                           "src_len": 6, "tgt_len": 5,
                                           "max_len": 16})
    monkeypatch.setattr(cs, "NMT_TRANSLATE", {"batch": 2, "max_len": 6,
                                              "beam": 2})
    monkeypatch.setattr(cs, "SSD_RECIPE", {"batch": 4, "size": 64,
                                           "boxes": 3, "classes": 3})
    monkeypatch.setattr(cs, "SSD_STEPS", 3)
    monkeypatch.setattr(cs, "SSD_DETECT_BATCH", 2)
    monkeypatch.setattr(cs, "A11_STEPS", 2)
    monkeypatch.setattr(cs, "A11_TIMED", 1)
    monkeypatch.setattr(lstm_lm, "lstm_ptb", lambda vocab_size,
                        tie_weights, dropout: lstm_lm.RNNModel(
                            "lstm", vocab_size, num_embed=16, num_hidden=16,
                            num_layers=2, dropout=dropout,
                            tie_weights=tie_weights))
    monkeypatch.setattr(ssd, "ssd_512", lambda num_classes: ssd.SSD(
        num_classes=num_classes, sizes=((0.2, 0.3), (0.5, 0.6)),
        ratios=((1, 2),) * 2))
    monkeypatch.setattr(transformer, "transformer_base", lambda s, t, **kw:
                        transformer.TransformerModel(
                            s, t, units=32, hidden=64, num_layers=1,
                            num_heads=4, **kw))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(cs, "time_ms", lambda *fns, **kw: [0.0] * len(fns))
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_a11_phases_on_the_cpu(small):
    (lstm_step, ssd_step, nmt_step), out = cs.run_a11(CPU)
    for key, faults in (("lstm_train", cs.LSTM_FAULTS),
                        ("nmt_train", cs.NMT_FAULTS)):
        r = out[key]
        assert len(r["losses"]) == 2
        # the plain step against itself reads 0; each planted fault is
        # caught, the plain step run again is not
        assert r["vs_plain"]["loss_err"] == 0.0
        assert r["vs_plain"]["worst_grad_rel_l2"][0][0] == 0.0
        for name, (wrappers, patch) in faults.items():
            assert r["planted_faults"][name]["caught"] == (
                bool(wrappers) or patch is not contextlib.nullcontext), name
    assert out["lstm_train"]["recurrence"]["layers"] == 2
    assert out["lstm_infer"]["card_vs_cpu_rel_l2"] == 0.0
    assert out["lstm_infer"]["chunked_vs_whole_rel_l2"] <= 1e-6
    r = out["ssd_train"]
    assert r["losses"][-1] < r["losses"][0]
    assert r["vs_cpu"]["loss_err"] == 0.0
    d = out["ssd_detect"]
    assert d["anchors"] == 60 and d["kept"] > 0 and d["differ_from_cpu"] == 0
    t = out["nmt_translate"]
    for label in ("bf16", "fp32"):
        assert t[label]["equal"] and not t[label]["partings"]
    assert 1 < t["beam"]["tokens"] <= 6
    records = [{"name": n} for n in ("layernorm_fwd", "layernorm_bwd",
                                     "softmax_xent_fwd", "softmax_xent_bwd")]
    cs.phase_a11_timing(CPU, records, out["lstm_train"], out["nmt_train"])
    rec = {r["name"]: r for r in records}
    assert rec["layernorm_fwd"]["nmt_train"]["shape"] == [20, 512]
    assert rec["softmax_xent_fwd"]["lstm_train"]["shape"] == [20, 100]
    assert rec["softmax_xent_bwd"]["nmt_train"]["shape"] == [20, 64]
    for r in records:
        for tag in ("lstm_train", "nmt_train"):
            if tag in r:
                assert r[tag]["check"] and r[tag]["bound_ms"] > 0
    # the launch counts, and only they, read 0 on the CPU
    assert small and all("launch" in w for w in small)
