"""A CPU rehearsal of ``chip_smoke.py``'s A.13/A.14 phases on small models:
``phase_library_ops`` (the ops at small shapes, opcheck, the planted
fake), ``phase_bulk`` (the 15-op chain), ``phase_tape_replay`` (a 2-layer
GPT at batch 2 of 256 tokens, the compile on ``aot_eager``),
``phase_symbol_serve`` (a 2-layer BERT of 128 units, seq 256) and
``phase_symbol_train`` (the same GPT through the Executor). The kernels do
not launch on the CPU, so their launch counts read 0: those checks, and
only those, fail here; the device timings are readings, left out."""
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "SEQ", 256)
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, vocab_size=1001, units=128, num_layers=2,
        num_heads=2))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 2, "seq": 256})
    monkeypatch.setattr(cs, "LIB_SERVE", {"batch": 8, "seq": 64})
    monkeypatch.setattr(cs, "BULK_SHAPE", (64, 32))
    monkeypatch.setattr(cs, "BULK_TIMED", 2)
    monkeypatch.setattr(cs, "COMPILE_BACKEND", "aot_eager")
    monkeypatch.setattr(cs, "_export_dir", lambda name: str(tmp_path / name))
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512:
                        bert.BERTModel(vocab_size=cs.VOCAB, units=128,
                                       hidden_size=256, num_layers=2,
                                       num_heads=2, dropout=dropout,
                                       max_length=max_length))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_library_ops_phase_on_the_cpu(small):
    r = cs.phase_library_ops(CPU)
    assert all(all(v == "SUCCESS" for v in res.values())
               for res in r["opcheck"].values())
    assert r["planted_wrong_fake_dtype"]["test_faketensor"] != "SUCCESS"
    assert r["launches_eager"] == r["launches_compiled"]
    assert small and all("launch" in w for w in small)


def test_bulk_phase_on_the_cpu(small):
    r = cs.phase_bulk(CPU)
    assert r["first_chain"]["dispatches"] == 1
    assert r["two_more_chains"]["builds"] == 0
    assert r["bitwise"] and r["new_scalar_bitwise"]
    assert not small


def test_tape_replay_phase_on_the_cpu(small):
    r = cs.phase_tape_replay(CPU)
    assert r["first_loss_bitwise"] and r["grads"]["within"]
    assert r["tape"][0]["compile"] == 1
    assert all(t["hit"] == 1 for t in r["tape"][1:])
    assert r["torch_compile_step"]["loss_rel_err"] <= cs.STEP_LOSS_TOL
    assert small and all("launch" in w for w in small)


def test_symbol_phases_on_the_cpu(small):
    r = cs.phase_symbol_serve(CPU)
    assert r["rows_equal_gluon_server"] and not r["planted_rows_equal"]
    assert r["stats"]["captures"] == 1
    r = cs.phase_symbol_train(CPU)
    assert r["grads"]["within"]
    assert r["stats"]["recaptures"] == 0
    assert r["planted_xent_dx_last_8_cols"]["worst_row_rel_l2"] > \
        cs.GPT_STEP_ROW_TOL
    assert small and all("launch" in w for w in small)
