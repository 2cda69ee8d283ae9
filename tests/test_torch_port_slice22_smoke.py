"""A CPU rehearsal of ``chip_smoke.py``'s slice-22 phases on small models:
``phase_ir`` (the MLP at (64, 32) through the window and a Symbol.eval, a
2-layer BERT of 32 units served from its export through the IR, the
watchdog, the planted cast_sink), ``phase_tune`` (the search over that
export's bucket program, the fresh process run in this one from its own
counts, the bulk watermark; the fp32 flash search must refuse off the
card) and ``phase_comp_cache`` (a 2-layer GPT's step compiled through
``cache.AotFn`` on ``aot_eager``, the warm process run in this one). The
kernels do not launch on the CPU, and ``aot_eager`` generates no code for
the store to keep: the launch checks and the ``comp_cache:`` checks, and
only those, fail here."""
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from mxnet_tpu_torch.ir import tune
from torch_port_helpers import few_threads, keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads", "keep_block_names")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "SEQ", 64)
    monkeypatch.setattr(cs, "IR_SHAPE", (64, 32))
    monkeypatch.setattr(cs, "BULK_SHAPE", (16, 8))
    monkeypatch.setattr(cs, "BULK_SMALL_SHAPE", (2, 8))
    monkeypatch.setattr(cs, "TUNE_PAIRS", 1)
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, vocab_size=1001, units=64, num_layers=2,
        num_heads=2))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 2, "seq": 64})
    monkeypatch.setattr(cs, "COMPILE_BACKEND", "aot_eager")
    monkeypatch.setattr(cs, "_export_dir", lambda name: str(tmp_path / name))
    monkeypatch.setattr(cs, "_slice22_dir", lambda: str(tmp_path))
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512:
                        bert.BERTModel(vocab_size=cs.VOCAB, units=32,
                                       hidden_size=64, num_layers=2,
                                       num_heads=2, dropout=dropout,
                                       max_length=max_length))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    def child_here(args, env, timeout):
        """The fresh process's function, run in this process with its
        environment."""
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        tune.reset_store()
        try:
            assert args[0] == "--fresh-child"
            return cs.fresh_child(*args[1:], dev=CPU), 0.0, ""
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            tune.reset_store()

    monkeypatch.setattr(cs, "_child_json", child_here)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what and not what.startswith("comp_cache:"):
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_ir_phase_on_the_cpu(small):
    prefix, model = cs._bert_export(CPU, "ir_bert")
    r = cs.phase_ir(CPU, prefix, model)
    m = r["mlp"]
    assert m["builds"]["bulk"] + m["builds"]["symbol"] == 1
    assert m["programs"] == 1 and m["ir_entries"] == 1
    assert m["window_bitwise_chain"] and m["symbol_bitwise_window"]
    assert r["serve"]["rows_equal_gluon_server"]
    assert r["serve"]["ir_graph_builds"] >= 1
    assert r["watchdog_events_steady"] == 0
    assert r["planted_cast_sink"]["max_abs_err"] > 1e-6
    assert not r["planted_cast_sink"]["passes_gate"]
    assert small and all("launch" in w for w in small)


def test_tune_phase_on_the_cpu(small):
    prefix, _ = cs._bert_export(CPU, "ir_bert")
    r = cs.phase_tune(CPU, prefix)
    assert r["search"]["candidates"] == len(tune.candidate_configs())
    assert r["search"]["parity_rejects"] == 0
    c = r["fresh_process"]
    assert c["searches"] == 0 and c["store_hits"] >= 1
    assert c["tuned_builds"] >= 1 and c["watchdog_events"] == 0
    assert set(r["bulk_watermark"]) == {"16x8", "2x8"}
    assert r["flash_refused_off_card"]
    assert os.environ.get("MXNET_TUNE_STORE") is None
    assert not small


def test_comp_cache_phase_on_the_cpu(small):
    cold = cs._compiled_gpt_step(CPU)
    assert cold["aot_compiles"] == 1
    prefix, _ = cs._bert_export(CPU, "ir_bert")
    tuned = cs.phase_tune(CPU, prefix, fresh=False)
    assert "fresh_process" not in tuned
    r = cs.phase_comp_cache(CPU, cold, tuned, prefix)
    c = tuned["fresh_process"]
    assert c["searches"] == 0 and c["store_hits"] >= 1
    w, t = r["fresh_process"]["warm"], r["fresh_process"]["truncated"]
    assert w["loss_bitwise"] and w["launches_equal"]
    assert w["grads_bitwise"] == w["grads_total"]  # no flash kernel here
    assert t["aot_compiles"] == 1 and t["loss_bitwise"]
    assert not r["features"]["CUDA"] and r["features"]["CPU"]
    assert small and all(w_.startswith("comp_cache:") for w_ in small)


def test_slice22_runs_other_phases_beside_its_fresh_process(small,
                                                            monkeypatch):
    """``run_slice22(meanwhile=)``: the fresh process starts once the tuner
    has written its record, ``meanwhile`` runs before the wait for it, and
    the process is stopped at the end."""
    cold = cs._compiled_gpt_step(CPU)
    order = []
    run_here = cs._child_json  # the fixture's process run in this one

    def start(args, env):
        order.append("start")
        assert os.path.exists(env["MXNET_TUNE_STORE"])
        return {"args": args, "env": env}

    def result(child, timeout):
        order.append("wait")
        return run_here(child["args"], child["env"], timeout)

    monkeypatch.setattr(cs, "_child_start", start)
    monkeypatch.setattr(cs, "_child_result", result)
    monkeypatch.setattr(cs, "_child_stop", lambda c: order.append("stop"))
    out = cs.run_slice22(CPU, cold,
                         meanwhile=lambda: order.append("meanwhile"))
    assert order == ["start", "meanwhile", "wait", "stop"]
    assert out["meanwhile_s"] >= 0.0
    w = out["comp_cache"]["fresh_process"]["warm"]
    assert w["loss_bitwise"] and w["launches_equal"]


def test_a_failed_fresh_process_fails_its_check():
    """A fresh process that exits with another code than 0 fails the
    phase's check, naming the code (here ``chip_smoke.py`` finds no card
    and exits 2)."""
    child = cs._child_start(["--fresh-child", "-", "-"], {})
    with pytest.raises(cs.SmokeFailure, match="exited 2"):
        cs._child_result(child, 300)
    cs._child_stop(child)
