"""A CPU rehearsal of ``chip_smoke.py``'s A.14/A.15 phases on small models:
``phase_module_fit`` (a 2-layer GPT through ``Module.fit``),
``phase_data_pipeline`` (a 2-layer BERT fed by the DataLoader, thread and
process workers), ``phase_bucketing_lstm`` (``lstm_ptb`` through
``BucketingModule``, with ``phase_control_flow`` at the LSTM's width) and
``phase_get_symbol``. The kernels do not launch on the CPU, so their launch
counts read 0: those checks, and only those, fail here."""
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, vocab_size=1001, units=128, num_layers=2,
        num_heads=2))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 2, "seq": 64})
    monkeypatch.setattr(cs, "BERT128", {"batch": 8, "seq": 32, "masked": 4})
    monkeypatch.setattr(cs, "PIPELINE_SAMPLES", 32)
    monkeypatch.setattr(cs, "LSTM_RECIPE", dict(cs.LSTM_RECIPE, vocab=500,
                                                batch=4))
    monkeypatch.setattr(cs, "_export_dir", lambda name: str(tmp_path / name))
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512:
                        bert.BERTModel(vocab_size=cs.VOCAB, units=128,
                                       hidden_size=256, num_layers=2,
                                       num_heads=2, dropout=dropout,
                                       max_length=max_length))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_module_fit_phase_on_the_cpu(small):
    r = cs.phase_module_fit(CPU)
    assert r["first_loss_bitwise"] and r["grads"]["within"]
    assert r["planted_stale_weights"][-1] > 0
    assert r["loaded_bitwise"]
    assert small and all("launch" in w for w in small)


def test_data_pipeline_phase_on_the_cpu(small):
    r = cs.phase_data_pipeline(CPU)
    assert r["batches_equal_cpu"] and r["process_batches_equal_cpu"]
    assert r["steps"][0]["params_apart"]["by_hand"] == 0
    assert r["steps"][0]["params_apart"]["planted_rebinding_clip"] > 0
    assert small and all("launch" in w for w in small)


def test_bucketing_and_get_symbol_phases_on_the_cpu(small):
    r = cs.phase_bucketing_lstm(CPU)
    assert r["buckets"] == [10, 20, 35] and r["shared_dicts"]
    assert r["control_flow"]["cond_grad_finite"]
    g = cs.phase_get_symbol(CPU)
    assert g["bitwise"] and g["tojson_refused"]
    assert small and all("launch" in w for w in small)
