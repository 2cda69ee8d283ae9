"""A CPU rehearsal of ``chip_smoke.py``'s slice-23 phases at small
settings: ``phase_examples`` (the fine-tune twin on a 2-layer trunk, its
run against the same run on the plain versions and the planted
softmax-xent fault; the PTB LSTM; the long-context ring in a gloo group of
one; a ResNet-18 served with buckets 1 and 8) and ``phase_onnx`` (a 2-layer
BERT of 32 units exported, imported and served, and the perturbed
initializer). The kernels do not launch on the CPU: the launch checks,
and only those, fail here. The planted faults must still be caught."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from torch_port_helpers import few_threads, keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads", "keep_block_names")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch):
    # the tiny trunk learns fast at this rate, so the planted fault's
    # missing gradient shows in the later losses as on BERT-base
    monkeypatch.setattr(cs, "FINETUNE_ARGV", [
        "--tiny", "--seq", "16", "--batch", "4", "--steps", "3",
        "--dtype", "float32", "--lr", "1e-2", "--device", "cpu"])
    monkeypatch.setattr(cs, "PTB_ARGV", [
        "--max-batches", "2", "--num-hidden", "16", "--batch-size", "4",
        "--bptt", "5", "--device", "cpu"])
    monkeypatch.setattr(cs, "LONG_CONTEXT_ARGV", [
        "--seq", "64", "--device", "cpu", "--steps", "2"])
    monkeypatch.setattr(cs, "SERVE_ARGV", [
        "--requests", "10", "--buckets", "1,8", "--device", "cpu"])
    monkeypatch.setattr(cs, "SEQ", 32)
    monkeypatch.setattr(cs, "ONNX_BATCH", 2)
    monkeypatch.setattr(cs, "ONNX_REQUESTS", 4)
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512,
                        **kw: bert.BERTModel(vocab_size=cs.VOCAB, units=32,
                                             hidden_size=64, num_layers=2,
                                             num_heads=2, dropout=dropout,
                                             max_length=max_length, **kw))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_examples_phase_on_the_cpu(small):
    out = cs.phase_examples(CPU)
    ft = out["finetune_bert"]
    assert len(ft["losses"]) == 3 and ft["loss_gap_vs_plain"] == [0.0] * 3
    assert max(ft["planted_xent_gap"]) > cs.STEP_LOSS_TOL
    assert len(out["train_ptb_lm"]["losses"]) == 2
    assert out["train_long_context"]["world"] == 1
    assert out["serve_model"]["rows_vs_direct"] <= cs.SERVE_ROW_TOL
    assert all(out["serve_model"]["bucket_equal_eager"].values())
    # no kernel launches on the CPU: each launch check of the twins with a
    # kernel on their path fails, and only those
    assert small and all("launches" in f for f in small)
    assert {f.split(":")[0] for f in small} == {
        "finetune_bert", "train_ptb_lm", "train_long_context"}


def test_onnx_phase_on_the_cpu(small):
    out = cs.phase_onnx(CPU)
    assert out["rows_max_abs"] <= cs.ONNX_ROW_TOL
    assert out["planted_rows_max_abs"] > cs.ONNX_ROW_TOL
    assert out["forwards"] == 2
    assert small == ["ONNX BERT server: layernorm launches 0 != 25 x 2 "
                     "forwards"]


def test_a_perturbed_initializer_is_found_once():
    arr = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    buf = b"head" + arr.tobytes() + b"tail"
    bad = cs._onnx_perturbed(buf, "w", arr)
    assert len(bad) == len(buf) and bad[:4] == b"head" and bad[-4:] == b"tail"
    want = arr.copy()
    want.flat[::2] += 0.5
    np.testing.assert_array_equal(
        np.frombuffer(bad[4:-4], np.float32).reshape(3, 4), want)
    with pytest.raises(cs.SmokeFailure):
        cs._onnx_perturbed(buf + arr.tobytes(), "w", arr)


def test_argv_helpers():
    argv = ["--seq", "512", "--steps", "3"]
    assert cs._argv_int(argv, "--steps") == 3
    assert cs._argv_with(argv, "--steps", 0) == ["--seq", "512", "--steps",
                                                 "0"]
    assert cs._argv_with(argv, "--batch", 8)[-2:] == ["--batch", "8"]
    assert argv == ["--seq", "512", "--steps", "3"]


def test_slice23_groups_are_listed():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "cuda_phases.py")
    spec = importlib.util.spec_from_file_location("_cuda_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert {"examples", "onnx", "slice23"} <= set(mod.GROUPS)
