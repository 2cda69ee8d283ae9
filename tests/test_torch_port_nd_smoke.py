"""A CPU rehearsal of ``chip_smoke.py``'s ``nd`` phases with a small GPT
(2 layers, 128 units, vocab 1001, batch 1 of 64 tokens) and small kernel
cases: ``phase_nd_train`` (the NDArray idiom beside the tensor path, three
steps; bitwise here, where nothing sums in a loose order),
``phase_nd_ops`` (every case of ``tools/nd_op_cases.py``, the CPU against
itself) and ``phase_create_graph`` (the WGAN-GP critic at its real
width). The kernels do not launch on the CPU, and the LayerNorm's plain
path takes an exact second derivative there, the unguarded Function's
too (the fault shows only on the card): the launch checks and the checks
of the raise and of the planted fault, and only those, fail here."""
import pytest
import torch

import chip_smoke as cs
from torch_port_helpers import few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


ALLOWED = ("launch", "did not raise", "went unseen")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, units=128, num_layers=2, num_heads=2,
        vocab_size=1001))
    monkeypatch.setattr(cs, "GPT_TRAIN", {"batch": 1, "seq": 64})
    monkeypatch.setattr(cs, "ND_KERNEL_SHAPES", {
        "layernorm": (2, 16, 768), "xent_rows": 64, "flash": (1, 2, 256,
                                                              64)})
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    failed = []

    def check(cond, what):
        if not cond:
            if not any(s in what for s in ALLOWED):
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_nd_phases_on_the_cpu(small):
    dev = torch.device("cpu")
    r = cs.phase_nd_train(dev)
    assert len(r["steps"]) == cs.GPT_TRAIN_STEPS
    for row in r["steps"]:
        assert row["loss_bitwise"] and row["params_differing_nd"] == 0
    ops = cs.phase_nd_ops(dev)
    assert ops["failures"] == [] and ops["cases"] > 300
    cg = cs.phase_create_graph(dev)
    assert max(cg["rel_l2"]) <= cs.CRITIC_TOL
    assert max(cg["planted_rel_l2"]) <= cs.CRITIC_TOL
    assert cg["layernorm_raised"] is None
    assert small and all(any(s in f for s in ALLOWED) for f in small)
