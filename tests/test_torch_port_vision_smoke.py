"""A CPU rehearsal of ``chip_smoke.py``'s vision phases with a small ResNet
in place of ResNet-50 (``resnet18_v1``, thumbnail: 3x3 stem, batch 4 of
32x32 images, 16 classes): ``phase_resnet_train`` (the steps on one
batch, the plain-version comparison and its planted faults, the bf16 step
against the fp32 step, the BatchNorm probe), ``phase_resnet_timing``
(each softmax-xent kernel held to its plain version at the step's shape),
``phase_resnet_serve`` (bf16 and int8 servers with buckets 1, 2 and 4,
the int8 convolution against the exact product) and ``phase_vision_zoo``
(three small families, batch 2). The kernels do not launch on the CPU, so
their launch counts read 0: those checks, and only those, fail here; the
timings and the profiler breakdown are card readings, left out."""
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.gluon.model_zoo import vision
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
    monkeypatch.setattr(cs, "RESNET", {"batch": 4, "size": 32,
                                       "classes": 16})
    monkeypatch.setattr(cs, "RESNET_STEPS", 3)
    monkeypatch.setattr(cs, "RESNET_TIMED", 2)
    monkeypatch.setattr(cs, "RESNET_REQUESTS", 6)
    monkeypatch.setattr(cs, "RESNET_BUCKETS", (1, 2, 4))
    monkeypatch.setattr(cs, "ZOO_BATCH", 2)
    monkeypatch.setattr(cs, "ZOO_FAMILIES", (("squeezenet1.1", 64),
                                             ("mobilenetv2_1.0", 32),
                                             ("resnet18_v2", 32)))
    monkeypatch.setattr(vision, "resnet50_v1", lambda classes=1000:
                        vision.get_resnet(1, 18, classes=classes,
                                          thumbnail=True))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(cs, "time_ms", lambda *fns, **kw: [0.0] * len(fns))
    monkeypatch.setattr(cs, "bucket_device_ms", lambda pool, b: (0.0, 0.0))
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_vision_phases_on_the_cpu(small):
    step, r = cs.phase_resnet_train(CPU)
    assert len(r["losses"]) == 3 and r["losses"][-1] < r["losses"][0]
    # the plain step against itself reads 0; each planted fault is caught,
    # the plain step run again is not
    assert r["vs_plain"]["loss_err"] == 0.0
    assert r["vs_plain"]["worst_grad_rel_l2"][0][0] == 0.0
    for name, (bn, wrappers) in cs.RESNET_FAULTS.items():
        assert r["planted_faults"][name]["caught"] == (
            bn is not None or bool(wrappers)), name
    assert r["batchnorm_probe"]["unbiased_planted_err"] > 1e-3
    assert r["bf16_vs_fp32"]["worst_grad_rel_l2"][0][0] > 0
    assert r["bf16_vs_fp32"]["zeroed_gammas"] == 8
    records = [{"name": "softmax_xent_fwd"}, {"name": "softmax_xent_bwd"}]
    cs.phase_resnet_timing(CPU, records, r)
    for rec in records:
        g = rec["resnet50_train"]
        assert g["check"] and g["bound_ms"] > 0 and g["launches"] == 0
        assert g["shape"] == [4, 16]
    serve = cs.phase_resnet_serve(CPU, step.net)
    for mode in ("bf16", "int8"):
        assert all(serve[mode]["graph_equals_eager"].values())
        assert serve[mode]["forwards"] >= 2
    assert serve["int8"]["quant_conv_exact"]["shapes"] >= 4
    assert 0.0 <= serve["int8_top1_agreement_with_bf16"] <= 1.0
    zoo = cs.phase_vision_zoo(CPU)
    assert set(zoo) == {"squeezenet1.1", "mobilenetv2_1.0", "resnet18_v2"}
    # the launch counts, and only they, read 0 on the CPU
    assert small and all("launch" in w for w in small)
