"""A CPU rehearsal of ``chip_smoke.py``'s slice-20 paths at small widths:
(d) ``phase_image_decode`` (the fixture's records against the JAX
package's decode, a planted chroma swap), (a) ``phase_image_record_resnet``
and (c) ``phase_vision_loader`` (a thumbnail ``resnet18_v1`` fed 32 x 32
crops by ``ImageRecordIter`` and by the vision DataLoader with 0, 4 thread
and 2 process workers, one batch each), (b) ``phase_image_det_ssd`` (a two-scale SSD at
64 x 64 fed by ``ImageDetRecordIter``) and (e) ``phase_observability`` (a
2-layer BERT and a 2-layer GPT served with ``metrics_port=0``). The
kernels do not launch on the CPU, so the launch counts read 0: those
checks, and only those, fail here."""
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch.models.bert as bert
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import ssd
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "RESNET", {"batch": 4, "size": 32,
                                       "classes": 16})
    monkeypatch.setattr(cs, "IMAGE_TRAIN", {"size": 32, "resize": 40})
    monkeypatch.setattr(cs, "IMAGE_RECORDS", 16)
    monkeypatch.setattr(cs, "IMAGE_STEPS", 2)
    monkeypatch.setattr(cs, "IMAGE_THREADS", 2)
    monkeypatch.setattr(cs, "SSD_RECIPE", {"batch": 4, "size": 64,
                                           "boxes": 3, "classes": 3})
    monkeypatch.setattr(cs, "SSD_STEPS", 3)
    monkeypatch.setattr(cs, "LOADER_BATCHES", 1)
    monkeypatch.setattr(cs, "SEQ", 64)
    monkeypatch.setattr(cs, "GPT_CONFIG", dict(
        cs.GPT_CONFIG, vocab_size=1001, units=64, num_layers=2,
        num_heads=2, max_length=256))
    monkeypatch.setattr(cs, "GPT_VOCAB", 1001)
    monkeypatch.setattr(vision, "resnet50_v1", lambda classes=1000:
                        vision.get_resnet(1, 18, classes=classes,
                                          thumbnail=True))
    monkeypatch.setattr(ssd, "ssd_512", lambda num_classes: ssd.SSD(
        num_classes=num_classes, sizes=((0.2, 0.3), (0.5, 0.6)),
        ratios=((1, 2),) * 2))
    monkeypatch.setattr(bert, "bert_base", lambda dropout=0.1, max_length=512:
                        bert.BERTModel(vocab_size=cs.VOCAB, units=64,
                                       hidden_size=128, num_layers=2,
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
    yield failed
    for d in cs._slice20_tmp:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    del cs._slice20_tmp[:]


def test_image_paths_on_the_cpu(small):
    d = cs.phase_image_decode(CPU)
    assert d["torch_images"]["bit_equal"] == 16
    assert d["torch_images_det"]["planted_fault_equal"] == 0
    step, a = cs.phase_image_record_resnet(CPU)
    assert a["fixture_digest_equal"] and a["first_loss_bit_equal"]
    assert a["image_device_allocs"] == 0 and a["image_on"] == "cpu"
    c = cs.phase_vision_loader(CPU, step)
    assert c["serial_byte_equal"] and c["threads"]["byte_equal"]
    assert c["processes"]["byte_equal"]
    b = cs.phase_image_det_ssd(CPU)
    assert b["first_loss_bit_equal"] and b["label_shape"] == [4, 8, 5]
    assert small and all("launch" in w for w in small)


def test_observability_path_on_the_cpu(small):
    e = cs.phase_observability(CPU)
    assert not e["trace_faults"] and e["traffic_events"] == 0
    assert len(e["retune_events"]) == len(cs.OBS_BUCKETS_RETUNED)
    assert e["ttft"]["count"] == cs.OBS_STREAMS
    assert all(want == got for want, got in e["scrape"].values())
    assert small and all("launch" in w for w in small)
