"""``mxnet_tpu_torch.image`` against ``mxnet_tpu.image`` on the same seeded
inputs: the decode (the fixture's JPEG records, grayscale, PNG; a process
without a decoder raises), ``imresize`` shrinking and growing by both
interpolations (20x30 -> 45x61 nearest among them), the crops, every
augmenter and ``CreateAugmenter`` under one ``rng`` seed, ``ImageIter``
over a ``.rec`` and a ``.lst``, and the host rule: augmenters return
NDArrays on the CPU whatever the current context is.

uint8 outputs are exact where no resize runs; a bilinear resize's uint8
pixels may part by one level on at most ``RESIZE_PARTED_SHARE`` of them
(``RESIZE_PARTED_SHARE_SMALL`` for outputs of 64 pixels a side or fewer:
truncation after sums that differ in the last bits); floats fp32 1e-4.
"""
import hashlib
import io as _io
import os

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu_torch as mt
from mxnet_tpu import image as ji
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as ti
from torch_port_helpers import (RESIZE_PARTED_SHARE_SMALL,
                                assert_resized_close)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


@pytest.fixture(scope="module")
def payloads():
    src = jrec.RecordSource(os.path.join(FIX, "torch_images.rec"))
    return [src.read(i)[1] for i in range(len(src))]


@pytest.fixture(scope="module")
def img():
    """A (37, 53, 3) uint8 image from the fixture's first record."""
    src = jrec.RecordSource(os.path.join(FIX, "torch_images.rec"))
    return ji.imdecode(src.read(0)[1]).asnumpy()[100:137, 200:253].copy()


def test_decode_is_the_jax_packages_bit_for_bit(payloads):
    ref = np.load(os.path.join(FIX, "torch_images_ref.npz"))
    n0 = ti.counters["decode_pil"]
    for i, buf in enumerate(payloads):
        got = ti.imdecode(buf)
        a = got.asnumpy()
        assert got._data.device.type == "cpu"
        assert np.array_equal(a, ji.imdecode(buf).asnumpy())
        assert hashlib.sha256(a.tobytes()).hexdigest() == ref["decode_sha"][i]
        assert tuple(ref["decode_shape"][i]) == a.shape
    assert ti.counters["decode_pil"] - n0 == len(payloads)
    gray = ti.imdecode(payloads[0], flag=0).asnumpy()
    assert gray.shape[2] == 1
    assert np.array_equal(gray, ji.imdecode(payloads[0], flag=0).asnumpy())
    assert ti.decode_route() == "pil"


def test_png_and_imread(tmp_path, img):
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert np.array_equal(ti.imdecode(buf.getvalue()).asnumpy(), img)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    assert np.array_equal(ti.imread(path).asnumpy(), ji.imread(path).asnumpy())
    np.save(str(tmp_path / "b.npy"), img)
    assert np.array_equal(ti.imread_np(str(tmp_path / "b.npy")), img)


def test_a_process_without_a_decoder_raises(monkeypatch, payloads):
    monkeypatch.setattr(ti, "_PIL", None)
    assert ti.decode_route() is None
    with pytest.raises(RuntimeError, match="PIL unavailable"):
        ti.imdecode(payloads[0])


@pytest.mark.parametrize("src,dst", [((37, 53), (16, 24)), ((20, 30),
                                                             (45, 61)),
                                     ((300, 400), (224, 224)),
                                     ((40, 30), (40, 17))],
                         ids=["shrink", "grow", "imagenet", "one-axis"])
@pytest.mark.parametrize("interp", [0, 1])
def test_imresize(src, dst, interp):
    rng = np.random.RandomState(sum(src + dst) + interp)
    a = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    w, h = dst[1], dst[0]
    got, want = ti.imresize_np(a, w, h, interp), ji.imresize_np(a, w, h,
                                                                interp)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    if interp == 0:
        assert np.array_equal(got, want)
    else:
        assert_resized_close(got, want)
    f = a.astype(np.float32) / 7.0
    got, want = ti.imresize(f, w, h, interp), ji.imresize_np(f, w, h, interp)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-4, atol=1e-4)


def test_crops_and_sizes(img):
    np.random.seed(3)
    want = ji.random_crop(img, (20, 16))
    np.random.seed(3)
    got = ti.random_crop(img, (20, 16))
    assert got[1] == want[1]
    assert np.array_equal(got[0].asnumpy(), want[0].asnumpy())
    got, want = ti.center_crop(img, (60, 30)), ji.center_crop(img, (60, 30))
    assert got[1] == want[1]
    assert_resized_close(got[0].asnumpy(), want[0].asnumpy(),
                         share=RESIZE_PARTED_SHARE_SMALL)
    assert np.array_equal(ti.fixed_crop(img, 3, 4, 10, 12).asnumpy(),
                          ji.fixed_crop(img, 3, 4, 10, 12).asnumpy())
    assert_resized_close(ti.resize_short(img, 24).asnumpy(),
                         ji.resize_short(img, 24).asnumpy(),
                         share=RESIZE_PARTED_SHARE_SMALL)
    np.testing.assert_allclose(
        ti.color_normalize(img, (1, 2, 3), (4, 5, 6)).asnumpy(),
        ji.color_normalize(img, (1, 2, 3), (4, 5, 6)).asnumpy(), rtol=1e-6)
    assert ti.scale_down((40, 30), (60, 50)) == ji.scale_down((40, 30),
                                                              (60, 50))
    for seed in range(2):
        got = ti.random_size_crop(img, (24, 24), 0.3, (0.75, 1.33),
                                  rng=np.random.RandomState(seed))
        want = ji.random_size_crop(img, (24, 24), 0.3, (0.75, 1.33),
                                   rng=np.random.RandomState(seed))
        assert got[1] == want[1]
        assert_resized_close(got[0].asnumpy(), want[0].asnumpy(),
                             share=RESIZE_PARTED_SHARE_SMALL)


def _augmenters(mod, rng):
    return {
        "ResizeAug": mod.ResizeAug(24),
        "ForceResizeAug": mod.ForceResizeAug((30, 20)),
        "RandomCropAug": mod.RandomCropAug((20, 16), rng=rng),
        "RandomSizedCropAug": mod.RandomSizedCropAug(
            (24, 24), (0.2, 1.0), (0.75, 1.33), rng=rng),
        "CenterCropAug": mod.CenterCropAug((30, 30)),
        "HorizontalFlipAug": mod.HorizontalFlipAug(0.5, rng=rng),
        "CastAug": mod.CastAug(),
        "BrightnessJitterAug": mod.BrightnessJitterAug(0.4, rng=rng),
        "ContrastJitterAug": mod.ContrastJitterAug(0.4, rng=rng),
        "SaturationJitterAug": mod.SaturationJitterAug(0.4, rng=rng),
        "HueJitterAug": mod.HueJitterAug(0.3, rng=rng),
        "ColorJitterAug": mod.ColorJitterAug(0.3, 0.3, 0.3, rng=rng),
        "LightingAug": mod.LightingAug(0.1, rng=rng),
        "RandomGrayAug": mod.RandomGrayAug(0.5, rng=rng),
        "ColorNormalizeAug": mod.ColorNormalizeAug((120.0, 110.0, 100.0),
                                                   (50.0, 60.0, 70.0)),
        "RandomOrderAug": mod.RandomOrderAug(
            [mod.CastAug(), mod.BrightnessJitterAug(0.2, rng=rng)], rng=rng),
        "SequentialAug": mod.SequentialAug([mod.CastAug(),
                                            mod.ContrastJitterAug(0.2,
                                                                  rng=rng)]),
    }


RESIZING = ("ResizeAug", "ForceResizeAug", "RandomSizedCropAug")


@pytest.mark.parametrize("name", sorted(_augmenters(ti, None)))
def test_augmenter(name, img):
    for seed in range(3):
        got = _augmenters(ti, np.random.RandomState(seed))[name](img)
        want = _augmenters(ji, np.random.RandomState(seed))[name](img)
        assert got._data.device.type == "cpu"
        g, w = got.asnumpy(), _np(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        if name in RESIZING:
            assert_resized_close(g, w, share=RESIZE_PARTED_SHARE_SMALL)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert _augmenters(ti, None)[name].dumps() == \
        _augmenters(ji, None)[name].dumps()


@pytest.mark.parametrize("kw", [
    dict(resize=40, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, rand_mirror=True, brightness=0.3,
         contrast=0.3, saturation=0.3, hue=0.2, pca_noise=0.1, rand_gray=0.3,
         mean=True, std=True),
    dict(rand_crop=True, mean=(1.0, 2.0, 3.0)),
], ids=["center", "everything", "crop"])
def test_create_augmenter(kw, img):
    for seed in range(3):
        gl = ti.CreateAugmenter((3, 24, 24), rng=np.random.RandomState(seed),
                                **kw)
        wl = ji.CreateAugmenter((3, 24, 24), rng=np.random.RandomState(seed),
                                **kw)
        assert [type(a).__name__ for a in gl] == [type(a).__name__
                                                  for a in wl]
        g, w = img, img
        for a, b in zip(gl, wl):
            g, w = a(g), b(w)
        # a resized pixel one level apart moves by the chain's gains (the
        # jitters' 1 +- 0.3 and the std's 1/57), over its three channels
        assert_resized_close(g.asnumpy(), _np(w), level=2.0, per_pixel=True,
                             share=RESIZE_PARTED_SHARE_SMALL)


def _write_lst(tmp_path, payloads, n=6):
    lines = []
    for i in range(n):
        name = "img%d.jpg" % i
        with open(str(tmp_path / name), "wb") as f:
            f.write(payloads[i])
        lines.append("%d\t%d\t%s" % (i, i % 3, name))
    lst = str(tmp_path / "a.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst


@pytest.mark.parametrize("source", ["rec", "lst"])
def test_image_iter(source, tmp_path, payloads):
    kw = dict(batch_size=3, data_shape=(3, 24, 24), resize=32,
              rand_crop=True, rand_mirror=True, shuffle=True, mean=True,
              std=True)
    if source == "rec":
        kw["path_imgrec"] = os.path.join(FIX, "torch_images.rec")
    else:
        kw.update(path_imglist=_write_lst(tmp_path, payloads),
                  path_root=str(tmp_path))
    jit = ji.ImageIter(**kw)
    with mt.cpu():
        tit = ti.ImageIter(**kw)
        for _ in range(2):
            g, w = tit.next(), jit.next()
            assert_resized_close(g.data[0].asnumpy(), w.data[0].asnumpy(),
                                 level=1 / 57.0,
                                 share=RESIZE_PARTED_SHARE_SMALL)
            assert np.array_equal(g.label[0].asnumpy(), w.label[0].asnumpy())
        assert g.data[0].shape == (3, 3, 24, 24)
        assert tit.provide_data[0].shape == (3, 3, 24, 24)


def test_malformed_lst_raises(tmp_path):
    lst = str(tmp_path / "bad.lst")
    with open(lst, "w") as f:
        f.write("0\tonly_two\n")
    with pytest.raises(ValueError, match="malformed"):
        ti.ImageIter(2, (3, 8, 8), path_imglist=lst)


def test_image_det_iter_name():
    assert ti.ImageDetIter is mt.io.ImageDetRecordIter


def test_host_rule(img, payloads):
    """Under a card's context (none is present here: any copy to it would
    raise), decode, every augmenter and the detection augmenters still
    return NDArrays on the CPU."""
    with mt.gpu(0):
        x = ti.imdecode(payloads[0])
        assert x._data.device.type == "cpu"
        for aug in _augmenters(ti, np.random.RandomState(0)).values():
            assert aug(img)._data.device.type == "cpu"
        label = np.array([[1, 0.1, 0.1, 0.6, 0.7]], np.float32)
        for aug in ti.CreateDetAugmenter((3, 16, 16), rand_crop=1,
                                         rand_pad=1, rand_mirror=True,
                                         rng=np.random.RandomState(1)):
            img, label = aug(img, label)
            assert img._data.device.type == "cpu"
