"""The port's image record iterators against ``mxnet_tpu.io``'s on the
fixture's records at the same numpy seed: ``ImageRecordIter`` by the
native route (the committed ``libmxtpu_im.so``: uint8 and float batches
bit for bit) and by the Python route (within the resize's stated share),
``ImageRecordUInt8Iter`` and its refusal, the route counters and the
reasons recorded where the JAX package falls back silently,
``ImageDetRecordIter`` (labels exact), ``pack_det_label``, the
``label_pad_width`` overflow, the ``Det*`` augmenters under one ``rng``
seed, ``pack_img``/``unpack_img``, and the fixture tool re-run into a
temporary directory giving the committed files and digests."""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu import image as ji
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as ti
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from torch_port_helpers import (RESIZE_PARTED_SHARE_FLAT,
                                RESIZE_PARTED_SHARE_SMALL,
                                assert_resized_close)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
REC = os.path.join(FIX, "torch_images.rec")
DET = os.path.join(FIX, "torch_images_det.rec")
KW = dict(data_shape=(3, 48, 48), batch_size=4, resize=56, rand_mirror=True,
          shuffle=True, mean_r=123.68, mean_g=116.28, mean_b=103.53,
          std_r=58.395, std_g=57.12, std_b=57.375)


def _batches(make, n=2, seed=11):
    np.random.seed(seed)
    it = make()
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    return it, out, np.random.get_state()[1].copy()


def _both(kw, n=2):
    _, want, s_want = _batches(lambda: jio.ImageRecordIter(REC, **kw), n)
    with mt.cpu():
        it, got, s_got = _batches(lambda: tio.ImageRecordIter(REC, **kw), n)
    assert np.array_equal(s_got, s_want)  # the same numpy draws
    return it, got, want


def test_native_route_bit_for_bit():
    n0 = tio.counters["image_native"]
    it, got, want = _both(KW)
    assert it.route == "native" and it.route_reason is None
    for (g, gl), (w, wl) in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        assert np.array_equal(g, w) and np.array_equal(gl, wl)
    assert tio.counters["image_native"] - n0 == 2


def test_native_uint8_and_refusal():
    kw = {k: v for k, v in KW.items() if not k.startswith(("mean", "std"))}
    _, want, _ = _batches(lambda: jio.ImageRecordUInt8Iter(REC, **kw))
    with mt.cpu():
        _, got, _ = _batches(lambda: tio.ImageRecordUInt8Iter(REC, **kw))
    for (g, gl), (w, wl) in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        assert np.array_equal(g, w) and np.array_equal(gl, wl)
    for mod in (tio, jio):
        with pytest.raises(TypeError, match="normalization"):
            mod.ImageRecordUInt8Iter(REC, (3, 8, 8), 2, mean_r=1.0)


def test_python_route_within_the_resize_share():
    n0 = tio.counters["image_python"]
    kw = dict(KW, force_python=True)
    it, got, want = _both(kw)
    assert it.route == "python" and it.route_reason == "force_python=True"
    for (g, gl), (w, wl) in zip(got, want):
        assert np.array_equal(gl, wl)
        assert_resized_close(g, w, level=1 / 57.0,
                             share=RESIZE_PARTED_SHARE_SMALL)
    assert tio.counters["image_python"] - n0 == 2
    assert tio.route_reasons["force_python=True"] >= 1


def test_python_uint8_route():
    kw = {k: v for k, v in KW.items() if not k.startswith(("mean", "std"))}
    kw["force_python"] = True
    _, want, _ = _batches(lambda: jio.ImageRecordUInt8Iter(REC, **kw))
    with mt.cpu():
        _, got, _ = _batches(lambda: tio.ImageRecordUInt8Iter(REC, **kw))
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        assert_resized_close(g, w, share=RESIZE_PARTED_SHARE_SMALL)


@pytest.mark.parametrize("case", ["rand_crop", "gray", "no_library"])
def test_refusals_are_counted_with_their_reason(case, monkeypatch):
    kw = dict(KW)
    if case == "rand_crop":
        kw["rand_crop"] = True
        want = "rand_crop takes the Python route"
    elif case == "gray":
        kw["data_shape"] = (1, 48, 48)
        want = "the native pipeline decodes RGB only"
    else:
        monkeypatch.setattr(tio, "_im_lib", None)
        monkeypatch.setattr(tio, "_im_error", "libmxtpu_im.so does not load:"
                            " planted")
        want = "libmxtpu_im.so does not load"
    before = dict(tio.route_reasons)
    with mt.cpu():
        it = tio.ImageRecordIter(REC, **kw)
        n0 = tio.counters["image_python"]
        it.next()
    assert it.route == "python" and it.route_reason.startswith(want)
    assert tio.route_reasons[it.route_reason] == \
        before.get(it.route_reason, 0) + 1
    assert tio.counters["image_python"] - n0 == 1


def test_fixture_digests_by_both_routes():
    """The fixture's stated reading: the JAX native route's digest is the
    port's native route's; the port's Python route is the one recorded."""
    from tools.gen_torch_image_fixture import ITER_KW, ITER_SEED, digest

    ref = np.load(os.path.join(FIX, "torch_images_ref.npz"))
    for kw, key in (({}, "jax_native_batch0"),
                    ({"force_python": True}, "port_python_batch0")):
        np.random.seed(ITER_SEED)
        with mt.cpu():
            b = tio.ImageRecordIter(REC, **ITER_KW, **kw).next()
        assert digest(b.data[0].asnumpy(), b.label[0].asnumpy()) == \
            str(ref[key])
    assert ref["port_python_parted_share"] <= 0.01


def test_fixture_tool_reproduces_the_committed_files(tmp_path):
    from tools import gen_torch_image_fixture as gen

    gen.main([str(tmp_path)])
    for name in ("torch_images.rec", "torch_images.idx",
                 "torch_images_det.rec", "torch_images_det.idx"):
        with open(os.path.join(FIX, name), "rb") as a, \
                open(str(tmp_path / name), "rb") as b:
            assert a.read() == b.read(), name
    new = np.load(str(tmp_path / "torch_images_ref.npz"))
    old = np.load(os.path.join(FIX, "torch_images_ref.npz"))
    assert sorted(new.files) == sorted(old.files)
    for k in old.files:
        assert np.array_equal(new[k], old[k]), k
    total = sum(os.path.getsize(os.path.join(FIX, f)) for f in os.listdir(FIX)
                if f.startswith("torch_images"))
    assert total < 2 * 1024 * 1024


DET_KW = dict(data_shape=(3, 40, 40), batch_size=4, rand_crop=1, rand_pad=1,
              rand_mirror=True, label_pad_width=8, mean_r=123.68,
              mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
              std_b=57.375)


def test_det_iterator():
    n0 = tio.counters["image_python"]
    _, want, s_want = _batches(lambda: jio.ImageDetRecordIter(DET, **DET_KW))
    with mt.cpu():
        it, got, s_got = _batches(
            lambda: tio.ImageDetRecordIter(DET, **DET_KW))
    assert np.array_equal(s_got, s_want)
    for (g, gl), (w, wl) in zip(got, want):
        assert gl.shape == (4, 8, 5) and np.array_equal(gl, wl)
        assert_resized_close(g, w, level=1 / 57.0,
                             share=RESIZE_PARTED_SHARE_FLAT)
    assert it.route == "python"
    assert tio.counters["image_python"] - n0 == 2


def test_det_label_padding_and_overflow():
    kw = dict(DET_KW, label_pad_width=None, rand_crop=0, rand_pad=0)
    with mt.cpu():
        b = tio.ImageDetRecordIter(DET, **kw).next()
    np.random.seed(0)
    w = jio.ImageDetRecordIter(DET, **kw).next()
    assert np.array_equal(b.label[0].asnumpy(), w.label[0].asnumpy())
    for mod in (tio, jio):
        it = mod.ImageDetRecordIter(DET, **dict(kw, label_pad_width=1))
        with pytest.raises(ValueError, match="label_pad_width"):
            with mt.cpu():
                it.next()


def test_pack_det_label_and_pack_img():
    boxes = np.random.RandomState(0).uniform(0, 1, (3, 5)).astype(np.float32)
    assert np.array_equal(tio.pack_det_label(boxes),
                          jio.pack_det_label(boxes))
    assert np.array_equal(tio.pack_det_label(boxes, header_width=4),
                          jio.pack_det_label(boxes, header_width=4))
    img = np.random.RandomState(1).randint(0, 256, (20, 30, 3)).astype(
        np.uint8)
    for label in (3.0, tio.pack_det_label(boxes)):
        h = trec.IRHeader(0, label, 7, 0)
        for fmt in (".jpg", ".png"):
            packed = trec.pack_img(h, img, quality=90, img_fmt=fmt)
            assert packed == jrec.pack_img(jrec.IRHeader(0, label, 7, 0),
                                           img, quality=90, img_fmt=fmt)
            header, got = trec.unpack_img(packed)
            assert got._data.device.type == "cpu"
            assert np.array_equal(got.asnumpy(),
                                  jrec.unpack_img(packed)[1].asnumpy())
            assert np.array_equal(np.asarray(header.label, np.float32),
                                  np.asarray(label, np.float32).ravel()
                                  if np.ndim(label) else np.float32(label))
    packed = trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img, img_fmt=".png")
    assert np.array_equal(trec.unpack_img(packed)[1].asnumpy(), img)


def _det_augs(mod, rng):
    crop = mod.DetRandomCropAug(0.1, (0.75, 1.33), (0.1, 1.0), 0.3, 50,
                                rng=rng)
    pad = mod.DetRandomPadAug((0.75, 1.33), (1.0, 3.0), 50, rng=rng)
    return {"flip": mod.DetHorizontalFlipAug(0.5, rng=rng), "crop": crop,
            "pad": pad,
            "select": mod.DetRandomSelectAug([crop, pad], 0.2, rng=rng),
            "borrow": mod.DetBorrowAug(ji.CastAug() if mod is ji
                                       else ti.CastAug())}


@pytest.mark.parametrize("name", ["flip", "crop", "pad", "select", "borrow"])
def test_det_augmenter(name):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [4, 0.4, 0.3, 0.9, 0.95],
                      [2, 0.0, 0.0, 0.2, 0.3]], np.float32)
    for seed in range(4):
        g, gl = _det_augs(ti, np.random.RandomState(seed))[name](img, label)
        w, wl = _det_augs(ji, np.random.RandomState(seed))[name](img, label)
        gn = g.asnumpy() if hasattr(g, "asnumpy") else np.asarray(g)
        wn = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
        assert np.array_equal(gn, wn) and gn.dtype == wn.dtype
        assert np.array_equal(np.asarray(gl), np.asarray(wl))


def test_create_det_augmenter():
    img = np.random.RandomState(6).randint(0, 256, (30, 40, 3)).astype(
        np.uint8)
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [4, 0.4, 0.3, 0.9, 0.95]],
                     np.float32)
    # no contrast jitter here: it blends with the image's mean, so the
    # resize's parted pixels would move every pixel a little (it is held
    # alone, on exact inputs, in test_torch_port_image.py)
    kw = dict(rand_crop=0.8, rand_pad=0.8, rand_mirror=True, brightness=0.2,
              saturation=0.2, hue=0.1, pca_noise=0.05, rand_gray=0.2,
              mean=True, std=True)
    for seed in range(4):
        gi, gl, wi, wl = img, label, img, label
        for a, b in zip(ti.CreateDetAugmenter((3, 24, 24), rng=np.random
                                              .RandomState(seed), **kw),
                        ji.CreateDetAugmenter((3, 24, 24), rng=np.random
                                              .RandomState(seed), **kw)):
            gi, gl = a(gi, gl)
            wi, wl = b(wi, wl)
        assert np.array_equal(np.asarray(gl), np.asarray(wl))
        assert_resized_close(gi.asnumpy(), wi.asnumpy(), level=2 / 57.0,
                             per_pixel=True, share=RESIZE_PARTED_SHARE_FLAT)
