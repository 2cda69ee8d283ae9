"""``gluon.data.vision`` against ``mxnet_tpu.gluon.data.vision`` on the same
seeded inputs: ``MNIST``, ``FashionMNIST``, ``CIFAR10`` and ``CIFAR100``
from idx-gz and binary files this test writes and from their synthetic
data (bit for bit), ``ImageRecordDataset`` (and its pickle, which a process
worker loads), ``ImageFolderDataset``, ``ImageListDataset``, and every
transform under one numpy seed (uint8 exact where no resize runs, a resize
within the stated share, floats fp32 1e-4)."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

from mxnet_tpu.gluon.data import vision as jv
from mxnet_tpu_torch.gluon.data import vision as tv
from torch_port_helpers import (RESIZE_PARTED_SHARE_SMALL,
                                assert_resized_close)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same_items(a, b, n=None):
    assert len(a) == len(b)
    for i in range(n or len(a)):
        (x, y), (u, v) = a[i], b[i]
        assert np.array_equal(_np(x), _np(u)) and _np(x).dtype == _np(u).dtype
        assert np.array_equal(np.asarray(y), np.asarray(v))


def _write_mnist(root, train, n=12):
    rng = np.random.RandomState(3 + train)
    img = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lab = rng.randint(0, 10, n).astype(np.uint8)
    names = (("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
             if train else ("t10k-images-idx3-ubyte.gz",
                            "t10k-labels-idx1-ubyte.gz"))
    with gzip.open(os.path.join(root, names[0]), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(root, names[1]), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_files_and_synthetic(cls, train, tmp_path):
    _write_mnist(str(tmp_path), train)
    _same_items(getattr(tv, cls)(str(tmp_path), train=train),
                getattr(jv, cls)(str(tmp_path), train=train))
    empty = str(tmp_path / "none")
    _same_items(getattr(tv, cls)(empty, train=train, synthetic_size=64),
                getattr(jv, cls)(empty, train=train, synthetic_size=64))


@pytest.mark.parametrize("cls", ["CIFAR10", "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_files_and_synthetic(cls, train, tmp_path):
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    files = (["data_batch_%d.bin" % i for i in range(1, 6)] if train
             else ["test_batch.bin"])
    rng = np.random.RandomState(7)
    for name in files:
        rows = rng.randint(0, 256, (3, 3073)).astype(np.uint8)
        rows[:, 0] %= 10
        (d / name).write_bytes(rows.tobytes())
    _same_items(getattr(tv, cls)(str(tmp_path), train=train),
                getattr(jv, cls)(str(tmp_path), train=train))
    empty = str(tmp_path / "none")
    _same_items(getattr(tv, cls)(empty, train=train, synthetic_size=32),
                getattr(jv, cls)(empty, train=train, synthetic_size=32))


def test_image_record_dataset_and_its_pickle():
    rec = os.path.join(FIX, "torch_images.rec")
    got, want = tv.ImageRecordDataset(rec), jv.ImageRecordDataset(rec)
    _same_items(got, want, n=4)
    assert got[0][0]._data.device.type == "cpu"
    again = pickle.loads(pickle.dumps(got))
    _same_items(again, want, n=2)
    tf = tv.ImageRecordDataset(rec, transform=lambda x, y: (x, y + 1))
    assert tf[1][1] == want[1][1] + 1


def test_folder_and_list_datasets(tmp_path):
    rng = np.random.RandomState(2)
    lines = []
    for c, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(2):
            a = rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)
            Image.fromarray(a).save(str(tmp_path / cls / ("%d.png" % i)))
            lines.append("%d\t%d\t%s/%d.png" % (len(lines), c, cls, i))
        np.save(str(tmp_path / cls / "x.npy"), rng.randint(
            0, 256, (5, 4, 3)).astype(np.uint8))
    got, want = tv.ImageFolderDataset(str(tmp_path)), \
        jv.ImageFolderDataset(str(tmp_path))
    assert got.synsets == want.synsets and got.items == want.items
    _same_items(got, want)
    lst = str(tmp_path / "a.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    _same_items(tv.ImageListDataset(str(tmp_path), lst),
                jv.ImageListDataset(str(tmp_path), lst))
    entries = [[1, "cat/0.png"], [0, "dog/1.png"]]
    _same_items(tv.ImageListDataset(str(tmp_path), entries),
                jv.ImageListDataset(str(tmp_path), entries))


def _transforms(T):
    return {
        "Cast": T.Cast("float32"),
        "ToTensor": T.ToTensor(),
        "Normalize": T.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
        "Resize": T.Resize(24),
        "Resize_wh": T.Resize((30, 20)),
        "CenterCrop": T.CenterCrop(20),
        "CropResize": T.CropResize(3, 4, 20, 16, size=12),
        "CropResize_nosize": T.CropResize(3, 4, 20, 16),
        "RandomCrop": T.RandomCrop(20, pad=4),
        "RandomCrop_up": T.RandomCrop(60),
        "RandomResizedCrop": T.RandomResizedCrop(24),
        "RandomFlipLeftRight": T.RandomFlipLeftRight(),
        "RandomFlipTopBottom": T.RandomFlipTopBottom(),
        "RandomBrightness": T.RandomBrightness(0.3),
        "RandomContrast": T.RandomContrast(0.3),
        "RandomSaturation": T.RandomSaturation(0.3),
        "RandomHue": T.RandomHue(0.2),
        "RandomColorJitter": T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
        "RandomLighting": T.RandomLighting(0.1),
        "RandomGray": T.RandomGray(0.5),
        "Compose": T.Compose([T.RandomResizedCrop(16),
                              T.RandomFlipLeftRight(), T.ToTensor(),
                              T.Normalize((0.5, 0.5, 0.5), (0.2, 0.2, 0.2))]),
    }


RESIZING = ("Resize", "Resize_wh", "CropResize", "RandomCrop_up",
            "RandomResizedCrop", "Compose")


@pytest.mark.parametrize("name", sorted(_transforms(tv.transforms)))
def test_transform(name):
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    if name == "Normalize":
        img = img.transpose(2, 0, 1).astype(np.float32) / 255
    for seed in range(3):
        np.random.seed(seed)
        got = _transforms(tv.transforms)[name](img)
        np.random.seed(seed)
        want = _transforms(jv.transforms)[name](img)
        assert got._data.device.type == "cpu"
        g, w = got.asnumpy(), _np(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        if name in RESIZING:
            level = 1.0 / 255 / 0.2 if name == "Compose" else 1.0
            assert_resized_close(g, w, level=level,
                                 share=RESIZE_PARTED_SHARE_SMALL)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_host_rule():
    """Under a card's context (none is present here: a copy to it would
    raise), every transform and the record dataset still return NDArrays
    on the CPU; the DataLoader makes the one device copy a batch."""
    import mxnet_tpu_torch as mt

    img = np.random.RandomState(4).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    with mt.gpu(0):
        for name, t in _transforms(tv.transforms).items():
            x = img.transpose(2, 0, 1).astype(np.float32) / 255 \
                if name == "Normalize" else img
            assert t(x)._data.device.type == "cpu", name
        ds = tv.ImageRecordDataset(os.path.join(FIX, "torch_images.rec"))
        assert ds[0][0]._data.device.type == "cpu"
