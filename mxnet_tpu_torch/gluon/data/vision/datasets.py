"""Vision datasets (counterpart of ``mxnet_tpu/gluon/data/vision/
datasets.py``; ref: python/mxnet/gluon/data/vision/datasets.py).

Nothing is downloaded: ``MNIST``, ``FashionMNIST``, ``CIFAR10`` and
``CIFAR100`` read local files in the standard formats when present, else
make the JAX package's synthetic data bit for bit (``RandomState(0..3)``).
``ImageRecordDataset`` reads a ``.rec`` by byte offset and pickles by its
file name (a worker process opens the file again), so it can feed process
workers; images decode on the host into NDArrays on ``mx.cpu()``.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset",
           "ImageListDataset", "ImageRecordDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """(ref: datasets.py:MNIST); idx-gz files if present, else synthetic."""

    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None,
                 synthetic_size=1024):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _file_names(self):
        if self._train:
            return "train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"
        return "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"

    def _get_data(self):
        img_f, lbl_f = self._file_names()
        img_p = os.path.join(self._root, img_f)
        lbl_p = os.path.join(self._root, lbl_f)
        if os.path.exists(img_p) and os.path.exists(lbl_p):
            with gzip.open(lbl_p, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(img_p, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols, 1)
            self._data, self._label = data, label
        else:
            rng = np.random.RandomState(0 if self._train else 1)
            n = self._synthetic_size
            self._data = rng.randint(0, 256, (n,) + self._shape, dtype=np.uint8)
            self._label = rng.randint(0, self._classes, n).astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None, synthetic_size=1024):
        super().__init__(root, train, transform, synthetic_size)


class CIFAR10(_DownloadedDataset):
    """(ref: datasets.py:CIFAR10); binary batches if present, else synthetic."""

    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None,
                 synthetic_size=1024):
        self._synthetic_size = synthetic_size
        super().__init__(root, train, transform)

    def _get_data(self):
        files = (["data_batch_%d.bin" % i for i in range(1, 6)]
                 if self._train else ["test_batch.bin"])
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = [], []
            for p in paths:
                raw = np.frombuffer(open(p, "rb").read(), dtype=np.uint8).reshape(-1, 3073)
                label.append(raw[:, 0].astype(np.int32))
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            self._data = np.concatenate(data)
            self._label = np.concatenate(label)
        else:
            rng = np.random.RandomState(2 if self._train else 3)
            n = self._synthetic_size
            self._data = rng.randint(0, 256, (n,) + self._shape, dtype=np.uint8)
            self._label = rng.randint(0, self._classes, n).astype(np.int32)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None, synthetic_size=1024):
        super().__init__(root, train, transform, synthetic_size)


class ImageRecordDataset(Dataset):
    """Images packed in RecordIO, read by byte offset (the ``.idx`` file
    when present, else one scan of the framing); sample i is (image
    NDArray on the CPU, its header's label), through ``transform(img,
    label)`` when given."""

    def __init__(self, filename, flag=1, transform=None):
        self._filename = filename
        self._flag = flag
        self._transform = transform
        self._open()

    def _open(self):
        from ....recordio import MXRecordIO, load_offsets

        self._rec = MXRecordIO(self._filename, "r")
        self._offsets = load_offsets(self._rec)

    def __getstate__(self):
        return {"_filename": self._filename, "_flag": self._flag,
                "_transform": self._transform}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open()

    def __len__(self):
        return len(self._offsets)

    def __getitem__(self, idx):
        from ....recordio import unpack_img

        header, img = unpack_img(self._rec.read_at(self._offsets[idx]),
                                 iscolor=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """(ref: datasets.py:ImageFolderDataset) — folder-per-class layout."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if filename.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import _host, imread_np

        path, label = self.items[idx]
        img = _host(np.load(path) if path.endswith(".npy")
                    else imread_np(path))
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageListDataset(Dataset):
    """(ref: datasets.py:ImageListDataset) images named by a .lst file
    (tab-separated: index, label..., relpath — the im2rec format) or an
    in-memory list of [label(s)..., relpath] entries."""

    def __init__(self, root=".", imglist=None, flag=1):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self.items = []
        if isinstance(imglist, str):
            with open(imglist) as f:
                lines = [ln.split("\t") for ln in f.read().splitlines()
                         if ln.strip()]
            entries = [ln[1:] for ln in lines]  # drop the leading index
        else:
            entries = [[str(v) for v in row] for row in (imglist or [])]
        for row in entries:
            *labels, path = row
            lab = np.array([float(v) for v in labels], np.float32)
            self.items.append((os.path.join(self._root, path),
                               lab[0] if lab.size == 1 else lab))

    def __getitem__(self, idx):
        from ....image import _host, imread_np

        path, label = self.items[idx]
        return _host(imread_np(path, self._flag)), label

    def __len__(self):
        return len(self.items)
