"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``; ref:
python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        """Every ``num_shards``-th sample from ``index`` (ref:
        dataset.py:shard; the trailing shards may be one shorter)."""
        if not 0 <= index < num_shards:
            raise ValueError("shard index %d out of range [0, %d)"
                             % (index, num_shards))
        return _ShardedDataset(self, num_shards, index)

    def sample(self, sampler):
        """The samples in a Sampler's order (ref: dataset.py:sample)."""
        return _SampledDataset(self, list(sampler))


class _ShardedDataset(Dataset):
    def __init__(self, data, num_shards, index):
        self._data = data
        self._num = num_shards
        self._index = index

    def __len__(self):
        n = len(self._data)
        return (n - self._index + self._num - 1) // self._num

    def __getitem__(self, idx):
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError("shard index %d out of range [0, %d)" % (idx, n))
        return self._data[self._index + idx * self._num]


class _SampledDataset(Dataset):
    def __init__(self, data, indices):
        self._data = data
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """(ref: dataset.py:ArrayDataset) Sample i is the tuple of every
    array's element i (the element itself for one array)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, \
                "all arrays must have the same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """(ref: dataset.py:RecordFileDataset) The records of an indexed
    RecordIO file, as bytes."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO

        idx_file = filename[:filename.rfind(".")] + ".idx"
        self._record = IndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
