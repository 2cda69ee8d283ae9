"""Data iterators (counterpart of ``mxnet_tpu/io.py``'s core; ref:
python/mxnet/io/io.py, src/io/iter_csv.cc, src/io/iter_mnist.cc).

``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter`` (``pad``,
``keep``, ``discard``, ``roll_over``, ``shuffle``), ``CSVIter`` (the native
threaded reader of the committed ``src/engine_cc/libmxtpu.so``, loaded
read-only; ``np.loadtxt`` when it declines a ragged file, an explicit and
counted route), ``MNISTIter`` (idx-ubyte files), ``PrefetchingIter`` and
``ResizeIter``. Batches are NDArrays on the current context (the current
CUDA device unless the caller enters ``with mx.cpu():``); the
``PrefetchingIter`` thread makes its batches under the context that was
current where the iterator was made. Host-side shuffles draw from numpy as
the JAX package does (``NDArrayIter`` from numpy's global state,
``MNISTIter`` from ``RandomState(seed)``), so one seed gives one order in
both packages.

The image iterators (``ImageRecordIter``, ``ImageDetRecordIter``) are
``ROADMAP.md`` A.15's image half; ``LibSVMIter`` yields CSR batches and
waits for ``sparse.py`` (A.17).
"""
from __future__ import annotations

import ctypes
import queue
import threading

import numpy as np

from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "PrefetchingIter", "ResizeIter", "counters"]

# the explicit routes, counted: CSV files the native reader declined
counters = {"csv_native": 0, "csv_loadtxt": 0}


class DataDesc:
    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None, provide_data=None,
                 provide_label=None, bucket_key=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.bucket_key = bucket_key  # BucketingModule routes by it


class DataIter:
    """(ref: io.py:DataIter)"""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        return self.next()

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


class NDArrayIter(DataIter):
    """(ref: io.py:NDArrayIter) ``pad`` wraps the last batch round to the
    epoch's first rows, ``keep`` yields it short, ``discard`` drops it and
    ``roll_over`` yields its rows first in the next epoch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._data = _init_data(data, data_name)
        self._label = _init_data(label, label_name) if label is not None \
            else []
        self._num = self._data[0][1].shape[0]
        self._shuffle = shuffle
        self._last = last_batch_handle
        self._order = np.arange(self._num)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:])
                for n, a in self._data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:])
                for n, a in self._label]

    def reset(self):
        # roll_over: only a tail too small for a batch, left by an epoch
        # that yielded rows, starts the next epoch
        leftover = None
        consumed = getattr(self, "_consumed", 0)
        remainder = len(getattr(self, "_order", ())) - consumed
        if (self._last == "roll_over" and consumed > 0
                and 0 < remainder < self.batch_size):
            leftover = self._order[consumed:]
        order = np.arange(self._num)
        if self._shuffle:
            np.random.shuffle(order)
        self._order = (np.concatenate([leftover, order])
                       if leftover is not None and len(leftover) else order)
        self._cursor = -self.batch_size
        self._consumed = 0

    def iter_next(self):
        self._cursor += self.batch_size
        if self._last in ("discard", "roll_over"):
            return self._cursor + self.batch_size <= len(self._order)
        return self._cursor < len(self._order)

    def _slice(self, pairs):
        out = []
        n = len(self._order)
        end = self._cursor + self.batch_size
        idx = self._order[self._cursor:end]
        if end > n and self._last == "pad":
            idx = np.concatenate([idx, self._order[0:end - n]])
        for _, a in pairs:
            out.append(array(np.asarray(a)[idx]))
        return out

    def getdata(self):
        self._consumed = min(self._cursor + self.batch_size,
                             len(self._order))
        return self._slice(self._data)

    def getlabel(self):
        return self._slice(self._label)

    def getpad(self):
        end = self._cursor + self.batch_size
        return max(0, end - len(self._order)) if self._last == "pad" else 0


def _init_data(data, default_name):
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = {default_name: data}
    if isinstance(data, (list, tuple)):
        data = {("%s_%d" % (default_name, i) if i else default_name): d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


def _read_csv_native(path):
    """The file as float32 through ``mxtpu_csv_*``, or None when the reader
    declines it (a ragged or non-conforming file)."""
    from .engine import _native

    lib = _native()
    if not getattr(lib, "_csv_typed", False):
        lib.mxtpu_csv_open.restype = ctypes.c_void_p
        lib.mxtpu_csv_open.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_long),
                                       ctypes.POINTER(ctypes.c_long)]
        lib.mxtpu_csv_read.restype = ctypes.c_int
        lib.mxtpu_csv_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mxtpu_csv_close.argtypes = [ctypes.c_void_p]
        lib._csv_typed = True
    rows, cols = ctypes.c_long(), ctypes.c_long()
    h = lib.mxtpu_csv_open(str(path).encode(), ctypes.byref(rows),
                           ctypes.byref(cols))
    if not h:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    try:
        ok = lib.mxtpu_csv_read(h, out.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.mxtpu_csv_close(h)
    return out if ok else None


def _load_csv_f32(path):
    """A CSV as float32: the native reader, else ``np.loadtxt`` (counted).
    Either way a single row or column squeezes as ``loadtxt`` does."""
    out = _read_csv_native(path)
    if out is not None:
        counters["csv_native"] += 1
        return out.squeeze() if 1 in out.shape else out
    counters["csv_loadtxt"] += 1
    return np.loadtxt(path, delimiter=",", dtype=np.float32)


class CSVIter(DataIter):
    """(ref: src/io/iter_csv.cc) ``round_batch=False`` yields the short last
    batch as it is (``keep``)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = _load_csv_f32(data_csv)
        data = data.reshape((-1,) + tuple(data_shape))
        label = (_load_csv_f32(label_csv)
                 if label_csv else np.zeros(len(data), np.float32))
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "keep")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _read_idx_ubyte(path):
    """An IDX unsigned-byte file (the MNIST container): big-endian magic
    (dtype, rank), the sizes, the payload; ``.gz`` read through gzip."""
    import gzip
    import struct

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
    if zero != 0 or dtype_code != 0x08:
        raise ValueError("%s is not an unsigned-byte IDX file" % path)
    dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
    return np.frombuffer(raw[4 + 4 * ndim:], np.uint8).reshape(dims)


class MNISTIter(DataIter):
    """(ref: src/io/iter_mnist.cc) Images scaled to [0, 1] float32, (N, 1,
    28, 28) or with ``flat`` (N, 784); ``num_parts``/``part_index`` take a
    strided part; ``shuffle`` permutes with ``RandomState(seed)``."""

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, seed=0, silent=True, num_parts=1, part_index=0,
                 **kwargs):
        super().__init__(batch_size)
        data = _read_idx_ubyte(image).astype(np.float32) / 255.0
        lab = _read_idx_ubyte(label).astype(np.float32)
        if num_parts > 1:
            data = data[part_index::num_parts]
            lab = lab[part_index::num_parts]
        data = data.reshape(len(data), -1) if flat \
            else data.reshape(len(data), 1, data.shape[1], data.shape[2])
        if shuffle:
            order = np.random.RandomState(seed).permutation(len(data))
            data, lab = data[order], lab[order]
        self._inner = NDArrayIter(data, lab, batch_size,
                                  last_batch_handle="pad")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def _context_here():
    """The context current on this thread, or None where none is (no card
    and no ``with ctx:``): a worker thread enters it to make its arrays
    where the caller would have."""
    from .base import DeviceError
    from .context import Context

    try:
        return Context.default_ctx()
    except DeviceError:
        return None


class PrefetchingIter(DataIter):
    """(ref: io.py:PrefetchingIter) The wrapped iterator's batches made on a
    thread, up to four ahead, in order, under the context current where
    the iterator was made; an error on the thread is raised by ``next``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        self._iter = iters if isinstance(iters, DataIter) else iters[0]
        super().__init__(self._iter.batch_size)
        self._ctx = _context_here()
        self._thread = None
        self._start()

    def _start(self):
        self._queue = queue.Queue(maxsize=4)
        self._error = None
        q, ctx = self._queue, self._ctx

        def worker():
            try:
                if ctx is None:
                    for batch in self._iter:
                        q.put(batch)
                else:
                    with ctx:
                        for batch in self._iter:
                            q.put(batch)
            except BaseException as e:  # raised again by next()
                self._error = e
            finally:
                q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        while self._thread.is_alive():  # let the thread end its epoch
            try:
                self._queue.get(timeout=0.01)
            except queue.Empty:
                pass
        self._iter.reset()
        self._start()

    def next(self):
        item = self._queue.get()
        if item is None:
            self._queue.put(None)  # later calls end too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class ResizeIter(DataIter):
    """(ref: io.py:ResizeIter) ``size`` batches an epoch, the wrapped
    iterator reset when it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._cur = 0

    def reset(self):
        self._cur = 0
        if self._reset_internal:
            self._iter.reset()

    def next(self):
        if self._cur >= self._size:
            raise StopIteration
        self._cur += 1
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()
