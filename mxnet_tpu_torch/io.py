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

The image iterators over ``.rec`` files: ``ImageRecordIter`` (and its
uint8 twin ``ImageRecordUInt8Iter``) takes the native route where it can,
the committed ``src/engine_cc/libmxtpu_im.so`` (threads that read, decode
with libjpeg, resize, crop and mirror into CHW uint8 batches), loaded
read-only and bit for bit the JAX package's native route; else the Python
route, ``image.imdecode`` and the augmenters of ``image.py`` per image
(the decodes on ``preprocess_threads`` threads, the augmenters in record
order, so the random draws come in the JAX package's order).
``ImageDetRecordIter`` always takes the Python route. The JAX package
falls back to the Python route silently; here every batch is counted by
its route (``counters["image_native"]``, ``["image_python"]``) and each
iterator that could not take the native route records why
(``iterator.route_reason``, and ``route_reasons`` by reason).
``LibSVMIter`` yields CSR batches and waits for ``sparse.py`` (A.17).
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading

import numpy as np

from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "PrefetchingIter", "ResizeIter", "ImageRecordIter",
           "ImageRecordUInt8Iter", "ImageDetRecordIter", "pack_det_label",
           "counters", "route_reasons", "image_lib_path"]

# the explicit routes, counted: CSV files the native reader declined, and
# image batches by the route that made them
counters = {"csv_native": 0, "csv_loadtxt": 0, "image_native": 0,
            "image_python": 0}
# why image record iterators took the Python route: reason -> iterators
route_reasons = {}


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


# ---------------------------------------------------------------------------
# Image record iterators (ref: src/io/iter_image_recordio_2.cc,
# iter_image_det_recordio.cc)
# ---------------------------------------------------------------------------

def image_lib_path():
    """Where the prebuilt ``libmxtpu_im.so`` lies in the checkout."""
    return os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "src", "engine_cc",
        "libmxtpu_im.so"))


_im_lib = None     # the typed library, once loaded
_im_error = None   # or why it does not load: fixed once a process
_im_lock = threading.Lock()


def image_native_error():
    """None where the native image pipeline loads, else why not."""
    _image_lib()
    return _im_error


def _image_lib():
    global _im_lib, _im_error
    with _im_lock:
        if _im_lib is None and _im_error is None:
            so = image_lib_path()
            try:
                if not os.path.exists(so):
                    raise OSError("%s is missing (it is prebuilt and "
                                  "committed; the port does not build it)"
                                  % so)
                lib = ctypes.CDLL(so)
                lib.mxtpu_impipe_create.restype = ctypes.c_void_p
                lib.mxtpu_impipe_create.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                    ctypes.c_int]
                lib.mxtpu_impipe_next.restype = ctypes.c_int
                lib.mxtpu_impipe_next.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                lib.mxtpu_impipe_reset.argtypes = [ctypes.c_void_p]
                lib.mxtpu_impipe_destroy.argtypes = [ctypes.c_void_p]
                lib.mxtpu_impipe_errors.restype = ctypes.c_long
                lib.mxtpu_impipe_errors.argtypes = [ctypes.c_void_p]
                _im_lib = lib
            except (OSError, AttributeError) as e:
                _im_error = "libmxtpu_im.so does not load: %s" % e
        return _im_lib


class _NativeImagePipe:
    """The C++ decode pipeline of ``src/engine_cc/image_pipeline.cc``:
    threads that pread, decode with libjpeg, resize the shorter edge,
    center crop and mirror into ordered CHW uint8 batches."""

    def __init__(self, lib, handle, batch, shape, label_width):
        self._lib, self._h = lib, handle
        self._batch, self._shape, self._lw = batch, shape, label_width

    @staticmethod
    def try_create(path, threads, batch, data_shape, label_width, shuffle,
                   mirror, resize, seed=0, depth=4):
        """(pipe, None), or (None, why the native route is not taken)."""
        lib = _image_lib()
        if lib is None:
            return None, _im_error
        c, h, w = data_shape
        if c != 3:
            return None, "the native pipeline decodes RGB only (data_shape " \
                         "has %d channels)" % c
        handle = lib.mxtpu_impipe_create(
            str(path).encode(), int(threads), int(batch), int(h), int(w),
            int(label_width), int(bool(shuffle)), int(bool(mirror)),
            int(resize), int(seed), int(depth))
        if not handle:
            return None, "mxtpu_impipe_create refused %s" % path
        return _NativeImagePipe(lib, handle, batch, (c, h, w),
                                label_width), None

    def next(self):
        c, h, w = self._shape
        data = np.empty((self._batch, c, h, w), np.uint8)
        labels = np.empty((self._batch, self._lw), np.float32)
        n = self._lib.mxtpu_impipe_next(
            self._h, data.ctypes.data_as(ctypes.c_void_p),
            labels.ctypes.data_as(ctypes.c_void_p))
        errs = self._lib.mxtpu_impipe_errors(self._h)
        if errs:
            raise RuntimeError(
                "native image pipeline: %d record(s) failed to read/decode "
                "(corrupt or non-JPEG payloads); use force_python=True to "
                "locate them through the Python route's exception" % errs)
        if n <= 0:
            return None
        return data, labels

    def reset(self):
        self._lib.mxtpu_impipe_reset(self._h)

    def __del__(self):
        try:
            self._lib.mxtpu_impipe_destroy(self._h)
        except Exception:
            pass


class _RecordIterBase(DataIter):
    """Shared ``.rec`` machinery: reads by byte offset, the shuffle order
    (numpy's global state, as the JAX package draws it), the cursor, and
    the Python route: decodes on ``threads`` threads, then each record's
    ``_augment_one(img, label)`` in order, one device copy a batch.
    Subclasses give ``_augment_one`` and ``_collate_labels``."""

    def __init__(self, path_imgrec, batch_size, shuffle, path_imgidx,
                 threads=1):
        super().__init__(batch_size)
        from .recordio import RecordSource

        self._src = RecordSource(path_imgrec, path_imgidx)
        self._shuffle = shuffle
        self._threads = max(1, int(threads))
        self._pool = None
        self._order = np.arange(len(self._src))
        self.reset()

    def reset(self):
        if self._shuffle:
            np.random.shuffle(self._order)
        self._cursor = 0

    def iter_next(self):
        return self._cursor + self.batch_size <= len(self._src)

    def _decoded(self, idx):
        """(header, HWC uint8) of each record in ``idx``, in order."""
        from .image import imdecode_np

        def one(i):
            header, img_bytes = self._src.read(i)
            return header, imdecode_np(img_bytes)

        if self._threads == 1 or len(idx) == 1:
            return [one(i) for i in idx]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self._threads)
        return list(self._pool.map(one, idx))

    def host_batch(self):
        """The next batch as host numpy (data, labels) by the Python
        route, or StopIteration."""
        from .image import _asnp

        if not self.iter_next():
            raise StopIteration
        datas, labels = [], []
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        for header, img in self._decoded(idx):
            img, label = self._augment_one(img, header.label)
            datas.append(_asnp(img).transpose(2, 0, 1))
            labels.append(label)
        self._cursor += self.batch_size
        counters["image_python"] += 1
        return np.stack(datas), self._collate_labels(labels)

    def next(self):
        data, labels = self.host_batch()
        return DataBatch([array(data)], [array(labels)])

    def __del__(self):
        pool = self.__dict__.get("_pool")
        if pool is not None:
            pool.shutdown(wait=False)


class ImageRecordIter(_RecordIterBase):
    """Image record iterator over ``.rec`` files (ref:
    src/io/iter_image_recordio_2.cc). The native route where the library
    loads and the augmentation is the standard resize, center crop,
    mirror and normalize; the Python route for ``rand_crop``,
    ``force_python=True``, a non-RGB shape or a library that does not
    load, with ``route_reason`` saying which."""

    _raw_uint8 = False

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=0, path_imgidx=None, preprocess_threads=4,
                 **kwargs):
        from .image import CreateAugmenter

        self._augs = CreateAugmenter(data_shape, resize=resize,
                                     rand_crop=rand_crop,
                                     rand_mirror=rand_mirror,
                                     mean=(mean_r, mean_g, mean_b),
                                     std=(std_r, std_g, std_b))
        self._label_width = label_width
        self._mean = np.asarray([mean_r, mean_g, mean_b],
                                np.float32).reshape(1, 3, 1, 1)
        self._std = np.asarray([std_r, std_g, std_b],
                               np.float32).reshape(1, 3, 1, 1)
        self._pipe = None
        # the pipe starts after the base reset(), which would otherwise
        # restart it at once and drop its first batches
        super().__init__(path_imgrec, batch_size, shuffle, path_imgidx,
                         threads=preprocess_threads)
        if rand_crop:
            reason = "rand_crop takes the Python route"
        elif kwargs.get("force_python", False):
            reason = "force_python=True"
        else:
            # drawn whether or not the library loads, as the JAX package
            # draws it before it tries
            seed = int(np.random.randint(1, 2 ** 31)) if shuffle else 1
            self._pipe, reason = _NativeImagePipe.try_create(
                path_imgrec, preprocess_threads, batch_size, data_shape,
                label_width, shuffle, rand_mirror, resize, seed=seed)
        self.route = "native" if self._pipe is not None else "python"
        self.route_reason = reason
        if reason is not None:
            route_reasons[reason] = route_reasons.get(reason, 0) + 1

    def host_batch(self):
        if self._pipe is None:
            data, labels = super().host_batch()
            if self._raw_uint8:
                data = data.astype(np.uint8)
            return data, labels
        if not self.iter_next():
            raise StopIteration
        got = self._pipe.next()
        if got is None:
            raise StopIteration
        self._cursor += self.batch_size
        counters["image_native"] += 1
        data, labels = got
        if not self._raw_uint8:
            data = (data.astype(np.float32) - self._mean) / self._std
        if self._label_width == 1:
            labels = labels.ravel()
        return data, labels

    def reset(self):
        super().reset()
        if getattr(self, "_pipe", None) is not None:
            self._pipe.reset()

    def _augment_one(self, img, label):
        for aug in self._augs:
            img = aug(img)
        if self._label_width > 1:
            vec = np.zeros((self._label_width,), np.float32)
            flat = np.asarray(label, np.float32).ravel()
            vec[:min(len(flat), self._label_width)] = \
                flat[:self._label_width]
            return img, vec
        scalar = (np.asarray(label, np.float32).ravel()[0]
                  if np.ndim(label) else float(label))
        return img, scalar

    def _collate_labels(self, labels):
        return np.asarray(labels, np.float32)


class ImageRecordUInt8Iter(ImageRecordIter):
    """The uint8 twin of ImageRecordIter (ref: iter_image_recordio_2.cc
    ImageRecordUInt8Iter): pixels as decoded, not normalized; it refuses
    ``mean_*`` and ``std_*``."""

    _raw_uint8 = True

    def __init__(self, path_imgrec, data_shape, batch_size, **kwargs):
        bad = [k for k in kwargs if k.startswith(("mean_", "std_"))]
        if bad:
            raise TypeError("ImageRecordUInt8Iter takes no normalization "
                            "parameters (got %s); it yields raw uint8"
                            % bad)
        super().__init__(path_imgrec, data_shape, batch_size, **kwargs)


class ImageDetRecordIter(_RecordIterBase):
    """Detection record iterator (ref: src/io/iter_image_det_recordio.cc),
    always the Python route. A record's label is the flat upstream layout
    ``[header_width, obj_width, <header pad...>, cls, x1, y1, x2, y2, ...]``
    (``pack_det_label``); batches carry (B, K, 5) labels padded with class
    -1 rows, K fixed at ``label_pad_width`` (a record with more objects
    raises) or else each batch's own largest count (at least 1)."""

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=0, rand_pad=0, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=0, label_pad_width=None, rng=None,
                 preprocess_threads=4, **kwargs):
        from .image import CreateDetAugmenter

        self._augs = CreateDetAugmenter(
            data_shape, resize=resize, rand_crop=rand_crop, rand_pad=rand_pad,
            rand_mirror=rand_mirror, mean=(mean_r, mean_g, mean_b),
            std=(std_r, std_g, std_b), rng=rng)
        self._label_pad_width = label_pad_width
        self.route, self.route_reason = "python", None
        super().__init__(path_imgrec, batch_size, shuffle, path_imgidx,
                         threads=preprocess_threads)

    @staticmethod
    def _parse_label(flat):
        flat = np.asarray(flat, np.float32).ravel()
        hw = int(flat[0])
        ow = int(flat[1])
        body = flat[hw:]
        n = len(body) // ow
        return body[:n * ow].reshape(n, ow)[:, :5]

    def _augment_one(self, img, label):
        label = self._parse_label(label)
        for aug in self._augs:
            img, label = aug(img, label)
        return img, np.asarray(label, np.float32)

    def _collate_labels(self, labels):
        width = self._label_pad_width or max(1, max(len(l) for l in labels))
        out = np.full((len(labels), width, 5), -1.0, np.float32)
        for j, l in enumerate(labels):
            if len(l) > width:
                raise ValueError("record has %d objects > label_pad_width=%d"
                                 % (len(l), width))
            out[j, :len(l)] = l
        return out


def pack_det_label(boxes, header_width=2):
    """Boxes (N, 5) [cls, x1, y1, x2, y2] as the flat detection label of the
    upstream layout (ref: tools/im2rec's detection packing)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
    head = np.zeros(header_width, np.float32)
    head[0] = header_width
    head[1] = 5
    return np.concatenate([head, boxes.ravel()])
