"""RecordIO (counterpart of ``mxnet_tpu/recordio.py``; ref:
src/recordio.cc, python/mxnet/recordio.py).

The same on-disk framing: little-endian kMagic 0xced7230a, a u32 length,
the payload, zero padding to 4 bytes; ``.idx`` files map a key to a byte
offset, one ``key\\toffset`` line a record. A file either package writes
reads back byte for byte in the other. ``read_all_native`` scans a file
with the C++ reader of the committed ``src/engine_cc/libmxtpu.so``
(``recordio.cc``), loaded read-only through ``engine.py``.

``pack_img`` encodes through PIL (JPEG, or PNG for another ``img_fmt``)
and ``unpack_img`` decodes through ``image.imdecode``, as in the JAX
package.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img", "load_offsets",
           "read_all_native", "RecordSource"]

_MAGIC = 0xCED7230A


def _pad(n):
    return (4 - n % 4) % 4


class MXRecordIO:
    """Sequential record file (ref: recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        # one lock for the object's life: reset() must not swap it under a
        # thread waiting in read_at
        self._lock = threading.Lock()
        self.open()

    def open(self):
        if self.flag == "w":
            self._f = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._f = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("flag must be 'r' or 'w'")
        self._closed = False

    def close(self):
        if not self._closed:
            self._f.close()
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self._f.tell()

    def write(self, buf):
        assert self.writable
        self._f.write(struct.pack("<II", _MAGIC, len(buf)))
        self._f.write(buf)
        self._f.write(b"\x00" * _pad(len(buf)))

    def read(self):
        assert not self.writable
        header = self._f.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        assert magic == _MAGIC, "corrupt record file %s" % self.uri
        buf = self._f.read(length)
        self._f.read(_pad(length))
        return buf

    def read_at(self, offset):
        """Seek and read one record under the lock: the DataLoader's
        threads share the handle."""
        with self._lock:
            self._f.seek(offset)
            return self.read()

    def scan_offsets(self):
        """Every record's byte offset, reading only the 8-byte headers (the
        index of a file without ``.idx``)."""
        assert not self.writable
        offsets = []
        with self._lock:
            saved = self._f.tell()
            self._f.seek(0)
            while True:
                pos = self._f.tell()
                header = self._f.read(8)
                if len(header) < 8:
                    break
                magic, length = struct.unpack("<II", header)
                assert magic == _MAGIC, "corrupt record file %s" % self.uri
                offsets.append(pos)
                self._f.seek(length + _pad(length), 1)
            self._f.seek(saved)
        return offsets


class MXIndexedRecordIO(MXRecordIO):
    """(ref: recordio.py:MXIndexedRecordIO) ``.idx`` maps a key to a byte
    offset."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            self.keys, self.idx = _parse_idx(idx_path, key_type)

    def close(self):
        if self.writable and not getattr(self, "_closed", True):
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write("%s\t%d\n" % (k, self.idx[k]))
        super().close()

    def seek(self, idx):
        self._f.seek(self.idx[idx])

    def read_idx(self, idx):
        return self.read_at(self.idx[idx])

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


IndexedRecordIO = MXIndexedRecordIO


def _parse_idx(idx_path, key_type=int):
    """``.idx`` text → (keys, {key: offset}); malformed lines skipped."""
    idx, keys = {}, []
    with open(idx_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                key = key_type(parts[0])
                idx[key] = int(parts[1])
                keys.append(key)
    return keys, idx


def load_offsets(rec, idx_path=None):
    """The record offsets of an open read-mode file: its ``.idx`` (given,
    or beside the ``.rec``) when there is one, else a header scan."""
    if idx_path is None:
        idx_path = os.path.splitext(rec.uri)[0] + ".idx"
    if os.path.exists(idx_path):
        keys, idx = _parse_idx(idx_path)
        return [idx[k] for k in keys]
    return rec.scan_offsets()


# (ref: recordio.py:IRHeader/pack/unpack)
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class IRHeader:
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):
        self.flag, self.label, self.id, self.id2 = flag, label, id, id2


def pack(header, s):
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)):
        label = np.asarray(label, dtype=np.float32)
        hdr = struct.pack(_IR_FORMAT, len(label), 0.0, header.id, header.id2)
        return hdr + label.tobytes() + s
    hdr = struct.pack(_IR_FORMAT, 0, float(label), header.id, header.id2)
    return hdr + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """``pack`` of ``img`` (HWC uint8) encoded by PIL."""
    import io as _io

    from PIL import Image

    from .ndarray import NDArray

    if isinstance(img, NDArray):
        img = img.asnumpy()
    buf = _io.BytesIO()
    Image.fromarray(np.asarray(img)).save(
        buf, format="JPEG" if img_fmt in (".jpg", ".jpeg") else "PNG",
        quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=1):
    """(IRHeader, the decoded image as an NDArray on the CPU)."""
    from .image import imdecode

    header, img_bytes = unpack(s)
    return header, imdecode(img_bytes, flag=iscolor)


def _typed_native():
    """``libmxtpu.so`` with its RecordIO entry points typed (raises
    ``OSError`` when the library is missing)."""
    from .engine import _native

    lib = _native()
    if not getattr(lib, "_recordio_typed", False):
        lib.mxtpu_recordio_open.restype = ctypes.c_void_p
        lib.mxtpu_recordio_open.argtypes = [ctypes.c_char_p]
        lib.mxtpu_recordio_next.restype = ctypes.c_ssize_t
        lib.mxtpu_recordio_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
        lib.mxtpu_recordio_close.argtypes = [ctypes.c_void_p]
        lib._recordio_typed = True
    return lib


def read_all_native(uri):
    """Every record of a ``.rec`` file, scanned by the C++ reader; raises
    ``IOError`` on a file it cannot open and ``ValueError`` on a corrupt
    one."""
    lib = _typed_native()
    h = lib.mxtpu_recordio_open(str(uri).encode())
    if not h:
        raise IOError("cannot open %s" % uri)
    out = []
    try:
        while True:
            ptr = ctypes.c_char_p()
            n = lib.mxtpu_recordio_next(h, ctypes.byref(ptr))
            if n == -1:
                break
            if n < 0:
                raise ValueError("corrupt record file %s" % uri)
            out.append(ctypes.string_at(ptr, n))
    finally:
        lib.mxtpu_recordio_close(h)
    return out


class RecordSource:
    """An open ``.rec`` with its offsets: ``len(src)`` records,
    ``src.read(i)`` → (IRHeader, payload bytes)."""

    def __init__(self, path_imgrec, path_imgidx=None):
        self.rec = MXRecordIO(path_imgrec, "r")
        self.offsets = load_offsets(self.rec, path_imgidx)

    def __len__(self):
        return len(self.offsets)

    def read(self, i):
        return unpack(self.rec.read_at(self.offsets[i]))
