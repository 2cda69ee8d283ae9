"""Sparse arrays: CSR and row-sparse (counterpart of ``mxnet_tpu/sparse.py``;
ref: src/ndarray/ndarray.cc sparse paths, python/mxnet/ndarray/sparse.py,
src/operator/tensor/dot.cc).

MXNet uses sparse storage for two things: the gradient of a large
embedding table, of which a batch touches few rows (row-sparse), and
sparse feature matrices (CSR). As in the JAX package:

* the storage classes keep MXNet's fields (``data``, ``indices``,
  ``indptr``; NDArrays on one device) with ``cast_storage``, ``retain``
  and ``tostype``;
* ``dot(csr, dense)`` never densifies the left side: each stored value
  gathers its right-hand row (``index_select``) and the products are summed
  into their output rows (``index_add``), which autograd differentiates
  through to the values and the dense side;
* a row-sparse gradient is carried as (row ids, rows) and applied by the
  optimizer's lazy row update (``optimizer.Optimizer._update_rsp``), which
  reads and writes only those rows of the weight and of its row-shaped
  states.

Conversions from dense storage find their rows or nonzeros on the
device and read one count back (:func:`dense_to_row_sparse`); ``retain``
and the row-sparse merges match their row ids on the host (``isin``,
``union1d``), as MXNet's sparse ops run on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import register_op, resolve_dtype
from .ndarray import NDArray, array as _array, invoke

__all__ = ["CSRNDArray", "RowSparseNDArray", "csr_matrix", "row_sparse_array",
           "dot", "cast_storage", "retain", "add", "subtract", "multiply",
           "elemwise_add", "elemwise_sub", "elemwise_mul", "add_n", "zeros",
           "array", "dense_to_row_sparse", "dense_to_row_sparse_padded"]


def _device_of(*xs, ctx=None):
    """The device of the first NDArray or tensor of ``xs``; else ``ctx``'s
    or the current context's."""
    for x in xs:
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    from .base import resolve_device

    return resolve_device(ctx)


def _nd(x, device, dtype=None):
    """``x`` as an NDArray on ``device``: an NDArray as it is, a tensor or
    a numpy array copied there (float64 as float32, as ``nd.array``)."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        t = x.to(device)
        return NDArray(t.to(resolve_dtype(dtype)) if dtype is not None
                       else t)
    return _array(np.asarray(x), ctx=_ctx(device), dtype=dtype)


def _ctx(device):
    from .context import context_from_device

    return context_from_device(device)


def _host(x):
    if isinstance(x, (NDArray, CSRNDArray, RowSparseNDArray)):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CSRNDArray:
    """Compressed sparse row matrix (ref: python/mxnet/ndarray/sparse.py
    CSRNDArray): ``data`` the stored values, ``indices`` their columns
    (int32), ``indptr`` each row's start in them (int32, rows + 1)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        dev = _device_of(data, indices, indptr, ctx=ctx)
        self.data = _nd(data, dev)
        self.indices = _nd(indices, dev, "int32")
        self.indptr = _nd(indptr, dev, "int32")
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def _row_ids(self):
        """The row of each stored value (a search of ``indptr``)."""
        indptr = self.indptr._data.long()
        pos = torch.arange(self.nnz, device=indptr.device)
        return torch.searchsorted(indptr, pos, right=True) - 1

    def asnumpy(self):
        return self.todense().asnumpy()

    def todense(self):
        vals = self.data._data
        dense = torch.zeros(self.shape, dtype=vals.dtype, device=vals.device)
        return NDArray(dense.index_put(
            (self._row_ids(), self.indices._data.long()), vals,
            accumulate=True))

    def astype(self, dtype):
        return CSRNDArray(self.data.astype(dtype), self.indices, self.indptr,
                          self.shape)

    def tostype(self, stype):
        return cast_storage(self, stype)

    def copyto(self, other):
        """Write this matrix into ``other``: a CSR array takes its fields,
        a dense array its dense values (ref: ndarray.py copyto)."""
        if getattr(other, "shape", self.shape) != self.shape:
            raise ValueError("copyto shape mismatch: %s vs %s"
                             % (self.shape, other.shape))
        if isinstance(other, CSRNDArray):
            other.data = NDArray(self.data._data)
            other.indices = NDArray(self.indices._data)
            other.indptr = NDArray(self.indptr._data)
            return other
        if isinstance(other, NDArray):
            other._rebind(self.todense()._data.to(other._data.device))
            return other
        raise TypeError("cannot copyto %r" % (type(other),))

    def __getitem__(self, key):
        """Contiguous row slicing, as the reference supports for CSR."""
        if isinstance(key, int):
            if not -self.shape[0] <= key < self.shape[0]:
                raise IndexError("row %d out of range for %s"
                                 % (key, self.shape))
            if key < 0:
                key += self.shape[0]
            key = slice(key, key + 1)
        start, stop, step = key.indices(self.shape[0])
        if step != 1:
            raise ValueError("CSR slicing requires step 1")
        if stop < start:
            raise ValueError("CSR slice %r is reversed/empty for %d rows"
                             % (key, self.shape[0]))
        indptr = self.indptr.asnumpy().astype(np.int64)
        lo, hi = int(indptr[start]), int(indptr[stop])
        return CSRNDArray(NDArray(self.data._data[lo:hi]),
                          NDArray(self.indices._data[lo:hi]),
                          (indptr[start:stop + 1] - lo).astype(np.int32),
                          (stop - start, self.shape[1]))

    def __repr__(self):
        return "<CSRNDArray %s @%d nnz>" % (self.shape, self.nnz)


class RowSparseNDArray:
    """Row-sparse tensor: the rows ``indices`` (int32) of a ``shape``
    tensor stored densely in ``data``, every other row 0 (ref:
    python/mxnet/ndarray/sparse.py RowSparseNDArray). A row id equal to
    ``shape[0]`` is padding (:func:`dense_to_row_sparse_padded`): it
    stands for no row."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        dev = _device_of(data, indices, ctx=ctx)
        self.data = _nd(data, dev)
        self.indices = _nd(indices, dev, "int32")
        self.shape = tuple(int(s) for s in shape)
        # set where the rows are known to hold no padding id, so that
        # reading them needs no check on the host
        self._unpadded = False

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    @property
    def nnz_rows(self):
        return int(self.indices.shape[0])

    def _rows(self):
        """(row ids as int64, their values) without the padding rows."""
        idx, vals = self.indices._data.long(), self.data._data
        if self._unpadded:
            return idx, vals
        keep = idx < self.shape[0]
        if not bool(keep.all()):
            idx, vals = idx[keep], vals[keep]
        return idx, vals

    def asnumpy(self):
        return self.todense().asnumpy()

    def todense(self):
        idx, vals = self._rows()
        dense = torch.zeros(self.shape, dtype=vals.dtype, device=vals.device)
        return NDArray(dense.index_add(0, idx, vals))

    def astype(self, dtype):
        return RowSparseNDArray(self.data.astype(dtype), self.indices,
                                self.shape)

    def tostype(self, stype):
        return cast_storage(self, stype)

    def retain(self, indices):
        return retain(self, indices)

    def __repr__(self):
        return "<RowSparseNDArray %s @%d rows>" % (self.shape, self.nnz_rows)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSR matrix from ``(data, indices, indptr)`` and ``shape``, or from
    a dense 2-D array (its nonzeros, row by row, found on the device)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indices, indptr, shape, ctx=ctx)
    x = _nd(arg1, _device_of(arg1, ctx=ctx), dtype)
    a = (x if dtype is None else x.astype(dtype))._data.detach()
    rows, cols = torch.nonzero(a, as_tuple=True)
    indptr = torch.zeros(a.shape[0] + 1, dtype=torch.int32, device=a.device)
    indptr[1:] = torch.bincount(rows, minlength=a.shape[0]).cumsum(0)
    return CSRNDArray(NDArray(a[rows, cols]), NDArray(cols.to(torch.int32)),
                      NDArray(indptr), a.shape)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A row-sparse array from ``(data, indices)`` and ``shape``, or from a
    dense array (its rows with a nonzero, :func:`dense_to_row_sparse`)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, ctx=ctx)
    x = _nd(arg1, _device_of(arg1, ctx=ctx), dtype)
    return dense_to_row_sparse(x if dtype is None else x.astype(dtype))


def array(source_array, ctx=None, dtype=None):
    """``sparse.array``: a sparse array keeps its storage type, anything
    else becomes CSR (ref: python/mxnet/ndarray/sparse.py array)."""
    if isinstance(source_array, CSRNDArray):
        return CSRNDArray(source_array.data, source_array.indices,
                          source_array.indptr, source_array.shape)
    if isinstance(source_array, RowSparseNDArray):
        return RowSparseNDArray(source_array.data, source_array.indices,
                                source_array.shape)
    return csr_matrix(source_array, ctx=ctx, dtype=dtype)


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage ``stype`` (ref:
    python/mxnet/ndarray/sparse.py zeros)."""
    dtype = np.dtype(dtype or np.float32)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = _device_of(ctx=ctx)
    if stype == "csr":
        if len(shape) != 2:
            raise ValueError("csr storage requires a 2-D shape, got %s"
                             % (shape,))
        return CSRNDArray(_nd(np.zeros((0,), dtype), dev),
                          np.zeros((0,), np.int32),
                          np.zeros((shape[0] + 1,), np.int32), shape)
    if stype == "row_sparse":
        return RowSparseNDArray(_nd(np.zeros((0,) + shape[1:], dtype), dev),
                                np.zeros((0,), np.int32), shape)
    return _nd(np.zeros(shape, dtype), dev)


def _dense_tensor(arr):
    return arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)


def dense_to_row_sparse(arr):
    """A dense gradient as the row-sparse array of its nonzero rows, found
    on the device (one count read back). The Trainer carries an
    ``Embedding(sparse_grad=True)`` gradient this way."""
    x = _dense_tensor(arr).detach()
    mask = (x != 0).reshape(x.shape[0], -1).any(1)
    rows = torch.nonzero(mask).flatten()
    out = RowSparseNDArray(NDArray(x.index_select(0, rows)),
                           NDArray(rows.to(torch.int32)), x.shape)
    out._unpadded = True
    return out


def dense_to_row_sparse_padded(arr):
    """:func:`dense_to_row_sparse` with the rows padded to the next power
    of two (at most the row count), as the JAX package carries a gradient
    so that its jitted lazy step compiles few shapes: the padding rows'
    id is ``nrows`` and their values are 0; the lazy update drops them."""
    x = _dense_tensor(arr).detach()
    nrows = x.shape[0]
    got = dense_to_row_sparse(x)
    count = got.nnz_rows
    size = 1 if count == 0 else 1 << (count - 1).bit_length()
    size = max(min(size, nrows), count)
    pad = size - count
    rows, vals = got.indices._data, got.data._data
    if pad:
        rows = torch.cat([rows, rows.new_full((pad,), nrows)])
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
    return RowSparseNDArray(NDArray(vals), NDArray(rows), x.shape)


def cast_storage(arr, stype):
    """Convert between ``default``, ``csr`` and ``row_sparse``
    (ref: src/operator/tensor/cast_storage.cc)."""
    cur = getattr(arr, "stype", "default")
    if cur == stype:
        return arr
    if stype not in ("default", "csr", "row_sparse"):
        raise ValueError("unknown storage type %r" % (stype,))
    dense = arr.todense() if cur != "default" else arr
    if stype == "default":
        return dense
    return csr_matrix(dense) if stype == "csr" else row_sparse_array(dense)


def retain(rsp, indices):
    """The rows of ``rsp`` whose ids are in ``indices``
    (ref: src/operator/tensor/sparse_retain.cc)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects RowSparseNDArray")
    want = _host(indices).astype(np.int64)
    have = rsp.indices.asnumpy().astype(np.int64)
    keep = np.nonzero(np.isin(have, want))[0]
    data = rsp.data._data
    sel = torch.from_numpy(keep).to(data.device)
    return RowSparseNDArray(NDArray(data.index_select(0, sel)),
                            have[keep].astype(np.int32), rsp.shape)


def _merge_rsp(lhs, rhs, op):
    """Two row-sparse arrays merged row by row over the union of their
    rows (the ids on the host)."""
    li = lhs.indices.asnumpy().astype(np.int64)
    ri = rhs.indices.asnumpy().astype(np.int64)
    union = np.union1d(li, ri)
    ld, rd = lhs.data._data, rhs.data._data
    dev = ld.device
    lpos = torch.from_numpy(np.searchsorted(union, li)).to(dev)
    rpos = torch.from_numpy(np.searchsorted(union, ri)).to(dev)
    out = torch.zeros((len(union),) + lhs.shape[1:],
                      dtype=torch.promote_types(ld.dtype, rd.dtype),
                      device=dev)
    a = out.index_add(0, lpos, ld.to(out.dtype))
    b = out.index_add(0, rpos, rd.to(out.dtype))
    merged = {"add": a + b, "sub": a - b, "mul": a * b}[op]
    return RowSparseNDArray(NDArray(merged), union.astype(np.int32),
                            lhs.shape)


def _elemwise(lhs, rhs, op):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        if lhs.shape != rhs.shape:
            raise ValueError("shape mismatch %s vs %s"
                             % (lhs.shape, rhs.shape))
        return _merge_rsp(lhs, rhs, op)
    ld = lhs.todense() if hasattr(lhs, "todense") else lhs
    rd = rhs.todense() if hasattr(rhs, "todense") else rhs
    return {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
            "mul": lambda a, b: a * b}[op](ld, rd)


def elemwise_add(lhs, rhs):
    """row-sparse + row-sparse stays row-sparse; with a dense operand the
    result is dense (ref: src/operator/tensor/elemwise_binary_op_basic.cc)."""
    return _elemwise(lhs, rhs, "add")


def elemwise_sub(lhs, rhs):
    return _elemwise(lhs, rhs, "sub")


def elemwise_mul(lhs, rhs):
    return _elemwise(lhs, rhs, "mul")


add = elemwise_add
subtract = elemwise_sub
multiply = elemwise_mul


def add_n(*arrs):
    """The sum of the arrays; row-sparse when every one is
    (ref: src/operator/tensor/elemwise_sum.cc)."""
    if len(arrs) == 1 and isinstance(arrs[0], (list, tuple)):
        arrs = arrs[0]
    out = arrs[0]
    for a in arrs[1:]:
        out = elemwise_add(out, a)
    return out


@register_op("_csr_dot")
def _csr_dot(vals, indices, indptr, rhs, *, nrows, ncols, transpose_a=False):
    """CSR x dense without densifying the CSR side: each stored value
    times its column's row of ``rhs`` (a gather), summed into its row of
    the output (``index_add``); ``transpose_a`` sums into the column's row
    instead. Autograd reaches ``vals`` and ``rhs`` (ref:
    src/operator/tensor/dot.cc DotCsrDnsDns / DotCsrTDnsDns)."""
    nnz = vals.shape[0]
    pos = torch.arange(nnz, device=vals.device)
    rows = torch.searchsorted(indptr.long(), pos, right=True) - 1
    cols = indices.long()
    dtype = torch.promote_types(vals.dtype, rhs.dtype)
    vals, rhs = vals.to(dtype), rhs.to(dtype)
    src, dst, n = (rows, cols, ncols) if transpose_a else (cols, rows, nrows)
    if rhs.dim() == 1:
        contrib = vals * rhs.index_select(0, src)
    else:
        contrib = vals[:, None] * rhs.index_select(0, src)
    out = torch.zeros((n,) + tuple(rhs.shape[1:]), dtype=dtype,
                      device=vals.device)
    return out.index_add(0, dst, contrib)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (ref: src/operator/tensor/dot.cc): CSR x dense by
    :func:`_csr_dot`; any other sparse operand is densified first."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) \
            and not transpose_b:
        return invoke("_csr_dot", (lhs.data, lhs.indices, lhs.indptr, rhs),
                      {"nrows": lhs.shape[0], "ncols": lhs.shape[1],
                       "transpose_a": transpose_a})
    if isinstance(lhs, (CSRNDArray, RowSparseNDArray)):
        lhs = lhs.todense()
    if isinstance(rhs, (CSRNDArray, RowSparseNDArray)):
        rhs = rhs.todense()
    return invoke("dot", (lhs, rhs), {"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})
