"""KVStore (ref: src/kvstore/kvstore_local.h, kvstore_dist.h,
python/mxnet/kvstore.py; counterpart of ``mxnet_tpu/kvstore.py``).

- ``"local"``/``"device"``/``"nccl"``: this process's store. A push of a
  list of values for one key sums them; with an optimizer set
  (:meth:`KVStore.set_optimizer`) a pushed batch of keys updates the
  stored weights in one multi-tensor step, else the push adds into the
  stored value. A pull copies the stored value into ``out`` in place (a
  parameter's gradient buffer stays the buffer), or returns a copy.
- ``"dist_sync"`` (and every other ``dist*`` name but the asynchronous
  ones): :class:`DistKVStore`, whose push is the SUM over the ranks of the
  ``torch.distributed`` group (ps-lite's servers add the workers' pushes),
  not the mean.
- ``"dist_async"``: refused, as in the JAX package; the overlapped
  synchronous exchange of ``mxnet_tpu_torch.dist`` takes its place.

2-bit gradient compression with error feedback
(:meth:`KVStore.set_gradient_compression`) quantizes each push to
{-t, 0, +t} and keeps what it dropped in a per-key residual that the next
push adds back; in the dist store the compressed value is what crosses the
ranks. ``row_sparse_pull`` raises: row-sparse storage is ROADMAP.md A.17.

Values are NDArrays or tensors; the store keeps tensors on the device of
the first value given for a key.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .ndarray import NDArray
from .optimizer import Optimizer, get_updater
from .util import tree_leaves

__all__ = ["KVStore", "DistKVStore", "create"]


def _tensor(v):
    v = getattr(v, "_data", v)
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


class KVStore:
    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._compression = None   # set_gradient_compression state
        self._residual = {}        # per-key error-feedback accumulator

    # ------------------------------------------------------------- core API
    def init(self, key, value):
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            self._store[k] = _tensor(v).detach().clone()

    def _reduce(self, agg):
        """The value of a push after this process's own sum: the dist
        store adds the other ranks' here."""
        return agg

    def push(self, key, value, priority=0):
        """Push value(s) for key(s). ``priority`` (ref:
        include/mxnet/kvstore.h) is a scheduling hint: an int, or one int
        per key, which orders a pushed batch by descending priority
        (stable); anything else raises."""
        keys, values = _normalize(key, value)
        keys, values = _apply_priority(keys, values, priority)
        batch_k, batch_g = [], []
        for k, v in zip(keys, values):
            agg = _aggregate(v)
            if self._compression is not None:
                agg = self._compress(k, agg)
            agg = self._reduce(agg)
            if self._updater is not None:
                batch_k.append(k)
                batch_g.append(agg)
            elif k in self._store:
                self._store[k] += agg.to(self._store[k].device)
            else:
                self._store[k] = agg.clone()
        if batch_k:
            # every pushed key in one multi-tensor step
            self._updater.batch_call(batch_k, batch_g,
                                     [self._store[k] for k in batch_k])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Pull the value(s) of key(s): copied into ``out`` (an NDArray or
        tensor, or a list of them, each written in place), or returned as
        new NDArrays. ``priority`` is validated as in :meth:`push`."""
        keys, outs = _normalize(key, out)
        _check_priority(priority, len(keys))
        results = []
        for k, o in zip(keys, outs):
            v = self._store[k]
            if o is not None:
                with torch.no_grad():
                    for oo in (o if isinstance(o, (list, tuple)) else [o]):
                        _tensor(oo).copy_(v)
                results.append(o)
            else:
                results.append(NDArray(v.clone()))
        return results if len(results) > 1 else results[0]

    def pushpull(self, key, value, out=None, priority=0):
        """Push then pull (ref: python/mxnet/kvstore.py:pushpull)."""
        self.push(key, value, priority)
        return self.pull(key, out if out is not None else value, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError(
            "row_sparse_pull needs row-sparse storage, which is not ported "
            "yet (ROADMAP.md A.17)")

    def set_optimizer(self, optimizer):
        if not isinstance(optimizer, Optimizer):
            raise TypeError("set_optimizer takes an Optimizer, got %r"
                            % (optimizer,))
        self._updater = get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback (ref:
        src/kvstore/gradient_compression.cc): ``{"type": "2bit",
        "threshold": t}``; other types raise."""
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError("unsupported gradient compression type %r "
                             "(only '2bit')" % (ctype,))
        self._compression = {
            "type": ctype,
            "threshold": float(compression_params.get("threshold", 0.5)),
        }
        self._residual = {}

    def _compress(self, k, agg):
        acc = agg
        if k in self._residual:
            acc = acc + self._residual[k]
        q, r = two_bit_quantize(acc, self._compression["threshold"])
        self._residual[k] = r
        return q

    # ------------------------------------------------------------- topology
    @property
    def rank(self):
        from .parallel import distributed

        return distributed.rank()

    @property
    def num_workers(self):
        from .parallel import distributed

        return distributed.size()

    def barrier(self):
        from .parallel import distributed

        distributed.barrier()

    def _state_leaves(self):
        return tree_leaves(self._updater.states)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The updater's states, their leaves in ``jax.tree_util`` order
        (keys sorted) as a pickled list of numpy arrays: the JAX
        package's file."""
        if self._updater is not None:
            with open(fname, "wb") as f:
                pickle.dump([t.detach().cpu().numpy()
                             for t in self._state_leaves()], f)

    def load_optimizer_states(self, fname):
        """Fill the updater's states from a file either package wrote:
        every stored key's state is made first, then its leaves are
        copied from the file's arrays in order."""
        if self._updater is None:
            raise RuntimeError("set_optimizer first: the states belong to "
                               "the store-side updater")
        from .gluon.trainer import _StateUnpickler
        import io

        with open(fname, "rb") as f:
            arrays = _StateUnpickler(io.BytesIO(f.read())).load()
        for k in self._store:
            if k not in self._updater.states:
                self._updater.states[k] = \
                    self._updater.optimizer.create_state(k, self._store[k])
        leaves = self._state_leaves()
        if len(arrays) != len(leaves):
            raise ValueError("%s holds %d state arrays, the store's "
                             "optimizer state has %d"
                             % (fname, len(arrays), len(leaves)))
        for t, a in zip(leaves, arrays):
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError("%s: an array of shape %s for a state of "
                                 "shape %s" % (fname, a.shape,
                                               tuple(t.shape)))
        with torch.no_grad():
            for t, a in zip(leaves, arrays):
                t.copy_(torch.from_numpy(np.array(a, copy=True)))


def two_bit_quantize(acc, t):
    """(residual + gradient, threshold) -> (ternary {-t, 0, +t} in the
    gradient's dtype, new residual)."""
    tt = torch.full((), float(t), dtype=acc.dtype, device=acc.device)
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    q = torch.where(acc >= tt, tt, torch.where(acc <= -tt, -tt, zero))
    return q, acc - q


class DistKVStore(KVStore):
    """The synchronous multi-process store: each push is summed over the
    ranks of ``group`` (default: the whole group) before the update, the
    compressed value when compression is on. A group of one degenerates to
    the local store."""

    def __init__(self, kv_type="dist_sync", group=None):
        super().__init__(kv_type)
        self.group = group

    def _reduce(self, agg):
        import torch.distributed as dist

        if dist.is_initialized():
            agg = agg.clone()
            dist.all_reduce(agg, group=self.group)
        return agg


def _check_priority(priority, n_keys):
    if isinstance(priority, (list, tuple)):
        if len(priority) != n_keys:
            raise ValueError("priority list has %d entries for %d keys"
                             % (len(priority), n_keys))
        for p in priority:
            int(p)
    else:
        int(priority)


def _apply_priority(keys, values, priority):
    """Order a list-key batch by descending priority (stable); a scalar
    hint leaves it as it is."""
    _check_priority(priority, len(keys))
    if isinstance(priority, (list, tuple)) and len(keys) > 1:
        order = sorted(range(len(keys)), key=lambda i: -int(priority[i]))
        return [keys[i] for i in order], [values[i] for i in order]
    return keys, values


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


def _aggregate(v):
    if isinstance(v, (list, tuple)):
        acc = _tensor(v[0])
        for x in v[1:]:
            acc = acc + _tensor(x).to(acc.device)
        return acc
    return _tensor(v)


def create(name="local"):
    """(ref: python/mxnet/kvstore.py:create)"""
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStore(name)
    if "async" in name:
        # upstream dist_async applies server-side updates with no barrier
        # (stale gradients); what it bought, hiding the exchange behind
        # compute, the synchronous bucketed exchange of
        # mxnet_tpu_torch.dist delivers
        raise ValueError(
            "kvstore %r: asynchronous push semantics are not supported; use "
            "'dist_sync' / 'dist_device_sync' (synchronous allreduce), or "
            "mxnet_tpu_torch.dist.attach for the overlapped bucketed "
            "gradient exchange" % name)
    if name.startswith("dist"):
        return DistKVStore(name)
    raise ValueError("unknown kvstore type %r" % name)
