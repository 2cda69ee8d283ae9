"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``; ref:
python/mxnet/gluon/data/dataloader.py).

Three routes, as in the JAX package: serial (``num_workers=0``), a thread
pool (the default with workers: a bounded window of batches in flight,
yielded in order, the pool cancelled on an early break) and, with
``thread_pool=False``, spawned worker processes that batchify in numpy
(``default_mp_batchify_fn``), the parent making the arrays. A worker
process never touches a CUDA device: the card is hidden from it
(``CUDA_VISIBLE_DEVICES`` empty in the environment it starts with, before
it imports torch), the counterpart of the JAX package's
``_pin_worker_to_cpu``. A process worker takes a dataset that pickles as
host data (numpy arrays, CPU arrays).

Batches are NDArrays on the context current where the epoch began (the
thread workers make theirs under it). With ``pin_memory=True`` they are
made on the host and ``DevicePrefetcher`` stages each in pinned memory and
copies it to that context's device on a side stream, one batch ahead.
"""
from __future__ import annotations

import os
import threading
from collections import deque

import numpy as np

from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """(ref: dataloader.py:default_batchify_fn) Samples stacked into one
    array (float64 as float32), a tuple sample field by field."""
    if isinstance(data[0], NDArray):
        return array(np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return array(arr)


def default_mp_batchify_fn(data):
    """The batchify of the worker processes: numpy arrays, which the
    parent turns into NDArrays."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_mp_batchify_fn(list(i)) for i in data]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


_worker_dataset = None


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _worker_fn(indices, batchify_fn):
    return batchify_fn([_worker_dataset[i] for i in indices])


def _worker_report():
    """What a worker process sees of the card (a test reads it)."""
    import torch

    return {"pid": os.getpid(),
            "CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_initialized": torch.cuda.is_initialized(),
            "device_count": torch.cuda.device_count()}


_env_lock = threading.Lock()


def _spawn_hidden(n, dataset):
    """A pool of ``n`` spawned workers, every one started with the card
    hidden: the environment variable is set while they start and put back
    after."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    torch.cuda.is_available()  # this process's device count, read first
    pool = ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
        "spawn"), initializer=_worker_initializer, initargs=(dataset,))
    with _env_lock:
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            # n tasks at once start all n workers now (the pool starts one
            # a task while none is idle)
            futs = [pool.submit(_worker_report) for _ in range(n)]
            reports = [f.result() for f in futs]
        finally:
            if prev is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev
    return pool, reports


def _to_arrays(batch):
    if isinstance(batch, np.ndarray):
        return array(batch)
    if isinstance(batch, (list, tuple)):
        return [_to_arrays(b) for b in batch]
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler is "
                                 "None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._thread_pool = thread_pool
        self._user_batchify = batchify_fn
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._mp_pool = None
        self.worker_reports = []  # what each worker process saw at start
        self._pin_memory = pin_memory
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(num_workers, 1))

    def _make_batch(self, indices, ctx=None):
        if ctx is None:
            return self._batchify_fn([self._dataset[i] for i in indices])
        with ctx:
            return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        from ...context import cpu
        from ...io import _context_here

        if self._pin_memory:
            from .prefetcher import DevicePrefetcher

            target = _context_here()
            yield from DevicePrefetcher(self._iter_batches(cpu()),
                                        ctx=target or cpu())
            return
        yield from self._iter_batches(_context_here())

    def _iter_batches(self, ctx):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices, ctx)
            return
        if self._thread_pool:
            yield from self._prefetch_iter(ctx)
        else:
            yield from self._mp_iter(ctx)

    def _prefetch_iter(self, ctx):
        """Batches built on ``num_workers`` threads, at most a window in
        flight, yielded oldest first."""
        from concurrent.futures import ThreadPoolExecutor

        window = max(self._prefetch, self._num_workers)
        pool = ThreadPoolExecutor(self._num_workers)
        try:
            futs = deque()
            it = iter(self._batch_sampler)
            for indices in it:
                futs.append(pool.submit(self._make_batch, indices, ctx))
                if len(futs) >= window:
                    break
            while futs:
                f = futs.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(pool.submit(self._make_batch, nxt, ctx))
                yield f.result()
        finally:
            # an early break does not wait for the window's batches
            pool.shutdown(wait=False, cancel_futures=True)

    def _mp_iter(self, ctx):
        """``num_workers`` spawned processes, the same window and order;
        the pool lasts as long as the loader."""
        batchify = self._user_batchify or default_mp_batchify_fn
        if batchify is default_batchify_fn:
            batchify = default_mp_batchify_fn
        window = max(self._prefetch, self._num_workers)
        if self._mp_pool is None:
            self._mp_pool, self.worker_reports = _spawn_hidden(
                self._num_workers, self._dataset)
        pool = self._mp_pool
        futs = deque()
        try:
            it = iter(self._batch_sampler)
            for indices in it:
                futs.append(pool.submit(_worker_fn, indices, batchify))
                if len(futs) >= window:
                    break
            while futs:
                f = futs.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(pool.submit(_worker_fn, nxt, batchify))
                if ctx is None:
                    yield _to_arrays(f.result())
                else:
                    with ctx:
                        batch = _to_arrays(f.result())
                    yield batch
        finally:
            for f in futs:  # an early break: this epoch's work only
                f.cancel()

    def worker_probe(self):
        """Each worker process's view of the card (``_worker_report``),
        asked now; starts the pool if it is not running."""
        if self._mp_pool is None:
            self._mp_pool, self.worker_reports = _spawn_hidden(
                self._num_workers, self._dataset)
        futs = [self._mp_pool.submit(_worker_report)
                for _ in range(self._num_workers)]
        return [f.result() for f in futs]

    def close(self):
        """Stop the worker processes."""
        pool, self._mp_pool = self._mp_pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        pool = self.__dict__.get("_mp_pool")
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self):
        return len(self._batch_sampler)
