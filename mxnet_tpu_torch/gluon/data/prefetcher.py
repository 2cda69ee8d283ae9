"""Device prefetcher (counterpart of ``mxnet_tpu/gluon/data/prefetcher.py``):
each batch's copy to the device issued one batch ahead of the consumer.

The JAX package overlaps its transfers through ``jax.device_put``'s async
dispatch; here each host array is staged in pinned memory and copied with
``non_blocking=True`` on a side CUDA stream, an event recorded after the
copy. When the consumer takes the batch its current stream waits on that
event, and each device tensor is marked used on the consumer's stream
(``record_stream``), so the caching allocator does not hand its memory out
again before the consumer's work on it is done.

Placement (``ctx``): None (the current context), a Context or device, or a
list of them: then axis 0 is split as ``split_and_load(even_split=False)``
does (the last part takes the remainder) and each batch entry becomes a
list of per-device arrays. The JAX package's ``jax.sharding.Sharding``
target is not applicable: each torch rank runs its own program
(``ROADMAP.md`` C.2).
"""
from __future__ import annotations

import torch

from ...base import resolve_device
from ...ndarray import NDArray

__all__ = ["DevicePrefetcher"]


class _Staged:
    """One batch in flight: its structure with device tensors, the event
    of its copies by device (none on the CPU) and the copied tensors."""

    __slots__ = ("batch", "event", "tensors")

    def __init__(self, batch, event, tensors):
        self.batch, self.event, self.tensors = batch, event, tensors


class DevicePrefetcher:
    def __init__(self, loader, ctx=None):
        from ...context import Context, current_context

        self._loader = loader
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            self._devices = [resolve_device(c) for c in ctx]
            self._split = True
        elif isinstance(ctx, (Context, torch.device, str)):
            self._devices = [resolve_device(ctx)]
            self._split = False
        else:
            raise TypeError(
                "DevicePrefetcher places on a Context, a device or a list of "
                "them, not %s (a sharding target is not applicable: each "
                "torch rank runs its own program)" % type(ctx).__name__)
        self._streams = {}

    def __len__(self):
        return len(self._loader)

    def _stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _copy(self, t, dev, staged):
        if dev.type != "cuda":
            return t.to(dev)
        host = t if t.is_pinned() else t.pin_memory()
        with torch.cuda.stream(self._stream(dev)):
            out = host.to(dev, non_blocking=True)
        staged.append((out, dev))
        return out

    def _put_one(self, x, staged):
        if not isinstance(x, NDArray):
            return x
        t = x._data
        if not self._split:
            return NDArray(self._copy(t, self._devices[0], staged))
        n, rows = len(self._devices), t.shape[0]
        step = max(1, rows // n)
        parts = []
        for k, dev in enumerate(self._devices):
            lo = k * step
            hi = rows if k == n - 1 else min(rows, (k + 1) * step)
            parts.append(NDArray(self._copy(t[lo:hi], dev, staged)))
        return parts

    def _put(self, batch):
        staged = []
        if isinstance(batch, (list, tuple)):
            out = type(batch)(self._put_one(b, staged) for b in batch)
        else:
            out = self._put_one(batch, staged)
        events = {}
        for _, dev in staged:
            if dev not in events:
                ev = torch.cuda.Event()
                ev.record(self._stream(dev))
                events[dev] = ev
        return _Staged(out, events, staged)

    def _take(self, st):
        """The batch, the consumer's streams ordered after its copies."""
        for dev, ev in st.event.items():
            torch.cuda.current_stream(dev).wait_event(ev)
        for t, dev in st.tensors:
            t.record_stream(torch.cuda.current_stream(dev))
        return st.batch

    def __iter__(self):
        it = iter(self._loader)
        try:
            ahead = self._put(next(it))
        except StopIteration:
            return
        for batch in it:
            nxt = self._put(batch)  # copies in flight while the consumer
            yield self._take(ahead)  # works on this one
            ahead = nxt
        yield self._take(ahead)
