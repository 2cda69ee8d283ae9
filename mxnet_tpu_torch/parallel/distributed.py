"""The multi-process runtime (counterpart of
``mxnet_tpu/parallel/distributed.py``; ref: src/kvstore/kvstore_dist.h and
ps-lite's launcher contract).

Each rank is one process with one device, joined into one
``torch.distributed`` group: NCCL on CUDA devices, gloo for
``device="cpu"``. The MXNet launcher's environment still works: with no
arguments, ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` give the
coordinator, ``DMLC_NUM_WORKER`` the world size and ``DMLC_WORKER_ID`` the
rank, so ``python tools/launch.py -n 4 python script.py`` starts a port
script unchanged. A group of one process needs no coordinator (an
in-process store).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..base import resolve_device

__all__ = ["init_process_group", "rank", "size", "local_devices",
           "global_mesh", "barrier", "device", "is_initialized",
           "shutdown", "check_device", "AxisRing", "all_to_all"]

_device = None


def init_process_group(coordinator_address=None, num_processes=None,
                       process_id=None, device=None, init_method=None,
                       timeout_s=None):
    """Join the group (once; a second call returns). ``device``: where this
    rank runs, default the current CUDA device (``cuda:<rank % cards>``
    when several ranks share a host); ``"cpu"`` selects gloo.
    ``init_method`` (e.g. ``file:///tmp/x``) overrides the coordinator."""
    global _device
    if dist.is_initialized():
        return
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9000")
        if uri:
            coordinator_address = "%s:%s" % (uri, port)
    if num_processes is None:
        num_processes = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DMLC_WORKER_ID", "0"))
    if device is None:
        dev = resolve_device(None)
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if init_method is None and coordinator_address is not None:
        init_method = "tcp://%s" % coordinator_address
    if init_method is None:
        if num_processes != 1:
            raise ValueError(
                "a group of %d processes needs a coordinator: pass "
                "coordinator_address/init_method or set DMLC_PS_ROOT_URI"
                % num_processes)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=process_id, world_size=num_processes,
                                **kw)
    _device = dev


def is_initialized():
    return dist.is_initialized()


def shutdown():
    """Leave the group (``destroy_process_group``)."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def size():
    return dist.get_world_size() if dist.is_initialized() else 1


def device():
    """This rank's device (None before :func:`init_process_group`)."""
    return _device


def check_device(*tensors):
    """Raise ``DeviceError`` unless every tensor lies on this rank's device
    (where its group's collectives run: a CUDA tensor in a gloo group of
    CPU ranks, as on a machine without a card, is refused). Nothing is
    checked before :func:`init_process_group`."""
    from ..base import DeviceError

    if _device is None:
        return
    for t in tensors:
        d = t.device
        if d.type != _device.type or (d.type == "cuda"
                                      and d.index != _device.index):
            raise DeviceError("a tensor on %s; this rank runs on %s"
                              % (d, _device))


def local_devices():
    return [_device] if _device is not None else []


def global_mesh(axes):
    """A mesh over every rank of the group, its first axis outermost."""
    from .mesh import make_mesh

    return make_mesh(axes)


def barrier():
    """Wait for every rank (nothing to wait for in a group of one)."""
    if size() > 1:
        dist.barrier()


class AxisRing:
    """This rank's two neighbours on a mesh axis's group, ``(i + 1) % n``
    and ``(i - 1) % n``, and the point-to-point exchanges of the rings that
    ride them (ring attention's K/V blocks, a pipeline's activations and
    cotangents). On a ring of one rank every send is to itself and is its
    receive: nothing is launched."""

    def __init__(self, mesh, axis):
        self.group = mesh.group(axis)
        self.n = int(mesh.shape[axis])
        self.index = mesh.local_rank(axis)
        ranks = dist.get_process_group_ranks(self.group)
        self.next = ranks[(self.index + 1) % self.n]
        self.prev = ranks[(self.index - 1) % self.n]

    def post(self, sends, recvs):
        """Start ``sends`` ([(tensor, peer)]) and ``recvs`` ([(like,
        peer)]) as one ``batch_isend_irecv``; returns (the requests, the
        receive buffers in ``recvs``' order)."""
        if self.n == 1:
            return [], [t for t, _ in sends]
        outs = [torch.empty_like(like) for like, _ in recvs]
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer, self.group)
               for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, o, peer, self.group)
                for o, (_, peer) in zip(outs, recvs)]
        return (dist.batch_isend_irecv(ops) if ops else []), outs

    def exchange(self, sends, recvs):
        """:meth:`post`, waited for: the received tensors."""
        reqs, outs = self.post(sends, recvs)
        for r in reqs:
            r.wait()
        return outs


def _all_to_all(x, group, n, split, cat):
    if n == 1:
        return x
    xs = x.unflatten(split, (n, x.shape[split] // n)).movedim(split, 0)
    xs = xs.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    return out.movedim(0, cat).flatten(cat, cat + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, cat):
        ctx.args = (group, n, split, cat)
        return _all_to_all(x, group, n, split, cat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, cat = ctx.args
        return _all_to_all(g, group, n, cat, split), None, None, None, None


def all_to_all(x, mesh, axis, split, cat):
    """``lax.all_to_all(tiled=True)`` over ``axis``'s group: ``x`` cut
    into n blocks along ``split``, block j sent to rank j, the received
    blocks concatenated along ``cat`` in source order
    (``all_to_all_single``). Differentiable: the backward is the inverse
    all-to-all."""
    return _AllToAll.apply(x, mesh.group(axis), int(mesh.shape[axis]),
                           split, cat)
