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
           "shutdown"]

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
