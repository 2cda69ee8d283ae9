"""Device context (ref: python/mxnet/context.py; the JAX package's
``mxnet_tpu/context.py``).

MXNet's ``Context`` names a device; in the port it resolves to a
``torch.device``. ``gpu(i)`` is CUDA device ``i`` of this process.

``with mx.gpu(0):`` / ``with mx.cpu():`` set the context that ``nd.array``
and the other creation functions use when they are given no ``ctx``. The
scope is per thread, as in the JAX package. Without a scope the default is
the current CUDA device, and with no CUDA device :func:`current_context`
raises ``DeviceError``: the port never carries on silently on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import DeviceError

_tls = threading.local()
# the process-wide default that test_utils.set_default_context sets
_default = None


class Context:
    # MXNet's device type ids (ref: python/mxnet/context.py)
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if isinstance(device_type, int):
            device_type = self.devtype2str.get(device_type, device_type)
        if device_type not in self.devstr2type:
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def torch_device(self):
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        if not hasattr(_tls, "stack"):
            _tls.stack = []
        _tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()

    @classmethod
    def default_ctx(cls):
        stack = getattr(_tls, "stack", None)
        if stack:
            return stack[-1]
        if _default is not None:
            return _default
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available: pass ctx=mx.cpu() or enter "
                "`with mx.cpu():` to run on the CPU")
        return gpu(torch.cuda.current_device())


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """Page-locked host memory in MXNet; here a CPU context (its tensors
    are host tensors, which ``Tensor.pin_memory`` pins on demand)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with ctx:`` of this thread, else the current CUDA
    device (``DeviceError`` without one)."""
    return Context.default_ctx()


def context_from_device(dev):
    """The Context of a ``torch.device``."""
    dev = torch.device(dev)
    if dev.type == "cpu":
        return cpu(0)
    return gpu(torch.cuda.current_device() if dev.index is None
               else dev.index)


def gpu_memory_info(device_id=0):
    """(free, total) bytes of CUDA device ``device_id``
    (``torch.cuda.mem_get_info``); raises ``DeviceError`` without one, as
    upstream raises on a host with no GPU."""
    if not 0 <= device_id < num_gpus():
        raise DeviceError("no CUDA device %d" % device_id)
    free, total = torch.cuda.mem_get_info(device_id)
    return int(free), int(total)
