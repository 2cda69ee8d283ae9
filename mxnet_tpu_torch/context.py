"""Device context (ref: python/mxnet/context.py).

MXNet's ``Context`` names a device; in the port it resolves to a
``torch.device``. ``gpu(i)`` is CUDA device ``i`` of this process.
"""
from __future__ import annotations

import torch


class Context:
    def __init__(self, device_type, device_id=0):
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self):
        if self.device_type == "cpu":
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


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
