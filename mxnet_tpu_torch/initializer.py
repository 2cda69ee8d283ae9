"""Weight initializers BERT uses (ref: python/mxnet/initializer.py; the
JAX package's ``mxnet_tpu/initializer.py``).

The naming convention of MXNet decides what a parameter gets: names ending
in ``bias`` or ``beta`` start at zero, ``gamma`` at one, everything else
goes to the initializer's ``_init_weight``. Random draws come from the
``torch.Generator`` the caller passes, so a seed fixes every weight.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "create"]


class Initializer:
    def __call__(self, name, shape, dtype, device, generator):
        """A new tensor for the parameter ``name``."""
        name = str(name)
        if name.endswith("bias") or name.endswith("beta"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if name.endswith("gamma"):
            return torch.ones(shape, dtype=dtype, device=device)
        out = self._init_weight(shape, device, generator)
        return out.to(dtype)

    def _init_weight(self, shape, device, generator):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


class Zero(Initializer):
    def _init_weight(self, shape, device, generator):
        return torch.zeros(shape, device=device)


class One(Initializer):
    def _init_weight(self, shape, device, generator):
        return torch.ones(shape, device=device)


class Uniform(Initializer):
    """U(-scale, scale); the default for weights without an initializer of
    their own (Dense's weight, as in the JAX package)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, shape, device, generator):
        u = torch.rand(shape, device=device, generator=generator)
        return (u * 2.0 - 1.0) * self.scale


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, shape, device, generator):
        return torch.randn(shape, device=device, generator=generator) \
            * self.sigma


_BY_NAME = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
            "uniform": Uniform, "normal": Normal}


def create(name):
    """Initializer by MXNet's registry name ("zeros", "ones", ...)."""
    if name.lower() not in _BY_NAME:
        raise ValueError("unknown initializer %r" % name)
    return _BY_NAME[name.lower()]()
