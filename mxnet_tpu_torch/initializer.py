"""Weight initializers (ref: python/mxnet/initializer.py; the JAX package's
``mxnet_tpu/initializer.py``).

The naming convention of MXNet decides what a parameter gets: names ending
in ``bias`` or ``beta`` start at zero, ``gamma`` at one, ``running_mean``
(``moving_mean``) at zero and ``running_var`` (``moving_var``) at one;
everything else goes to the initializer's ``_init_weight``. Random draws
come from the ``torch.Generator`` the caller passes, so a seed fixes every
weight; the deterministic initializers (``Constant``, ``Orthogonal``, whose
matrix comes from numpy's seed-0 stream as in the JAX package,
``Bilinear``, ``LSTMBias``) give the JAX package's values exactly.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "Load", "create"]


class Initializer:
    def __call__(self, name, shape, dtype, device, generator):
        """A new tensor for the parameter ``name``."""
        name = str(name)
        if name.endswith("bias"):
            out = self._init_bias(shape, device)
        elif name.endswith("beta") or name.endswith("running_mean") \
                or name.endswith("moving_mean"):
            out = torch.zeros(shape, device=device)
        elif name.endswith("gamma") or name.endswith("running_var") \
                or name.endswith("moving_var"):
            out = torch.ones(shape, device=device)
        else:
            out = self._init_weight(shape, device, generator)
        return out.to(dtype)

    def _init_bias(self, shape, device):
        return torch.zeros(shape, device=device)

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


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, shape, device, generator):
        return torch.full(shape, float(self.value), device=device)


class Uniform(Initializer):
    """U(-scale, scale); the default for weights without an initializer of
    their own (Dense's and the convolutions' weights, as in the JAX
    package)."""

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


class Orthogonal(Initializer):
    """``scale`` times an orthonormal (rows, prod(rest)) matrix from the SVD
    of numpy's seed-0 uniform (or normal) draw, as the JAX package takes
    it: the same matrix whatever the generator."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, shape, device, generator):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        rs = np.random.RandomState(0)
        tmp = rs.uniform(-1, 1, (rows, cols)) if self.rand_type == "uniform" \
            else rs.normal(0, 1, (rows, cols))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        return torch.as_tensor(np.asarray(self.scale * q.reshape(shape),
                                          np.float32), device=device)


class Xavier(Initializer):
    """(ref: initializer.py:Xavier) U(-s, s) or N(0, s) with s =
    sqrt(magnitude / factor), the factor the fan in, the fan out or their
    mean (a convolution's fans count its kernel's size)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, shape, device, generator):
        hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
        fan_out = shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            u = torch.rand(shape, device=device, generator=generator)
            return (u * 2.0 - 1.0) * scale
        return torch.randn(shape, device=device, generator=generator) * scale


class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


class Bilinear(Initializer):
    """A bilinear upsampling kernel over the last two axes (for a
    ``Conv2DTranspose`` weight)."""

    def _init_weight(self, shape, device, generator):
        n = int(np.prod(shape))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))).astype(
            np.float32)
        return torch.as_tensor(w.reshape(shape), device=device)


class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (the second) at
    ``forget_bias``; a bias takes it too."""

    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, shape, device, generator):
        b = torch.zeros(shape, device=device)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b

    def _init_bias(self, shape, device):
        return self._init_weight(shape, device, None)


class Mixed:
    """The first initializer whose pattern matches the parameter's name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, shape, dtype, device, generator):
        for prog, init in self.map:
            if prog.match(str(name)):
                return init(name, shape, dtype, device, generator)
        raise ValueError("no initializer matched %r" % str(name))


class Load:
    """Values by name from a dict of arrays (``{name: array}``, a name also
    found after an ``arg:``/``aux:`` prefix), ``default_init`` for the
    others (ref: python/mxnet/initializer.py:Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {str(k): v for k, v in dict(param).items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, shape, dtype, device, generator):
        from .util import to_tensor

        name = str(name)
        key = name if name in self.param else name.split(":", 1)[-1]
        if key in self.param:
            src = to_tensor(self.param[key])
            if tuple(src.shape) != tuple(shape):
                raise ValueError(
                    "Parameter %r cannot be initialized from loading: shape "
                    "%s != expected %s" % (name, tuple(src.shape),
                                           tuple(shape)))
            if self.verbose:
                print("Initialized %s by loading" % name)
            return src.to(device=device, dtype=dtype)
        if self.default_init is None:
            raise ValueError("Cannot initialize parameter %r: not found in "
                             "the loaded dict and no default_init given"
                             % name)
        return self.default_init(name, shape, dtype, device, generator)


_BY_NAME = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
            "constant": Constant, "uniform": Uniform, "normal": Normal,
            "orthogonal": Orthogonal, "xavier": Xavier,
            "msraprelu": MSRAPrelu, "bilinear": Bilinear,
            "lstmbias": LSTMBias}


def create(name, **kwargs):
    """Initializer by MXNet's registry name ("zeros", "xavier", ...)."""
    if name.lower() not in _BY_NAME:
        raise ValueError("unknown initializer %r" % name)
    return _BY_NAME[name.lower()](**kwargs)
