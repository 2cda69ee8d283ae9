"""``mx.nd.random`` (counterpart of ``mxnet_tpu/nd/random.py``): draws into
new NDArrays on ``ctx`` (default: the current context), from that device's
generator on this thread (``mx.random.seed``). Not differentiable."""
from __future__ import annotations

import torch

from .. import random as _rng
from ..base import resolve_device, resolve_dtype
from ..context import current_context
from ..ndarray import NDArray
from ..ops import legacy_ops as _k  # one sampler per distribution


def _dev(ctx):
    return resolve_device(ctx or current_context())


def _dt(dtype, default=torch.float32):
    return resolve_dtype(dtype) or default


def _out(res, out):
    if out is not None:
        out._rebind(res)
        return out
    return NDArray(res)


def uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    return _out(_k.k_uniform(_k._rand_shape(shape), _dt(dtype), _dev(ctx),
                             low, high), out)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, out=None):
    return _out(_k.k_normal(_k._rand_shape(shape), _dt(dtype), _dev(ctx),
                            loc, scale), out)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high, shape=(1,), dtype="int32", ctx=None):
    return NDArray(_k.k_randint(_k._rand_shape(shape), _dt(dtype), _dev(ctx),
                                low, high))


def exponential(scale=1.0, shape=(1,), dtype=None, ctx=None):
    return NDArray(_k.k_exponential(_k._rand_shape(shape), _dt(dtype),
                                    _dev(ctx), scale))


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None):
    return NDArray(_k.k_gamma(_k._rand_shape(shape), _dt(dtype), _dev(ctx),
                              alpha, beta))


def poisson(lam=1.0, shape=(1,), dtype=None, ctx=None):
    return NDArray(_k.k_poisson(_k._rand_shape(shape), _dt(dtype), _dev(ctx),
                                lam))


def negative_binomial(k=1, p=1.0, shape=(1,), dtype=None, ctx=None):
    return NDArray(_k.k_negative_binomial(_k._rand_shape(shape), _dt(dtype),
                                          _dev(ctx), k, p))


def multinomial(data, shape=1, get_prob=False, dtype="int32"):
    """Index draws from the probability rows of ``data``; ``shape=1``
    squeezes the draw axis, as upstream."""
    kshape = () if isinstance(shape, int) and shape == 1 else shape
    out, logits = _k.multinomial_draw(data._data, kshape, dtype)
    if get_prob:
        lp = torch.take_along_dim(
            torch.log_softmax(logits, dim=-1),
            out.reshape(tuple(data.shape[:-1]) + (-1,)).to(torch.int64),
            dim=-1).reshape(out.shape)
        return NDArray(out), NDArray(lp)
    return NDArray(out)


def shuffle(data):
    perm = torch.randperm(data.shape[0], generator=_rng.generator(
        data._data.device), device=data._data.device)
    return NDArray(data._data.detach()[perm])


def seed(s, ctx=None):
    _rng.seed(s, ctx)
