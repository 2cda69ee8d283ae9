"""Random state (counterpart of ``mxnet_tpu/random.py``): :func:`seed` and
the per-device ``torch.Generator`` that every random draw on a device
(``Dropout``'s mask, ``nd.random``, the ``random_*`` ops) comes from.

As in the JAX package the state is per thread: one seed, and on each device
a generator seeded from it at first use. The bits differ from JAX's
threefry for the same seed; tests hand both packages the same numbers, or
compare distributions.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["seed", "generator", "fork", "current_seed"]

_state = threading.local()


def _generators():
    if not hasattr(_state, "generators"):
        _state.seed = 0
        _state.generators = {}
    return _state.generators


def seed(seed_state, ctx=None):
    """Seed this thread's generators: on every device, or with ``ctx`` (a
    Context or device) only that device's."""
    gens = _generators()
    if ctx is None:
        gens.clear()
        _state.seed = int(seed_state)
        return
    dev = ctx.torch_device() if hasattr(ctx, "torch_device") else ctx
    dev = _key(dev)
    gens[dev] = torch.Generator(device=dev).manual_seed(int(seed_state))


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device):
    """The generator of ``device`` on this thread (made at first use from
    the current seed)."""
    dev = _key(device)
    gens = _generators()
    gen = gens.get(dev)
    if gen is None:
        gen = gens[dev] = torch.Generator(device=dev).manual_seed(_state.seed)
    return gen


def current_seed():
    """The seed this thread's generators start from."""
    _generators()
    return _state.seed


@contextmanager
def fork(device, seed_state):
    """Inside the block, this thread's draws on ``device`` come from a new
    generator seeded with ``seed_state``; the one before comes back after
    it, as it was."""
    dev = _key(device)
    gens = _generators()
    saved = gens.get(dev)
    gens[dev] = torch.Generator(device=dev).manual_seed(int(seed_state))
    try:
        yield gens[dev]
    finally:
        if saved is None:
            gens.pop(dev, None)
        else:
            gens[dev] = saved


# ---------------------------------------------------------------- samplers
# mx.random re-exports the nd.random samplers (upstream's python/mxnet/
# random.py; the JAX package delegates the same way), lazily: nd imports
# this module.
def _delegate(name):
    def f(*args, **kwargs):
        from . import nd

        return getattr(nd.random, name)(*args, **kwargs)

    f.__name__ = name
    f.__doc__ = "mx.random.%s: delegates to nd.random.%s" % (name, name)
    return f


uniform = _delegate("uniform")
normal = _delegate("normal")
randn = _delegate("randn")
randint = _delegate("randint")
exponential = _delegate("exponential")
gamma = _delegate("gamma")
poisson = _delegate("poisson")
negative_binomial = _delegate("negative_binomial")
multinomial = _delegate("multinomial")


def shuffle(data):
    """Permute ``data`` (an NDArray) along its first axis in place and
    return None, as upstream's ``mx.random.shuffle`` does."""
    from . import nd

    data._data = nd.random.shuffle(data)._data


__all__ += ["uniform", "normal", "randn", "randint", "exponential",
            "gamma", "poisson", "negative_binomial", "multinomial",
            "shuffle"]
