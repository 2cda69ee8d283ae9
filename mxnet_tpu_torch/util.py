"""Checkpoint arrays in the JAX package's exact npz format, in files and
as bytes, the environment helpers of upstream's ``mx.util``, and its
numpy-mode switches (``set_np``/``reset_np``, the ``use_np`` family,
MXNet 2.x's opt-in to numpy semantics; the flag lives in ``npx``).

A copy of the format of ``mxnet_tpu/util.py`` ``save_npz_exact`` /
``load_npz_exact``: dtypes the ``.npy`` header cannot hold (bfloat16, fp8)
are stored as their raw bits viewed as a same-width unsigned integer, plus a
``__dtype__:<name>`` sidecar entry naming the real dtype. A checkpoint either
package writes loads in the other with identical bits.

numpy has no bfloat16 of its own, so the port's side of the format is torch:
``load_npz_exact`` returns CPU tensors, ``save_npz_exact`` takes tensors or
numpy arrays.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

_NPZ_DTYPE_PREFIX = "__dtype__:"

# dtypes numpy cannot represent natively: name → (torch dtype, the integer
# dtype of the same width that both numpy and torch hold)
_BITS_DTYPES = {
    "bfloat16": (torch.bfloat16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_TORCH_NAME = {tdt: name for name, (tdt, _) in _BITS_DTYPES.items()}


def _from_bits(arr, name):
    tdt, int_dt = _BITS_DTYPES[name]
    bits = np.ascontiguousarray(arr).view(int_dt).copy()
    return torch.from_numpy(bits).view(tdt)


def to_tensor(value):
    """numpy array (including the ml_dtypes bfloat16/fp8 arrays a JAX array
    converts to) or tensor → CPU tensor of the same dtype and bits."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name in _BITS_DTYPES:
        return _from_bits(arr, arr.dtype.name)
    return torch.from_numpy(np.array(arr, copy=True))


def _encode(value):
    """→ (numpy array the .npy header holds, sidecar dtype name or None)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        name = _TORCH_NAME.get(t.dtype)
        if name is None:
            return t.numpy(), None
        itemsize = t.element_size()
        bits = t.view(torch.int16 if itemsize == 2 else torch.uint8).numpy()
        return bits.view("u%d" % itemsize), name
    arr = np.asarray(value)
    if arr.dtype.name in _BITS_DTYPES:
        return (np.ascontiguousarray(arr).view("u%d" % arr.dtype.itemsize),
                arr.dtype.name)
    return arr, None


def save_npz_exact(filename, arrays):
    """np.savez under the exact filename, atomically (temp file + rename),
    with ``__dtype__`` sidecars for bfloat16/fp8 entries."""
    enc = {}
    for k, v in arrays.items():
        arr, name = _encode(v)
        if name is not None:
            enc[_NPZ_DTYPE_PREFIX + k] = np.asarray(name)
        enc[k] = arr
    tmp = "%s.tmp%d" % (filename, os.getpid())
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **enc)
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def dumps_npz_exact(arrays):
    """:func:`save_npz_exact`'s format as bytes: the fleet's wire format
    (a worker's ``/predict`` bodies and replies, prefix-cache migration),
    so bfloat16 and fp8 cross processes exactly, to either package."""
    import io

    enc = {}
    for k, v in arrays.items():
        arr, name = _encode(v)
        if name is not None:
            enc[_NPZ_DTYPE_PREFIX + k] = np.asarray(name)
        enc[k] = arr
    buf = io.BytesIO()
    np.savez(buf, **enc)
    return buf.getvalue()


def loads_npz_exact(data):
    """Decode :func:`dumps_npz_exact` bytes (either package's): dict[name →
    CPU tensor]."""
    import io

    return load_npz_exact(io.BytesIO(data))


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


# ------------------------------------------------------------- numpy mode
def set_np(shape=True, array=True):
    from . import npx

    npx.set_np(shape=shape, array=array)


def reset_np():
    from . import npx

    npx.reset_np()


def is_np_array():
    from . import npx

    return npx.is_np_array()


def is_np_shape():
    """The array mode's flag: zero-size and scalar shapes are always
    allowed here, so the shape mode follows the array mode, as in the JAX
    package."""
    return is_np_array()


class _NpScope:
    """A context manager and decorator that sets numpy mode inside and
    restores it after (ref: util.py np_array/np_shape)."""

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = is_np_array()
        set_np() if self._active else reset_np()
        return self

    def __exit__(self, *exc):
        set_np() if self._prev else reset_np()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _NpScope(self._active):
                return fn(*args, **kwargs)

        return wrapped


def np_array(active=True):
    return _NpScope(active)


def np_shape(active=True):
    return _NpScope(active)


def use_np_array(fn):
    """Decorator: run ``fn`` in numpy-array mode (ref:
    util.py:use_np_array)."""
    return _NpScope(True)(fn)


def use_np_shape(fn):
    return _NpScope(True)(fn)


def use_np(fn):
    """Decorator: numpy shape and array semantics (ref: util.py:use_np). On
    a class, every plain method (``__init__`` and ``__call__`` too) and
    every static and class method runs in the scope."""
    import inspect

    if isinstance(fn, type):
        for attr, v in list(vars(fn).items()):
            if inspect.isfunction(v) and (not attr.startswith("__")
                                          or attr in ("__init__", "__call__")):
                setattr(fn, attr, _NpScope(True)(v))
            elif isinstance(v, staticmethod):
                setattr(fn, attr, staticmethod(_NpScope(True)(v.__func__)))
            elif isinstance(v, classmethod):
                setattr(fn, attr, classmethod(_NpScope(True)(v.__func__)))
        return fn
    return _NpScope(True)(fn)


def load_npz_exact(filename):
    """dict[name → CPU tensor] with the exact dtypes restored. A legacy file
    that stored bfloat16 without a sidecar (numpy reads it as 2-byte void)
    is read as bfloat16, as the JAX package does."""
    raw = dict(np.load(filename, allow_pickle=False))
    dtypes = {}
    for k in [k for k in raw if k.startswith(_NPZ_DTYPE_PREFIX)]:
        dtypes[k[len(_NPZ_DTYPE_PREFIX):]] = str(raw.pop(k))
    out = {}
    for k, v in raw.items():
        name = dtypes.get(k)
        if name is None and v.dtype.kind == "V" and v.dtype.itemsize == 2:
            name = "bfloat16"
        if name is None:
            out[k] = torch.from_numpy(np.array(v, copy=True))
        elif name in _BITS_DTYPES:
            out[k] = _from_bits(v, name)
        else:
            raise TypeError("entry %r has unsupported dtype %r" % (k, name))
    return out


def tree_leaves(tree, like=None):
    """The leaves of a nested structure of tensors in ``jax.tree_util``
    order (dict values by sorted key, list and tuple items in order), cut
    at the leaves of ``like`` (default: ``tree`` itself): with ``like`` a
    tree of parameters and ``tree`` their optimizer states, each
    parameter's whole state is one leaf."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in tree_leaves(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for t, s in zip(tree, like) for x in tree_leaves(t, s)]
    return [tree]


def map_state(state, fn):
    """``state`` (nested tuples, lists and dicts of tensors) with ``fn``
    applied to each tensor."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: map_state(v, fn) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(map_state(v, fn) for v in state)
    return state
