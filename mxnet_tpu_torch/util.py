"""Checkpoint arrays in the JAX package's exact npz format.

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
