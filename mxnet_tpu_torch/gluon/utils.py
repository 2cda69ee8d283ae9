"""``gluon.utils`` (counterpart of ``mxnet_tpu/gluon/utils.py``; ref:
python/mxnet/gluon/utils.py)."""
from __future__ import annotations

import hashlib
import math

import torch

from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; without
    ``even_split`` the last slice takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError("data size %d not divisible by %d"
                         % (size, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, slice i on ``ctx_list[i]``."""
    if not isinstance(data, NDArray):
        from ..ndarray import array

        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def _tensors(arrays):
    return [a._data if isinstance(a, NDArray) else a for a in arrays]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """(ref: gluon/utils.py:clip_global_norm) Scale every array by
    ``max_norm / (norm + 1e-8)`` when that is below 1, in place, and
    return the global L2 norm. Each array's sum of squares is taken in
    float32 on its device, as in the JAX package, and the sums added on
    the host in double: one host read in all. The arrays are scaled in
    place, so a ``Parameter``'s gradient (what the ``Trainer`` reads) is
    the scaled one."""
    ts = _tensors(arrays)
    with torch.no_grad():
        sums = [t.detach().to(torch.float32).square().sum() for t in ts]
        dev = sums[0].device
        total = 0.0
        for v in torch.stack([x.to(dev) for x in sums]).cpu().tolist():
            total += v  # the JAX package's order
        norm = math.sqrt(total)
        if check_isfinite and not math.isfinite(norm):
            return norm
        scale = max_norm / (norm + 1e-8)
        if scale < 1.0:
            for t in ts:
                t.mul_(scale)
    return norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise RuntimeError("network egress is disabled in this environment; "
                       "provide local files instead")
