"""Ulysses sequence parallelism (DeepSpeed-Ulysses; counterpart of
``mxnet_tpu/parallel/ulysses.py``): an all-to-all from a sequence split to
a head split, attention on whole sequences, and the all-to-all back.

Per rank on an ``sp`` axis of size n:

- in: q/k/v (B, H, T/n, D), the sequence split, all heads here;
- all-to-all: (B, H/n, T, D), the heads split, the whole sequence here;
- attention through the port's seam (``ops.attention.local_attention``:
  the flash kernels at T >= ``FLASH_MIN_LEN`` in bf16);
- all-to-all back: (B, H, T/n, D).

Two all-to-alls a call (``distributed.all_to_all``: heads split, the
sequence gathered, and back), the layouts of the JAX package's
``_a2a_heads_to_seq`` and ``_a2a_seq_to_heads``; each one's backward is
the other.
"""
from __future__ import annotations

import math

__all__ = ["ulysses_attention"]


def ulysses_attention(q, k, v, mesh, axis_name="sp", causal=False,
                      scale=None, batch_axis=None):
    """q, k, v: this rank's blocks (B, H, T/n, D) of a sequence split over
    ``axis_name``; needs H % n == 0. Returns this rank's block of the
    output. Differentiable: each all-to-all's backward is the inverse
    all-to-all. ``batch_axis`` names the axis the batch is split over as
    well (dp x sp): the blocks are already this rank's batch block and
    the all-to-alls run over its own ``axis_name`` group."""
    from ..ops.attention import local_attention
    from .distributed import all_to_all, check_device

    check_device(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = int(mesh.shape[axis_name])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape[1] % n:
            raise ValueError(
                "ulysses_attention: %s=%d (%s heads) is not divisible by "
                "the %r mesh axis (%d) — use ring_attention when the axis "
                "does not divide the head count"
                % (name, t.shape[1], name, axis_name, n))
    # (B, H, T/n, D) -> (B, H/n, T, D): head group j to rank j, the
    # sequence blocks in source order; the kernels take contiguous heads
    q, k, v = (all_to_all(t, mesh, axis_name, 1, 2).contiguous()
               for t in (q, k, v))
    o = local_attention(q, k, v, causal=causal, scale=scale)
    return all_to_all(o, mesh, axis_name, 2, 1)
