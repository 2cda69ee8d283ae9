"""Attention seam (counterpart of ``mxnet_tpu/ops/attention.py``).

Models call ``F.scaled_dot_attention``. It routes to the flash-attention
kernels (``ops/cuda/flash_attention.py``) when the sequence is long enough,
the mask is absent or a declared key-padding prefix, and the operands are
bfloat16 with a head dim the kernel takes; everything else takes the dense
path, which keeps the JAX package's ``_dense_attention_fwd`` numerics and
its hand-written backward ``_dense_attention_bwd``. When autograd records
(a grad-enabled call with an operand that requires grad), the flash path
takes the differentiable op, whose forward also writes the logsumexp;
otherwise, as in serving, it launches the forward alone.

``cache_write`` is the decode cache's write: it writes new K/V rows into
a preallocated fixed-capacity cache in place, so a decode step allocates
no KV page (the counterpart of the JAX package's buffer donation).

The flash threshold is the port's own. It starts at the JAX package's
static pre-sweep value, 256, so BERT at seq 512 goes through the kernel;
``chip_smoke.py`` times dense against flash at seq 128 and 512 on the card,
and the real crossover is to be set from those measurements.
"""
from __future__ import annotations

import math

import torch

from ..base import register_op
from .cuda.flash_attention import (HEAD_DIMS, flash_attention,
                                   flash_attention_with_grad)

FLASH_MIN_LEN = 256
FLASH_DTYPES = (torch.bfloat16,)


def _mask_bias(mask, causal, T, S, device):
    """Key-padding mask and causal triangle as one additive fp32 bias (0
    keep, -1e30 drop), or None."""
    bias = None
    if mask is not None:
        bias = torch.where(mask.to(torch.bool), 0.0, -1e30).to(
            device=device, dtype=torch.float32)
    if causal:
        rows = torch.arange(T, device=device)[:, None]
        cols = torch.arange(S, device=device)[None, :]
        cb = torch.where(rows >= cols, 0.0, -1e30)[None, None]
        bias = cb if bias is None else bias + cb
    return bias


class _DenseAttention(torch.autograd.Function):
    """The JAX package's ``_dense_attention_core`` with its hand-written
    VJP. Products take bf16 operands and accumulate in fp32 (here by
    upcasting the operands: a product of two bf16 values is exact in
    fp32)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        # scale applies to the fp32 logits; softmax in fp32; p cast to v's
        # dtype before the second product
        s = scale * torch.matmul(q.float(), k.float().transpose(-1, -2))
        if bias is not None:
            s = s + bias
        pb = torch.softmax(s, dim=-1).to(v.dtype)
        ctx.save_for_backward(q, k, v, pb)
        ctx.scale = scale
        return torch.matmul(pb.float(), v.float()).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        # softmax-grad math in fp32, then one cast of ds * scale down to q's
        # dtype before the dq and dk products; p stays in v's dtype for dv
        q, k, v, pb = ctx.saved_tensors
        do = do.to(v.dtype).float()
        pf = pb.float()
        dv = torch.matmul(pf.transpose(-1, -2), do).to(v.dtype)
        dp = torch.matmul(do, v.float().transpose(-1, -2))
        ds = pf * (dp - (dp * pf).sum(dim=-1, keepdim=True))
        dsb = (ds * ctx.scale).to(q.dtype).float()
        dq = torch.matmul(dsb, k.float()).to(q.dtype)
        dk = torch.matmul(dsb.transpose(-1, -2), q.float()).to(k.dtype)
        return dq, dk, dv, None, None


def dense_attention(q, k, v, mask=None, causal=False, scale=None):
    """softmax(scale * q k^T + bias) v with the JAX package's dense numerics
    (:class:`_DenseAttention`), differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    bias = _mask_bias(mask, causal, q.shape[-2], k.shape[-2], q.device)
    return _DenseAttention.apply(q, k, v, bias, float(scale))


def _prefix_mask_to_valid_len(mask):
    """(B, ..., Tk) prefix key-padding mask → (B,) int32 valid lengths. A
    prefix mask is row-constant, so any one row's sum is the length."""
    rows = mask.reshape(mask.shape[0], -1, mask.shape[-1])[:, 0, :]
    return rows.to(torch.int32).sum(dim=-1, dtype=torch.int32)


def takes_flash(q, mask, prefix_mask):
    """The seam's routing rule (static: shapes, dtype and the caller's
    declaration, never the data)."""
    return (q.shape[2] >= FLASH_MIN_LEN and q.dtype in FLASH_DTYPES
            and q.shape[3] in HEAD_DIMS and (mask is None or prefix_mask))


@register_op("scaled_dot_attention")
def scaled_dot_attention(q, k, v, mask=None, *, causal=False, scale=None,
                         prefix_mask=False):
    """q, k, v: (B, H, T, D); mask broadcastable to (B, H, Tq, Tk), 1 = keep.

    ``prefix_mask=True`` declares that ``mask`` is a key-padding prefix
    (mask[b, ..., t] = t < valid_len[b]); then the flash path applies with
    the valid length recovered from the mask."""
    if takes_flash(q, mask, prefix_mask):
        vl = None if mask is None else _prefix_mask_to_valid_len(mask)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_with_grad(q, k, v, causal=causal,
                                             scale=scale, kv_valid_len=vl)
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_valid_len=vl)
    return dense_attention(q, k, v, mask, causal=causal, scale=scale)


@register_op("cache_write")
def cache_write(cache, update, index):
    """Write ``update`` (B, H, T, D) into the fixed-capacity KV cache
    ``cache`` (B, H, C, D) at time offset ``index`` along axis 2, in place,
    and return ``cache``.

    ``index`` is a scalar (an int or a 0-d tensor: every row at one
    offset, as prefill and the uniform decode loop write) or a per-row
    ``(B,)`` tensor (continuous batching: each slot at its own position).
    As ``lax.dynamic_update_slice`` under the JAX op, the start clamps to
    ``[0, C - T]``; a tensor index is clamped on its device, with no host
    read."""
    T, C = update.shape[2], cache.shape[2]
    update = update.to(cache.dtype)
    if not isinstance(index, torch.Tensor):
        start = min(max(int(index), 0), C - T)
        cache[:, :, start:start + T].copy_(update)
        return cache
    start = torch.clamp(index.to(device=cache.device, dtype=torch.int64),
                        0, C - T)
    pos = start.reshape(-1, 1) + torch.arange(T, device=cache.device)
    pos = pos.expand(cache.shape[0], T)  # a scalar start: every row
    B, H, _, D = cache.shape
    cache.scatter_(2, pos[:, None, :, None].expand(B, H, T, D), update)
    return cache
