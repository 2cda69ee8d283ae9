"""Flash-attention forward: the CUDA kernel and its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py`` ``_flash_fwd``,
with all its flags: ``causal``, a per-example valid key length
``kv_valid_len`` (tiles past it are skipped), and the optional per-row
logsumexp. The kernel is ``mxnet_tpu_torch/csrc/flash_attention_fwd.cu``
(why it is shaped as it is, and what bounds it, is written there): bf16 q, k,
v with fp32 accumulation, head dim 64 or 128, any sequence length.

:func:`flash_attention` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises; it never falls back from the card to
the plain version. Layouts are the JAX function's: q (B, H, Tq, D), k and v
(B, H, Tk, D), lse (B*H, Tq, 1) float32.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's template instances


def flash_attention_plain(q, k, v, kv_valid_len=None, scale=None,
                          causal=False, return_lse=False):
    """The kernel's arithmetic in PyTorch, with flash semantics: scores in
    fp32 from the operands' products, masked keys dropped, p cast to v's
    dtype for the second product, and a row with no valid key (vl = 0) gives
    exact zeros and lse -1e30, as the TPU kernel does."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    cols = torch.arange(Tk, device=q.device)
    keep = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(Tq, device=q.device)
        keep = keep & (rows[:, None] >= cols[None, :])
    if kv_valid_len is not None:
        keep = keep & (cols < kv_valid_len.reshape(B, 1, 1, 1))
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (out / torch.clamp(l, min=1e-30)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      NEG_INF)
    return out, lse.reshape(B * H, Tq, 1)


def _check(q, k, v, kv_valid_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash kernel takes 4-D q, k, v (B, H, T, D)")
    B, H, Tq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError("flash kernel: q %s, k %s, v %s do not agree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if D not in HEAD_DIMS:
        raise ValueError("flash kernel takes head dim in %s, got %d"
                         % (HEAD_DIMS, D))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError("flash kernel takes bfloat16 %s, got %s"
                            % (name, t.dtype))
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s" % (name, t.device, q.device))
        if not t.is_contiguous():
            raise ValueError("flash kernel takes a contiguous %s" % name)
    if B * H >= 65536:
        raise ValueError("flash kernel grid limit: B*H < 65536")
    if kv_valid_len is not None:
        if tuple(kv_valid_len.shape) != (B,):
            raise ValueError("kv_valid_len must have shape (%d,), got %s"
                             % (B, tuple(kv_valid_len.shape)))
        if kv_valid_len.device != q.device:
            raise ValueError("kv_valid_len is on %s, q on %s"
                             % (kv_valid_len.device, q.device))


def flash_attention(q, k, v, causal=False, scale=None, kv_valid_len=None,
                    return_lse=False):
    """Attention of q over k, v; see the module docstring. Returns the
    output (B, H, Tq, D) in q's dtype, and with ``return_lse`` also the
    logsumexp (B*H, Tq, 1) float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid_len, scale, causal,
                                     return_lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: no kernel for device %s" % q.device)
    _check(q, k, v, kv_valid_len)
    B, H, Tq, _ = q.shape
    vl = None if kv_valid_len is None else \
        kv_valid_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq, 1), dtype=torch.float32, device=q.device) \
        if return_lse else None
    _build.extension().flash_fwd(
        q, k, v, vl, out, lse, H, float(scale), bool(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches since the last reset
