"""Flash attention: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: the forward
``_flash_fwd`` and the backward ``_flash_bwd`` (its dq and dk/dv kernels,
one fused kernel here), with all their flags: ``causal``, a per-example
valid key length ``kv_valid_len`` (tiles past it are skipped), and the
per-row logsumexp the backward recomputes P from. The kernels are
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` (why they are shaped as they are, and what bounds
them, is written there): bf16 q, k, v with fp32 accumulation, head dim 64 or
128, any sequence length.

:func:`flash_attention` and :func:`flash_attention_bwd` take the plain
version for CPU tensors and launch the kernel for CUDA tensors, or raise;
they never fall back from the card to the plain version.
:func:`flash_attention_with_grad` is the differentiable op (a
``torch.autograd.Function`` mirroring the JAX ``custom_vjp``): its forward
keeps the lse, its backward forms delta = rowsum(dO * O) in PyTorch, as the
JAX package does outside its kernels, and launches the backward kernel.
Layouts are the JAX function's: q (B, H, Tq, D), k and v (B, H, Tk, D), lse
(B*H, Tq, 1) float32, delta (B, H, Tq) float32.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's template instances


def _scores_plain(q, k, kv_valid_len, scale, causal):
    """fp32 scores scale * q k^T and the (B, 1|H, Tq, Tk) mask of the kept
    ones: the TPU kernels' shared ``_scores``."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    cols = torch.arange(Tk, device=q.device)
    keep = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(Tq, device=q.device)
        keep = keep & (rows[:, None] >= cols[None, :])
    if kv_valid_len is not None:
        keep = keep & (cols < kv_valid_len.reshape(B, 1, 1, 1))
    return s, keep


def flash_attention_plain(q, k, v, kv_valid_len=None, scale=None,
                          causal=False, return_lse=False):
    """The kernel's arithmetic in PyTorch, with flash semantics: scores in
    fp32 from the operands' products, masked keys dropped, p cast to v's
    dtype for the second product, and a row with no valid key (vl = 0) gives
    exact zeros and lse -1e30, as the TPU kernel does."""
    B, H, Tq, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s, keep = _scores_plain(q, k, kv_valid_len, scale, causal)
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


def flash_p_ds_plain(q, k, v, do, lse, delta, kv_valid_len, scale,
                     causal):
    """P rebuilt from the saved lse (0 where masked, also on a vl = 0 row
    whose lse is -1e30) and ds = P * (dO v^T - delta), both fp32."""
    B, H, Tq, _ = q.shape
    s, keep = _scores_plain(q, k, kv_valid_len, scale, causal)
    p = torch.where(keep, torch.exp(s - lse.reshape(B, H, Tq, 1)), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.reshape(B, H, Tq, 1))


def flash_attention_dq_plain(q, k, v, do, lse, delta, kv_valid_len=None,
                             scale=None, causal=False):
    """The dq kernel's arithmetic in PyTorch: ds cast to k's dtype once,
    then dq = (ds k) * scale in fp32, cast to q's dtype (the TPU kernel's
    ``_dq_kernel``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = flash_p_ds_plain(q, k, v, do, lse, delta, kv_valid_len, scale,
                             causal)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, kv_valid_len=None,
                              scale=None, causal=False):
    """The dk/dv kernel's arithmetic in PyTorch: dv = p^T dO with p cast to
    dO's dtype, dk = (ds^T q) * scale with ds cast to q's dtype, fp32 sums,
    cast to k's and v's dtypes (the TPU kernel's ``_dkv_kernel``). Keys past
    the valid length get exact zeros."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = flash_p_ds_plain(q, k, v, do, lse, delta, kv_valid_len, scale,
                             causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


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


def _check_bwd(q, k, v, do, lse, delta, kv_valid_len):
    _check(q, k, v, kv_valid_len)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("flash backward takes a contiguous %s dO of shape %s"
                         % (q.dtype, tuple(q.shape)))
    rows = q.shape[0] * q.shape[1] * q.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.numel() != rows
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("flash backward takes a contiguous float32 %s "
                             "of B*H*Tq = %d rows on %s" % (name, rows,
                                                            q.device))
    if do.device != q.device:
        raise ValueError("dO is on %s, q on %s" % (do.device, q.device))


def _valid_len(kv_valid_len):
    return None if kv_valid_len is None else \
        kv_valid_len.to(torch.int32).contiguous()


def flash_attention_bwd_plain(q, k, v, do, lse, delta, kv_valid_len=None,
                              scale=None, causal=False):
    """(dq, dk, dv) from the dq and dk/dv plain versions: the backward
    kernel's arithmetic in PyTorch."""
    dq = flash_attention_dq_plain(q, k, v, do, lse, delta, kv_valid_len,
                                  scale, causal)
    dk, dv = flash_attention_dkv_plain(q, k, v, do, lse, delta, kv_valid_len,
                                       scale, causal)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, kv_valid_len=None,
                        scale=None, causal=False):
    """(dq, dk, dv), in the dtypes and shapes of q, k and v, from the
    forward's inputs, dO, its lse and delta = rowsum(dO * O). On the card
    one kernel computes all three, adding dq's fp32 partial sums into a
    zeroed workspace (so dq is not bit-reproducible from run to run), and a
    second pass rounds dq to bf16."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         kv_valid_len, scale, causal)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd: no kernel for device %s"
                         % q.device)
    _check_bwd(q, k, v, do, lse, delta, kv_valid_len)
    B, H, Tq, D = q.shape
    ext = _build.extension()
    dq_acc = torch.zeros(ext.flash_bwd_workspace(B * H, Tq, D),
                         dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ext.flash_bwd(
        q, k, v, do, lse, delta, _valid_len(kv_valid_len), dq_acc, dq, dk, dv,
        H, float(scale), bool(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_valid_len, scale, causal):
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                 kv_valid_len=kv_valid_len, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, kv_valid_len)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, vl = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (o.float() * do.float()).sum(dim=-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta,
                                         kv_valid_len=vl, scale=ctx.scale,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_with_grad(q, k, v, causal=False, scale=None,
                              kv_valid_len=None):
    """:func:`flash_attention`, differentiable in q, k and v: the forward
    launches with the lse, the backward launches the backward kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, _valid_len(kv_valid_len),
                                 float(scale), bool(causal))
