"""Row LayerNorm: the CUDA kernel and its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/layernorm.py`` ``fused_layernorm``.
The kernel is ``mxnet_tpu_torch/csrc/layernorm.cu`` (why it is shaped as it
is, and what bounds it, is written there). :func:`fused_layernorm` takes the
plain version for a CPU tensor and launches the kernel for a CUDA tensor, or
raises; it never falls back from the card to the plain version.
"""
from __future__ import annotations

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)


def layernorm_plain(x, gamma, beta, eps=1e-5):
    """The kernel's arithmetic in PyTorch: fp32 mean, fp32 variance of the
    centred rows, rsqrt(var + eps), affine, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def _check(x, gamma, beta):
    if x.dim() != 2:
        raise ValueError("layernorm kernel takes x of shape (R, C), got %s"
                         % (tuple(x.shape),))
    if x.dtype not in DTYPES:
        raise TypeError("layernorm kernel takes %s, got %s" % (DTYPES, x.dtype))
    C = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.device != x.device:
            raise ValueError("%s is on %s, x on %s" % (name, t.device, x.device))
        if tuple(t.shape) != (C,):
            raise ValueError("%s must have shape (%d,), got %s"
                             % (name, C, tuple(t.shape)))
    if not x.is_contiguous():
        raise ValueError("layernorm kernel takes a contiguous x")
    if C >= 2 ** 31:
        raise ValueError("layernorm kernel takes C < 2**31")


def fused_layernorm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of x (R, C) with gamma/beta (C,)."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError("layernorm: no kernel for device %s" % x.device)
    _check(x, gamma, beta)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    _build.extension().layernorm_fwd(
        x, gamma, beta, y, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0  # kernel launches since the last reset
