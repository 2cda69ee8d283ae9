"""Row LayerNorm: the CUDA kernel and its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas/layernorm.py`` ``fused_layernorm``.
The kernel is ``mxnet_tpu_torch/csrc/layernorm.cu`` (why it is shaped as it
is, and what bounds it, is written there). :func:`fused_layernorm` takes the
plain version for a CPU tensor and launches the kernel for a CUDA tensor, or
raises; it never falls back from the card to the plain version.

:func:`layernorm` is the differentiable op (the JAX ``layernorm``
``custom_vjp``): the kernel forward, and the JAX package's analytic backward
``_ln_bwd``, which is XLA outside any Pallas kernel there and PyTorch ops
here (:func:`layernorm_bwd`).
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


def layernorm_bwd(x, gamma, dy, eps):
    """The JAX package's ``_ln_bwd`` in PyTorch: fp32 statistics recomputed
    from x, dx in x's dtype, dgamma and dbeta (sums over rows) in gamma's
    dtype."""
    xf = x.float()
    dyf = dy.float()
    gf = gamma.float()
    m = xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xf - m).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - m) * inv
    dg = (dyf * xhat).sum(dim=0)
    db = dyf.sum(dim=0)
    t = dyf * gf
    dx = inv * (t - t.mean(dim=-1, keepdim=True)
                - xhat * (t * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dg.to(gamma.dtype), db.to(gamma.dtype)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return fused_layernorm(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        # a profiler range, so a trace can sum this backward's kernels
        with torch.profiler.record_function("mxnet_tpu_torch::layernorm_bwd"):
            dx, dg, db = layernorm_bwd(x, gamma, dy, ctx.eps)
        return dx, dg, db, None


def layernorm(x, gamma, beta, eps=1e-5):
    """:func:`fused_layernorm`, differentiable in x, gamma and beta."""
    return _LayerNorm.apply(x, gamma, beta, eps)
