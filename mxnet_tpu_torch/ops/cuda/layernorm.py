"""Row LayerNorm: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/layernorm.py``: the forward
``fused_layernorm`` (kernel ``mxnet_tpu_torch/csrc/layernorm.cu``) and the
analytic backward ``_ln_bwd``, which is XLA outside any Pallas kernel there
and a kernel here (``csrc/layernorm_bwd.cu``); why each is shaped as it is,
and what bounds it, is written in its source. :func:`fused_layernorm` and
:func:`fused_layernorm_bwd` call the ops ``mxnet_tpu_torch::layernorm_fwd``
and ``::layernorm_bwd``, which take the plain version for a CPU tensor and
launch the kernel for a CUDA tensor, or raise; they never fall back from the
card to the plain version.

:func:`layernorm` is the differentiable op (the JAX ``layernorm``
``custom_vjp``): the forward op with the backward op as its registered
autograd formula.
"""
from __future__ import annotations

import torch

from . import (IMPLS, _build, fake_check, implementation,
               no_second_order)

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


def _check(x, **params):
    """x (R, C), C > 0, contiguous, of a kernel dtype; each of ``params``
    (C,) on x's device."""
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError("layernorm kernel takes x of shape (R, C), C > 0, "
                         "got %s" % (tuple(x.shape),))
    if x.dtype not in DTYPES:
        raise TypeError("layernorm kernel takes %s, got %s" % (DTYPES, x.dtype))
    C = x.shape[1]
    for name, t in params.items():
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
    return _layernorm_fwd_op(x, gamma, beta, float(eps))


@implementation("fused_layernorm")
def _layernorm_fwd(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError("layernorm: no kernel for device %s" % x.device)
    _check(x, gamma=gamma, beta=beta)
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    _build.extension().layernorm_fwd(
        x, gamma, beta, y, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0  # kernel launches since the last reset


def layernorm_bwd_plain(x, gamma, dy, eps):
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


def fused_layernorm_bwd(x, gamma, dy, eps=1e-5):
    """(dx, dgamma, dbeta) of the LayerNorm of x (R, C) with gamma (C,) for
    the output gradient dy (R, C): dx in x's dtype, dgamma and dbeta in
    gamma's. On the card dgamma and dbeta are summed in a fixed order, so
    two calls on the same inputs give bit-equal results. The kernel's
    outputs carry no graph; a CPU call under ``create_graph`` runs the plain
    version's torch ops, which do."""
    if torch.is_grad_enabled() and x.device.type == "cpu":
        return IMPLS["fused_layernorm_bwd"](x, gamma, dy, float(eps))
    with torch.no_grad():
        return _layernorm_bwd_op(x, gamma, dy, float(eps))


@implementation("fused_layernorm_bwd")
def _layernorm_bwd(x, gamma, dy, eps):
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, gamma, dy, eps)
    if x.device.type != "cuda":
        raise ValueError("layernorm_bwd: no kernel for device %s" % x.device)
    _check(x, gamma=gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("layernorm_bwd: dy %s %s on %s, x %s %s on %s" % (
            tuple(dy.shape), dy.dtype, dy.device, tuple(x.shape), x.dtype,
            x.device))
    R, C = x.shape
    ext = _build.extension()
    parts = ext.layernorm_bwd_parts(
        R, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((parts, 2, C), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dg = torch.empty(C, dtype=torch.float32, device=x.device)
    db = torch.empty(C, dtype=torch.float32, device=x.device)
    ext.layernorm_bwd(x, gamma.to(torch.float32).contiguous(), dy.contiguous(),
                      dx, part, dg, db, float(eps),
                      torch.cuda.current_stream(x.device).cuda_stream)
    fused_layernorm_bwd.launches += 1
    return dx, dg.to(gamma.dtype), db.to(gamma.dtype)


fused_layernorm_bwd.launches = 0  # kernel launches since the last reset


@torch.library.custom_op("mxnet_tpu_torch::layernorm_fwd", mutates_args=())
def _layernorm_fwd_op(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float) -> torch.Tensor:
    return IMPLS["fused_layernorm"](x, gamma, beta, eps)


@_layernorm_fwd_op.register_fake
def _(x, gamma, beta, eps):
    fake_check("layernorm", x)
    return torch.empty_like(x)


@torch.library.custom_op("mxnet_tpu_torch::layernorm_bwd", mutates_args=())
def _layernorm_bwd_op(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    return tuple(IMPLS["fused_layernorm_bwd"](x, gamma, dy, eps))


@_layernorm_bwd_op.register_fake
def _(x, gamma, dy, eps):
    fake_check("layernorm_bwd", x)
    C = x.shape[-1]
    return (torch.empty_like(x), gamma.new_empty((C,)),
            gamma.new_empty((C,)))


def _ln_setup(ctx, inputs, output):
    x, gamma, _, eps = inputs
    ctx.save_for_backward(x, gamma)
    ctx.eps = eps


def _ln_backward(ctx, dy):
    x, gamma = ctx.saved_tensors
    if torch.is_grad_enabled():  # autograd.grad(create_graph=True)
        no_second_order("layernorm_bwd", x)
        return (*layernorm_bwd_plain(x, gamma, dy, ctx.eps), None)
    if torch.compiler.is_compiling():  # compiled autograd: no range
        return (*_layernorm_bwd_op(x, gamma, dy.contiguous(), ctx.eps),
                None)
    # a profiler range: the backward's host time. Its kernels come from
    # the extension, not from torch ops, so the range holds no device
    # time; a trace reads that from the kernels' names (layernorm_bwd_)
    with torch.profiler.record_function("mxnet_tpu_torch::layernorm_bwd"):
        dx, dg, db = _layernorm_bwd_op(x, gamma, dy.contiguous(), ctx.eps)
    return dx, dg, db, None


_layernorm_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup)


def layernorm(x, gamma, beta, eps=1e-5):
    """:func:`fused_layernorm`, differentiable in x, gamma and beta."""
    return _layernorm_fwd_op(x, gamma, beta, float(eps))
