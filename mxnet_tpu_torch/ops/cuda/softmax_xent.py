"""Softmax cross-entropy: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/softmax_xent.py`` ``softmax_xent``:
the per-row NLL of int labels under softmax(logits), fp32 whatever the
logits' dtype, with a backward that reuses the forward's saved logsumexp.
The kernels are ``mxnet_tpu_torch/csrc/softmax_xent.cu`` (why they are
shaped as they are, and what bounds them, is written there): any V, fp32 or
bf16 logits, no padding of V, rows at any stride of at least V (a padded
vocabulary sliced to V is read where it lies, not copied).

:func:`softmax_xent_fwd` and :func:`softmax_xent_bwd` call the ops
``mxnet_tpu_torch::xent_fwd`` and ``::xent_bwd``, which take the plain
version for CPU tensors and launch the kernel for CUDA tensors, or raise;
they never fall back from the card to the plain version. :func:`softmax_xent`
is the differentiable op (the forward op with an autograd formula mirroring
the JAX ``custom_vjp``): its forward saves the fp32 lse, its backward calls
the backward op.
"""
from __future__ import annotations

import torch

from . import (IMPLS, _build, fake_check, implementation,
               no_second_order)

DTYPES = (torch.float32, torch.bfloat16)


def _picked(xf, labels):
    """x[r, labels[r]] in fp32, 0 where the label is outside [0, V) (the
    TPU kernel's iota compare matches no column there)."""
    V = xf.shape[1]
    lab = labels.to(torch.int64)
    inside = (lab >= 0) & (lab < V)
    got = xf.gather(1, lab.clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(inside, got, 0.0)


def softmax_xent_fwd_plain(x, labels):
    """The forward kernel's arithmetic in PyTorch: fp32 row max, lse =
    log(sum exp(x - max)) + max, loss = lse - x[label]. Returns (loss, lse),
    both (R,) float32."""
    xf = x.float()
    m = xf.amax(dim=1, keepdim=True)
    lse = (torch.log(torch.exp(xf - m).sum(dim=1, keepdim=True)) + m)[:, 0]
    return lse - _picked(xf, labels), lse


def softmax_xent_bwd_plain(x, labels, lse, dy):
    """The backward kernel's arithmetic in PyTorch: (exp(x - lse) - onehot)
    * dy in fp32, cast to x's dtype."""
    xf = x.float()
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols[None, :] == labels.to(torch.int64)[:, None]).float()
    return ((torch.exp(xf - lse[:, None]) - onehot) * dy[:, None]).to(x.dtype)


def _check(x, labels):
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError("softmax-xent kernel takes logits of shape (R, V), "
                         "V >= 1, got %s" % (tuple(x.shape),))
    if x.dtype not in DTYPES:
        raise TypeError("softmax-xent kernel takes %s logits, got %s"
                        % (DTYPES, x.dtype))
    R, V = x.shape
    if (V > 1 and x.stride(1) != 1) or (R > 1 and x.stride(0) < V):
        raise ValueError("softmax-xent kernel takes logits whose rows are "
                         "contiguous and do not overlap, got strides %s"
                         % (x.stride(),))
    if x.shape[1] >= 2 ** 31:
        raise ValueError("softmax-xent kernel takes V < 2**31")
    if tuple(labels.shape) != (x.shape[0],) or labels.dtype != torch.int32:
        raise ValueError("softmax-xent kernel takes int32 labels of shape "
                         "(%d,), got %s %s" % (x.shape[0], labels.dtype,
                                               tuple(labels.shape)))
    if labels.device != x.device:
        raise ValueError("labels are on %s, logits on %s"
                         % (labels.device, x.device))


def _on_card(x):
    if x.device.type != "cuda":
        raise ValueError("softmax-xent: no kernel for device %s" % x.device)


def softmax_xent_fwd(x, labels):
    """(loss, lse) of logits x (R, V) under int32 labels (R,), both (R,)
    float32."""
    return _xent_fwd_op(x, labels)


@implementation("softmax_xent_fwd")
def _xent_fwd(x, labels):
    if x.device.type == "cpu":
        return softmax_xent_fwd_plain(x, labels)
    _on_card(x)
    _check(x, labels)
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lse = torch.empty_like(loss)
    _build.extension().xent_fwd(
        x, labels, loss, lse, torch.cuda.current_stream(x.device).cuda_stream)
    softmax_xent_fwd.launches += 1
    return loss, lse


def softmax_xent_bwd(x, labels, lse, dy):
    """dx (R, V), contiguous, in x's dtype from the logits, labels, the
    forward's lse and the loss gradient dy (R,) float32. The kernel's
    output carries no graph; a CPU call under ``create_graph`` runs the
    plain version's torch ops, which do."""
    if torch.is_grad_enabled() and x.device.type == "cpu":
        return IMPLS["softmax_xent_bwd"](x, labels, lse, dy)
    with torch.no_grad():
        return _xent_bwd_op(x, labels, lse, dy)


@implementation("softmax_xent_bwd")
def _xent_bwd(x, labels, lse, dy):
    if x.device.type == "cpu":
        return softmax_xent_bwd_plain(x, labels, lse, dy)
    _on_card(x)
    _check(x, labels)
    for name, t in (("lse", lse), ("dy", dy)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0],)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError("softmax-xent backward takes a contiguous "
                             "float32 %s of shape (%d,) on %s"
                             % (name, x.shape[0], x.device))
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _build.extension().xent_bwd(
        x, labels, lse, dy, dx,
        torch.cuda.current_stream(x.device).cuda_stream)
    softmax_xent_bwd.launches += 1
    return dx


softmax_xent_fwd.launches = 0  # kernel launches since the last reset
softmax_xent_bwd.launches = 0


@torch.library.custom_op("mxnet_tpu_torch::xent_fwd", mutates_args=())
def _xent_fwd_op(x: torch.Tensor, labels: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(IMPLS["softmax_xent_fwd"](x, labels))


@_xent_fwd_op.register_fake
def _(x, labels):
    fake_check("softmax-xent", x)
    R = x.shape[0]
    return (x.new_empty((R,), dtype=torch.float32),
            x.new_empty((R,), dtype=torch.float32))


@torch.library.custom_op("mxnet_tpu_torch::xent_bwd", mutates_args=())
def _xent_bwd_op(x: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                 dy: torch.Tensor) -> torch.Tensor:
    return IMPLS["softmax_xent_bwd"](x, labels, lse, dy)


@_xent_bwd_op.register_fake
def _(x, labels, lse, dy):
    fake_check("softmax-xent backward", x)
    return x.new_empty(x.shape)


def _xent_setup(ctx, inputs, output):
    x, labels = inputs
    ctx.save_for_backward(x, labels, output[1])
    ctx.mark_non_differentiable(output[1])


def _xent_backward(ctx, dloss, dlse):
    x, labels, lse = ctx.saved_tensors
    dy = dloss.to(torch.float32).contiguous()
    if torch.is_grad_enabled():  # autograd.grad(create_graph=True)
        no_second_order("softmax_xent_bwd", x)
        # the saved lse carries no graph: recompute it from x
        lse = torch.logsumexp(x.float(), dim=-1)
        return softmax_xent_bwd_plain(x, labels, lse, dy), None
    return _xent_bwd_op(x, labels, lse, dy), None


_xent_fwd_op.register_autograd(_xent_backward, setup_context=_xent_setup)


def softmax_xent(logits, labels):
    """Per-row NLL (R,) float32 of int labels (R,) under softmax(logits
    (R, V)); differentiable in ``logits``. The logits are handed on as they
    are, never copied (a copy of a language model's logits is another
    0.8 GB): the kernels read rows at the view's own row stride, and a view
    whose columns are strided raises in the kernel's check."""
    return _xent_fwd_op(logits, labels.to(torch.int32).contiguous())[0]
