"""Functional ops BERT inference needs (counterpart of
``mxnet_tpu/ops/functional.py``), as eager PyTorch.

``hybrid_forward(F, ...)`` receives this module as ``F``. Each op keeps the
JAX op's name, arguments and dtype rules. The dense products go to
``torch.matmul``, as the JAX package left them to XLA; LayerNorm goes to the
port's CUDA kernel for CUDA tensors (``ops/cuda/layernorm.py``), and the
attention seam lives in ``ops/attention.py``.
"""
from __future__ import annotations

import torch

from ..base import register_op, resolve_device, resolve_dtype
from .attention import scaled_dot_attention  # noqa: F401  (F.scaled_dot_attention)
from .cuda.layernorm import fused_layernorm


@register_op("FullyConnected")
def FullyConnected(x, weight, bias=None, *, num_hidden=None, no_bias=False,
                   flatten=True):
    """y = x @ W^T + b with weight (num_hidden, in), computed in x's dtype;
    an fp32 bias is cast to y's dtype so it does not widen a bf16 y."""
    if num_hidden is not None and weight.shape[0] != num_hidden:
        raise ValueError("FullyConnected: weight rows %d != num_hidden %d"
                         % (weight.shape[0], num_hidden))
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None and not no_bias:
        y = y + bias.to(y.dtype)
    return y


@register_op("Embedding")
def Embedding(indices, weight, *, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    flat = indices.reshape(-1).to(torch.int64)
    return weight.index_select(0, flat).reshape(
        tuple(indices.shape) + (weight.shape[1],))


@register_op("LayerNorm")
def LayerNorm(x, gamma, beta, *, axis=-1, eps=1e-5):
    """LayerNorm with fp32 statistics and one cast back to x's dtype, through
    the kernel wrapper, which launches the CUDA kernel for a CUDA tensor (or
    raises) and takes its plain version only for a CPU tensor. Another axis
    than the last is moved last for the call."""
    if gamma.dim() != 1:
        raise ValueError("LayerNorm takes 1-D gamma/beta, got %s"
                         % (tuple(gamma.shape),))
    xt = x.movedim(axis, -1)
    C = xt.shape[-1]
    y = fused_layernorm(xt.reshape(-1, C).contiguous(), gamma, beta, eps)
    return y.reshape(xt.shape).movedim(-1, axis)


@register_op("Dropout")
def Dropout(x, *, p=0.5, training=False, mode="training"):
    """Identity: the port serves in eval mode only (training is the next
    slice)."""
    if training and p > 0.0:
        raise NotImplementedError("training-mode dropout is not ported yet")
    return x


@register_op("Activation")
def Activation(x, *, act_type):
    """The activations BERT uses: tanh (pooler) and exact-erf gelu (FFN)."""
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "gelu":  # exact erf form, as jax.nn.gelu(approximate=False)
        return torch.nn.functional.gelu(x)
    raise ValueError("act_type %r is not ported yet" % act_type)


@register_op("reshape")
def reshape(x, *, shape):
    return x.reshape(tuple(shape))


@register_op("transpose")
def transpose(x, *, axes=None):
    if axes is None:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register_op("slice_axis")
def slice_axis(x, *, axis, begin, end):
    axis = axis % x.dim()
    if end is None:
        end = x.shape[axis]
    return x.narrow(axis, begin, end - begin)


@register_op("squeeze")
def squeeze(x, *, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


@register_op("expand_dims")
def expand_dims(x, *, axis):
    return x.unsqueeze(axis)


@register_op("take")
def take(a, indices, *, axis=0):
    flat = indices.reshape(-1).to(torch.int64)
    out = a.index_select(axis, flat)
    shape = list(a.shape)
    shape[axis:axis + 1] = list(indices.shape)
    return out.reshape(shape)


@register_op("arange")
def arange(start, stop=None, step=1.0, *, dtype="float32", ctx=None):
    """MXNet's arange, with ``ctx`` naming the device (default: the
    current CUDA device, as every entry point)."""
    return torch.arange(start, stop, step, dtype=resolve_dtype(dtype),
                        device=resolve_device(ctx))


@register_op("lesser")
def lesser(a, b):
    """Elementwise a < b as 0/1 in a's dtype (MXNet's comparison ops)."""
    return (a < b).to(a.dtype)


@register_op("dot")
def dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    return torch.matmul(a, b)


@register_op("cast")
def cast(x, *, dtype):
    return x.to(resolve_dtype(dtype))
