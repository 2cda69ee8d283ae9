"""Attention seam (counterpart of ``mxnet_tpu/ops/attention.py``).

Models call ``F.scaled_dot_attention``. It routes to the flash-attention
kernels (``ops/cuda/flash_attention.py``) when the sequence is long enough,
the mask is absent or a declared key-padding prefix, the head dim is one
the kernels take, and the operands are bfloat16, or float32 when autograd
does not record (the forward kernel's fp32 form, which the quantized
models' fp32 activations take, has no backward); everything else takes the
dense path, which keeps the JAX package's ``_dense_attention_fwd`` numerics and
its hand-written backward ``_dense_attention_bwd``. When autograd records
(a grad-enabled call with an operand that requires grad), the flash path
takes the differentiable op, whose forward also writes the logsumexp;
otherwise, as in serving, it launches the forward alone.

``cache_write`` is the decode cache's write: it writes new K/V rows into
a preallocated fixed-capacity cache in place, so a decode step allocates
no KV page (the counterpart of the JAX package's buffer donation).
``quant_cache_write``, ``quant_cache_write_read`` and ``dequant_cache``
are its int8 counterparts for quantized pages with a running
per-page-per-head scale, also written in place.

The flash threshold is the port's own. It starts at the JAX package's
static pre-sweep value, 256, so BERT at seq 512 goes through the kernel;
``chip_smoke.py`` times dense against flash at seq 128 and 512 on the card,
and the real crossover is to be set from those measurements.
"""
from __future__ import annotations

import math
import threading

import torch

from ..base import cast_out, register_op
from .cuda.flash_attention import (HEAD_DIMS, flash_attention,
                                   flash_attention_with_grad)
from .lowbit import _const

FLASH_MIN_LEN = 256
FLASH_DTYPES = (torch.bfloat16, torch.float32)  # the forward's two forms
FLASH_GRAD_DTYPES = (torch.bfloat16,)            # the backward kernel's


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
        ctx.scale, ctx.bias = scale, bias
        return cast_out(torch.matmul(pb.float(), v.float()), q.dtype)

    @staticmethod
    def backward(ctx, do):
        # softmax-grad math in fp32, then one cast of ds * scale down to q's
        # dtype before the dq and dk products; p stays in v's dtype for dv
        q, k, v, pb = ctx.saved_tensors
        if torch.is_grad_enabled():  # autograd.grad(create_graph=True)
            # the saved p carries no graph: recompute it from q and k
            s = ctx.scale * torch.matmul(q.float(),
                                         k.float().transpose(-1, -2))
            if ctx.bias is not None:
                s = s + ctx.bias
            pb = torch.softmax(s, dim=-1).to(v.dtype)
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


def takes_flash(q, mask, prefix_mask, grad=False, length=None):
    """The seam's routing rule (static: shapes, dtype, whether autograd
    records and the caller's declaration, never the data). ``length``:
    the sequence's whole length when ``q`` is a block of it (sequence
    parallelism), default ``q``'s own."""
    dtypes = FLASH_GRAD_DTYPES if grad else FLASH_DTYPES
    T = q.shape[2] if length is None else length
    return (T >= FLASH_MIN_LEN and q.dtype in dtypes
            and q.shape[3] in HEAD_DIMS and (mask is None or prefix_mask))


_SP_SCOPE = threading.local()


class sequence_parallel_scope:
    """Route every ``F.scaled_dot_attention`` inside the scope through
    sequence-parallel attention over ``mesh``'s ``axis_name`` axis:
    ``impl="ring"`` (``parallel.ring_attention``, any head count) or
    ``"ulysses"`` (``parallel.ulysses_attention``, H % axis == 0). Models
    need no edits: every rank of the axis runs the same model on the same
    sequence; inside the seam each rank takes its block of q, k and v,
    the ring or the all-to-alls run over the axis's group, and the output
    is gathered back, so the model sees the whole sequence's attention
    (the gradients too). Exported as
    ``mxnet_tpu_torch.parallel.sequence_parallel_scope``. The scope is read
    at each call and is per thread."""

    def __init__(self, mesh, axis_name="sp", impl="ring"):
        if impl not in ("ring", "ulysses"):
            raise ValueError("impl must be 'ring' or 'ulysses', got %r"
                             % (impl,))
        self._cfg = (mesh, axis_name, impl)

    def __enter__(self):
        stack = getattr(_SP_SCOPE, "stack", None)
        if stack is None:
            stack = _SP_SCOPE.stack = []
        stack.append(self._cfg)
        return self

    def __exit__(self, *a):
        _SP_SCOPE.stack.pop()


def _current_sp_scope():
    stack = getattr(_SP_SCOPE, "stack", None)
    return stack[-1] if stack else None


def _sequence_parallel(q, k, v, mask, causal, scale, sp):
    mesh, axis_name, impl = sp
    if mask is not None:
        raise ValueError(
            "sequence_parallel_scope: ring/ulysses attention supports "
            "causal or unmasked only — key-padding masks would need "
            "per-shard valid lengths (pad to full length instead)")
    n_sp = int(mesh.shape[axis_name])
    if q.shape[2] % n_sp or k.shape[2] % n_sp:
        raise ValueError(
            "sequence_parallel_scope: sequence length %d/%d must divide "
            "the %r axis (%d) — incremental decode (T=1) and ragged "
            "lengths cannot shard; run generation outside the scope"
            % (q.shape[2], k.shape[2], axis_name, n_sp))
    from ..parallel import ring_attention, ulysses_attention
    from ..parallel.ring_attention import gather_sequence, shard_sequence

    fn = ring_attention if impl == "ring" else ulysses_attention
    q, k, v = (shard_sequence(t, mesh, axis_name) for t in (q, k, v))
    out = fn(q, k, v, mesh, axis_name=axis_name, causal=causal, scale=scale)
    return gather_sequence(out, mesh, axis_name)


@register_op("scaled_dot_attention")
def scaled_dot_attention(q, k, v, mask=None, *, causal=False, scale=None,
                         prefix_mask=False):
    """q, k, v: (B, H, T, D); mask broadcastable to (B, H, Tq, Tk), 1 = keep.

    ``prefix_mask=True`` declares that ``mask`` is a key-padding prefix
    (mask[b, ..., t] = t < valid_len[b]); then the flash path applies with
    the valid length recovered from the mask.

    Inside ``parallel.sequence_parallel_scope(mesh, ...)`` the seam runs
    ring or Ulysses attention over the scope's mesh axis: the model code
    does not change, the sequence dimension splits."""
    sp = _current_sp_scope()
    if sp is not None:
        return _sequence_parallel(q, k, v, mask, causal, scale, sp)
    return local_attention(q, k, v, mask, causal=causal, scale=scale,
                           prefix_mask=prefix_mask)


def local_attention(q, k, v, mask=None, causal=False, scale=None,
                    prefix_mask=False):
    """The seam's routing on this rank alone: the flash kernels by
    :func:`takes_flash`, else :func:`dense_attention` (what
    :func:`scaled_dot_attention` runs outside a sequence-parallel scope,
    and Ulysses attention runs on its heads inside one)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if takes_flash(q, mask, prefix_mask, grad):
        vl = None if mask is None else _prefix_mask_to_valid_len(mask)
        # the kernels read (B, H, T, D) rows: a strided view (heads split
        # off a fused qkv in a Symbol graph, which has no contiguous op) is
        # copied once; a contiguous tensor passes as it is
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if grad:
            return flash_attention_with_grad(q, k, v, causal=causal,
                                             scale=scale, kv_valid_len=vl)
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_valid_len=vl)
    return dense_attention(q, k, v, mask, causal=causal, scale=scale)


def _write_time(cache, update, index):
    """Write ``update`` (B, H, T, D) into ``cache`` (B, H, C, D) along axis
    2 at ``index``, in place: an int or 0-d tensor (every row at one
    offset) or a per-row ``(B,)`` tensor. As ``lax.dynamic_update_slice``,
    the start clamps to ``[0, C - T]``; a tensor index is clamped on its
    device, with no host read."""
    T, C = update.shape[2], cache.shape[2]
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
    return _write_time(cache, update.to(cache.dtype), index)


def _requant_page(cache, scale, update, index):
    """The shared arithmetic of the int8 page ops: the running-max scale
    ``new_scale = max(scale, max(amax(update) / 127, 1e-8))`` per (row,
    head), the page requantized by ``ratio = scale / new_scale`` (0 for a
    page never written, whose scale is 0), the update quantized at the new
    scale and written into the requantized page. Returns (the page as
    integer-valued fp32 (B, H, C, D), new_scale)."""
    update = update.to(torch.float32)
    amax = update.abs().amax(dim=(2, 3), keepdim=True)
    step = torch.maximum(amax / _const(amax, 127.0), _const(amax, 1e-8))
    new_scale = torch.maximum(scale, step)
    ratio = scale / new_scale
    requant = torch.clamp(torch.round(cache.to(torch.float32) * ratio),
                          -127, 127)
    qupd = torch.clamp(torch.round(update / new_scale), -127, 127)
    return _write_time(requant, qupd, index), new_scale


def quantize_page(page, plen):
    """A prompt's fp K or V page (1, H, tp, D) as int8 with a fresh
    per-head scale (1, H, 1, 1) fp32, positions ``>= plen`` masked out of
    the amax (padding must not widen the scale), as the JAX server's
    ``_quantize_pages``. A fresh scale, not a running max: a prefill or a
    prefix inject restarts the slot's page. Returns (q, scale)."""
    tp = page.shape[2]
    keep = (torch.arange(tp, device=page.device) < plen).to(torch.float32)
    a = page.to(torch.float32) * keep.reshape(1, 1, tp, 1)
    amax = a.abs().amax(dim=(2, 3), keepdim=True)
    scale = torch.maximum(amax / _const(amax, 127.0), _const(amax, 1e-8))
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


@register_op("quant_cache_write")
def quant_cache_write(cache, scale, update, index):
    """:func:`cache_write` for the int8 paged KV cache: ``update``
    (B, H, T, D) fp is quantized on write into ``cache`` (B, H, C, D) int8
    with the per-page-per-head scale ``scale`` (B, H, 1, 1) fp32; both are
    written in place and returned as ``(cache, scale)``.

    The scale is a running per-(page, head) max, never decreasing, so the
    written positions only rescale down (ratio <= 1), and the whole page is
    requantized each write: an exact no-op where the scale did not move
    (an int8 value times 1.0 rounds to itself)."""
    page, new_scale = _requant_page(cache, scale, update, index)
    cache.copy_(page.to(torch.int8))
    scale.copy_(new_scale)
    return cache, scale


@register_op("quant_cache_write_read")
def quant_cache_write_read(cache, scale, update, index):
    """:func:`quant_cache_write` fused with the :func:`dequant_cache` read
    of the page it wrote: returns ``(cache, scale, deq)``, ``deq``
    (B, H, C, D) fp32 for attention, computed from the integer-valued fp32
    page the write made, so the int8 round trip never happens. Bit-equal
    to the unfused pair: int8 holds those integers exactly."""
    page, new_scale = _requant_page(cache, scale, update, index)
    cache.copy_(page.to(torch.int8))
    scale.copy_(new_scale)
    return cache, scale, page * new_scale


@register_op("dequant_cache")
def dequant_cache(cache, scale):
    """int8 KV pages to fp32 for attention: ``cache`` (B, H, C, D) int8
    times ``scale`` (B, H, 1, 1) fp32."""
    return cache.to(torch.float32) * scale


@register_op("masked_softmax")
def masked_softmax(x, mask=None, *, axis=-1):
    """Softmax along ``axis`` with masked-out positions (mask 0) at -1e30."""
    if mask is not None:
        x = torch.where(mask.to(torch.bool), x, -1e30)
    return torch.softmax(x, dim=axis)
