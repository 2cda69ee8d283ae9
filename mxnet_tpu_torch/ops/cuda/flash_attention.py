"""Flash attention: the CUDA kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: the forward
``_flash_fwd`` and the backward ``_flash_bwd`` (its dq and dk/dv kernels,
one fused kernel here), with all their flags: ``causal``, a per-example
valid key length ``kv_valid_len`` (tiles past it are skipped), and the
per-row logsumexp the backward recomputes P from. The kernels are
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` (why they are shaped as they are, and what bounds
them, is written there): bf16 q, k, v with fp32 accumulation, head dim 64 or
128, any sequence length. Both are Hopper designs on ``wgmma``: the forward
streams K/V tiles through a cp.async ring (at head dim 64 two warpgroups of
64 query rows share each tile); the backward is one fused kernel for dq, dk
and dv. The TPU forward takes its operands in their own dtype, so fp32 q,
k, v (the quantized models' attention) go to the forward's fp32 form,
``flash_attention_fwd_f32.cu``: 3xTF32 products on the tensor cores, with
the key range split over several CTAs when the grid is under a wave (the
split is :func:`flash_f32_splits`, plain Python), launched and counted by
:func:`flash_attention_f32`. It has no backward: a differentiable fp32
attention takes the dense path (``ops/attention.py``).

:func:`flash_attention`, :func:`flash_attention_f32` and
:func:`flash_attention_bwd` call the ops ``mxnet_tpu_torch::flash_fwd``,
``::flash_fwd_f32`` and ``::flash_bwd``, which take the plain version for
CPU tensors and launch the kernel for CUDA tensors, or raise; they never
fall back from the card to the plain version. The forward ops always
return an lse, empty (0 elements) unless it was asked for.
:func:`flash_attention_with_grad` is the differentiable op (the forward op
with an autograd formula mirroring the JAX ``custom_vjp``): its forward
keeps the lse, its backward forms delta = rowsum(dO * O) in PyTorch, as the
JAX package does outside its kernels, and calls the backward op.
Layouts are the JAX function's: q (B, H, Tq, D), k and v (B, H, Tk, D), lse
(B*H, Tq, 1) float32, delta (B, H, Tq) float32.
"""
from __future__ import annotations

import functools
import heapq
import math

import torch

from typing import Optional

from . import (IMPLS, _build, fake_check, implementation,
               no_second_order)

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernel's template instances
# the fp32 form's tile for each head dim, as flash_attention_fwd_f32.cu has
# it: query rows a CTA, keys a K/V tile, and the CTAs an SM holds at once
# (by their shared memory); the wrapper takes the built kernel's own report
# (f32_tile), chip_smoke.py checks that it is this
F32_TILES = {64: (128, 64, 1), 128: (128, 16, 1)}
F32_MAX_SPLITS = 16
# the split choice's cost model, in key tiles of one CTA: a CTA's fixed work
# (Q in and split, its epilogue) and the combine pass, fitted to the split
# sweeps of tools/cuda_flash_f32_bench.py on an H100 (PERF.md)
F32_CTA_COST = 0.85
F32_COMBINE_COST = 1.0


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


def _check(q, k, v, kv_valid_len, dtype=torch.bfloat16):
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
        if t.dtype != dtype:
            raise TypeError("flash kernel takes %s %s, got %s"
                            % (dtype, name, t.dtype))
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
    logsumexp (B*H, Tq, 1) float32. float32 operands go to
    :func:`flash_attention_f32`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, causal=causal, scale=scale,
                                   kv_valid_len=kv_valid_len,
                                   return_lse=return_lse)
    out, lse = _flash_fwd_op(q, k, v, _valid_len(kv_valid_len), float(scale),
                             bool(causal), bool(return_lse))
    return (out, lse) if return_lse else out


@implementation("flash_attention")
def _flash_fwd(q, k, v, causal=False, scale=None, kv_valid_len=None,
               return_lse=False):
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


def _ceil(a, b):
    return -(-a // b)


def f32_key_tiles(tq, kv_len, causal, tile):
    """The key tiles each query tile of the fp32 form runs (the kernel's
    ``key_tiles``): up to the valid length, and with ``causal`` up to the
    query tile's last row. ``tile`` is (query rows, keys, CTAs an SM)."""
    rows, keys = tile[:2]
    return [_ceil(max(min(kv_len, (i + 1) * rows) if causal else kv_len, 0),
                  keys) for i in range(_ceil(tq, rows))]


def flash_f32_splits(batch_heads, tq, tk, causal, sms, head_dim=64,
                     tile=None):
    """(splits, chunk) of the fp32 form: query tile i runs its key tiles
    in runs of ``chunk``, ceil(tiles_i / chunk) CTAs, at most ``splits``.
    One split (the whole range a CTA) when the grid of ceil(tq / rows) *
    batch_heads CTAs already fills the ``sms`` SMs. Else each candidate
    split count is costed as the time its CTAs take on the card's slots
    (sms * CTAs an SM), handed out in launch order to the first free slot,
    each CTA its key tiles plus ``F32_CTA_COST``, plus ``F32_COMBINE_COST``
    for the combine pass; the cheapest wins, the fewer splits on a tie. A
    long (causal: late) query tile so gets more CTAs than a short one, and
    the card's slots about the same number of (query, key) pairs: the
    kernel computes a causal diagonal tile whole, so a key tile is the
    unit of pairs. Every example counts all ``tk`` keys: the valid
    lengths are on the card. ``tile`` (query rows, keys, CTAs an SM)
    defaults to ``F32_TILES[head_dim]``. A split ``ir.tune.
    tune_flash_blocks`` installed for this shape is taken before the cost
    model."""
    tile = tuple(tile or F32_TILES[head_dim])
    from ...ir import tune

    tuned = tune.flash_split(batch_heads, tq, tk, causal, head_dim, tile)
    if tuned is not None:
        return tuned
    return _f32_splits(batch_heads, tq, tk, bool(causal), sms, tile)


def _makespan(loads, slots):
    """When the last of ``loads`` ends, each started in order on the first
    free of ``slots``."""
    if len(loads) <= slots:
        return max(loads, default=0.0)
    ends = [0.0] * slots
    for load in loads:
        heapq.heappush(ends, heapq.heappop(ends) + load)
    return max(ends)


@functools.lru_cache(maxsize=1024)
def _f32_splits(batch_heads, tq, tk, causal, sms, tile):
    rows, _, per_sm = tile
    tiles = f32_key_tiles(tq, tk, causal, tile)
    most = max(tiles + [1])
    if _ceil(tq, rows) * batch_heads >= sms:
        return 1, most
    best, best_cost = (1, most), None
    for s in range(1, min(most, F32_MAX_SPLITS) + 1):
        chunk = _ceil(most, s)
        splits = _ceil(most, chunk)
        if splits != s:
            continue
        # CTAs in launch order: query tile fastest, then batch * head, then
        # split; one with no run exits at once
        loads = [min(chunk, n - z * chunk) + F32_CTA_COST
                 for z in range(splits) for _ in range(batch_heads)
                 for n in tiles if z * chunk < n or (z == 0 and n == 0)]
        cost = _makespan(loads, sms * per_sm) + \
            (F32_COMBINE_COST if splits > 1 else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = (splits, chunk), cost
    return best


_sm_count = {}
_f32_tiles = {}


def _sms(device):
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device.index]


def f32_tile(head_dim):
    """(query rows a CTA, keys a K/V tile, CTAs an SM) of the built fp32
    kernel at ``head_dim``, as it reports them (the last is the card's
    occupancy for it)."""
    if head_dim not in _f32_tiles:
        _f32_tiles[head_dim] = tuple(
            _build.extension().flash_fwd_f32_tile(head_dim))
    return _f32_tiles[head_dim]


def flash_attention_f32(q, k, v, causal=False, scale=None, kv_valid_len=None,
                        return_lse=False):
    """:func:`flash_attention` for float32 q, k and v through the forward
    kernel's fp32 form, whose launches it counts apart (one a call, its
    combine pass included). q, k and v must also start on a 16-byte
    boundary (the kernel reads them as float4). Where the grid is under a
    wave the key range is split (:func:`flash_f32_splits`) and a workspace of
    splits * B*H * Tq * (D + 2) floats holds the partial results."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = _flash_fwd_f32_op(q, k, v, _valid_len(kv_valid_len),
                                 float(scale), bool(causal), bool(return_lse))
    return (out, lse) if return_lse else out


@implementation("flash_attention_f32")
def _flash_fwd_f32(q, k, v, causal=False, scale=None, kv_valid_len=None,
                   return_lse=False):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid_len, scale, causal,
                                     return_lse)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_f32: no kernel for device %s"
                         % q.device)
    _check(q, k, v, kv_valid_len, torch.float32)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError("flash kernel takes a 16-byte aligned %s" % name)
    B, H, Tq, D = q.shape
    ext = _build.extension()
    splits, chunk = flash_f32_splits(B * H, Tq, k.shape[2], causal,
                                     _sms(q.device), D, tile=f32_tile(D))
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Tq, 1), dtype=torch.float32, device=q.device) \
        if return_lse else None
    work = torch.empty(splits * B * H * Tq * (D + 2), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    ext.flash_fwd_f32(
        q, k, v, _valid_len(kv_valid_len), out, lse, work, H, float(scale),
        bool(causal), splits, chunk,
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_f32.launches += 1
    return (out, lse) if return_lse else out


flash_attention_f32.launches = 0


def flash_attention_f32_split(q, k, v, split, scale, causal,
                              kv_valid_len=None):
    """The fp32 form at a given ``(splits, chunk)`` (``ir.tune``'s
    candidates; the wrapper takes :func:`flash_f32_splits`'). Card only;
    counted in ``flash_attention_f32.launches``."""
    _check(q, k, v, kv_valid_len, torch.float32)
    B, H, Tq, D = q.shape
    splits, chunk = (int(x) for x in split)
    out = torch.empty_like(q)
    work = torch.empty(splits * B * H * Tq * (D + 2), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    _build.extension().flash_fwd_f32(
        q, k, v, _valid_len(kv_valid_len), out, None, work, H, float(scale),
        bool(causal), splits, chunk,
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_f32.launches += 1
    return out


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
    if torch.is_grad_enabled() and q.device.type == "cpu":
        # the plain version's torch ops carry a graph (create_graph)
        return IMPLS["flash_attention_bwd"](
            q, k, v, do, lse, delta, kv_valid_len=_valid_len(kv_valid_len),
            scale=float(scale), causal=bool(causal))
    with torch.no_grad():  # a kernel's outputs carry no graph
        return tuple(_flash_bwd_op(q, k, v, do, lse, delta,
                                   _valid_len(kv_valid_len), float(scale),
                                   bool(causal)))


@implementation("flash_attention_bwd")
def _flash_bwd(q, k, v, do, lse, delta, kv_valid_len=None, scale=None,
               causal=False):
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


def _fwd_op_body(name, q, k, v, kv_valid_len, scale, causal, return_lse):
    got = IMPLS[name](q, k, v, causal=causal, scale=scale,
                      kv_valid_len=kv_valid_len, return_lse=return_lse)
    if return_lse:
        return got
    return got, q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("mxnet_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor], scale: float,
                  causal: bool, return_lse: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwd_op_body("flash_attention", q, k, v, kv_valid_len, scale,
                        causal, return_lse)


@torch.library.custom_op("mxnet_tpu_torch::flash_fwd_f32", mutates_args=())
def _flash_fwd_f32_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid_len: Optional[torch.Tensor], scale: float,
                      causal: bool, return_lse: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwd_op_body("flash_attention_f32", q, k, v, kv_valid_len, scale,
                        causal, return_lse)


def _fwd_fake(q, k, v, kv_valid_len, scale, causal, return_lse):
    fake_check("flash_attention", q)
    B, H, Tq, _ = q.shape
    lse_shape = (B * H, Tq, 1) if return_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


_flash_fwd_op.register_fake(_fwd_fake)
_flash_fwd_f32_op.register_fake(_fwd_fake)


@torch.library.custom_op("mxnet_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor], scale: float,
                  causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(IMPLS["flash_attention_bwd"](
        q, k, v, do, lse, delta, kv_valid_len=kv_valid_len, scale=scale,
        causal=causal))


@_flash_bwd_op.register_fake
def _(q, k, v, do, lse, delta, kv_valid_len, scale, causal):
    fake_check("flash_attention_bwd", q)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, vl, scale, causal, _ = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1], vl)
    ctx.scale, ctx.causal = scale, causal
    ctx.mark_non_differentiable(output[1])


def _flash_backward(ctx, do, dlse):
    q, k, v, o, lse, vl = ctx.saved_tensors
    do = do.to(q.dtype).contiguous()
    if torch.is_grad_enabled():  # autograd.grad(create_graph=True)
        no_second_order("flash_attention_bwd", q)
        # the saved o and lse carry no graph: recompute them from q, k, v
        o, lse = flash_attention_plain(q, k, v, vl, ctx.scale,
                                       ctx.causal, return_lse=True)
        delta = (o.float() * do.float()).sum(dim=-1)
        return (*flash_attention_bwd_plain(
            q, k, v, do, lse, delta, vl, ctx.scale, ctx.causal),
            None, None, None, None)
    delta = (o.float() * do.float()).sum(dim=-1)
    dq, dk, dv = _flash_bwd_op(q, k, v, do, lse, delta, vl, ctx.scale,
                               ctx.causal)
    return dq, dk, dv, None, None, None, None


_flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)
_flash_fwd_f32_op.register_autograd(_flash_backward,
                                    setup_context=_flash_setup)


def flash_attention_with_grad(q, k, v, causal=False, scale=None,
                              kv_valid_len=None):
    """:func:`flash_attention`, differentiable in q, k and v: the forward
    launches with the lse, the backward launches the backward kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    op = _flash_fwd_f32_op if q.dtype == torch.float32 else _flash_fwd_op
    return op(q, k, v, _valid_len(kv_valid_len), float(scale), bool(causal),
              True)[0]
