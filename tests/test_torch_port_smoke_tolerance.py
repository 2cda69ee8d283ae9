"""The tolerance ``chip_smoke.py`` holds each kernel to on the card, checked
on the CPU: the plain version passes against itself, and small faults of
the kind a kernel can have (a scale off by 1 %, one dropped key or key
tile, a gamma off by 1 %; and those of the forward's K/V ring: a stale
slot, K and V from different tiles, one warpgroup's rows finishing with
the other's row statistics) are caught in the long-row regime of the main
path (every key valid at seq 512), where attention outputs are small. A
scale off by 0.5 % is the size of the bf16 rounding of p, which the
elementwise flash limit must allow; the logsumexp check catches it."""
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain
from mxnet_tpu_torch.ops.cuda.layernorm import (layernorm_bwd_plain,
                                                layernorm_plain)

T = 512


def _flash(q, k, v, vl=T, scale=1.0 / 8, return_lse=False):
    vlt = torch.full((q.shape[0],), vl, dtype=torch.int32)
    return flash_attention_plain(q, k, v, kv_valid_len=vlt, scale=scale,
                                 return_lse=return_lse)


def _tile_from(x, j, src, n=64):
    """x with key tile j (n keys) replaced by key tile src."""
    x = x.clone()
    x[:, :, n * j:n * (j + 1)] = x[:, :, n * src:n * (src + 1)]
    return x


def _stats_of_first_warpgroup(q, k, v):
    """The second warpgroup's 64 rows of every 128-row query tile finish
    with the first warpgroup's running max and sum (the row 64 above): the
    output is rescaled by exp(lse - lse of that row), and the lse is that
    row's."""
    out, lse = _flash(q, k, v, return_lse=True)
    B, H, _, _ = q.shape
    lse = lse.reshape(B, H, T // 128, 2, 64)
    other = lse[:, :, :, :1].expand_as(lse)
    scale = torch.exp(lse - other).reshape(B, H, T, 1)
    return (out.float() * scale).to(out.dtype), other.reshape(B * H, T, 1)


# each builds (output, lse) from the plain version on the CPU; a K/V ring
# fault touches one tile of every head, at the kernel's tile widths (128
# keys at head dim 64, 64 at head dim 128)
FLASH_FAULTS = {
    "none": lambda q, k, v: _flash(q, k, v, return_lse=True),
    "scale x1.01": lambda q, k, v: _flash(q, k, v, scale=1.01 / 8,
                                          return_lse=True),
    "last key tile dropped": lambda q, k, v: _flash(q, k, v, vl=T - 64,
                                                    return_lse=True),
    "last key dropped": lambda q, k, v: _flash(q, k, v, vl=T - 1,
                                               return_lse=True),
    "stale slot: tile 3 with tile 2's K and V": lambda q, k, v: _flash(
        q, _tile_from(k, 3, 2), _tile_from(v, 3, 2), return_lse=True),
    "K of tile 3 with V of tile 4": lambda q, k, v: _flash(
        q, k, _tile_from(v, 3, 4), return_lse=True),
    "stale slot: 128-key tile 2 with tile 1's K and V": lambda q, k, v:
        _flash(q, _tile_from(k, 2, 1, 128), _tile_from(v, 2, 1, 128),
               return_lse=True),
    "K of 128-key tile 1 with V of tile 2": lambda q, k, v: _flash(
        q, k, _tile_from(v, 1, 2, 128), return_lse=True),
    "second warpgroup with the first's m and l": _stats_of_first_warpgroup,
}
# the faults that move the lse as well as the output
LSE_FAULTS = ("stale slot: tile 3 with tile 2's K and V",
              "stale slot: 128-key tile 2 with tile 1's K and V",
              "second warpgroup with the first's m and l")


def _qkv_ref():
    q, k, v = cs._qkv("cpu", torch.Generator().manual_seed(0), 2, 4, T, 64)
    return q, k, v, _flash(q, k, v, return_lse=True)


@pytest.mark.parametrize("fault", list(FLASH_FAULTS))
def test_flash_tolerance_catches_faults(fault):
    q, k, v, (ref, _) = _qkv_ref()
    mag = cs.flash_magnitude(q, k, v, torch.full((2,), T, dtype=torch.int32))
    assert bool((mag >= ref.abs()).all())
    got, _ = FLASH_FAULTS[fault](q, k, v)
    if fault == "none":
        assert cs.held(got, ref, cs.FLASH_TOL, fault, mag)["worst_ratio"] == 0
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.held(got, ref, cs.FLASH_TOL, fault, mag)


@pytest.mark.parametrize("fault", LSE_FAULTS)
def test_lse_tolerance_catches_ring_faults(fault):
    q, k, v, (_, ref) = _qkv_ref()
    _, got = FLASH_FAULTS[fault](q, k, v)
    assert cs.max_err(got, ref) > cs.LSE_TOL


def test_lse_tolerance_catches_small_scale_fault():
    q, k, v = cs._qkv("cpu", torch.Generator().manual_seed(0), 2, 4, T, 64)
    _, ref = _flash(q, k, v, return_lse=True)
    _, got = _flash(q, k, v, scale=1.005 / 8, return_lse=True)
    assert cs.max_err(got, ref) > cs.LSE_TOL


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, cs.BF16_TOL),
                                       (torch.float32, cs.FP32_TOL)])
def test_layernorm_tolerance_catches_gamma_fault(dtype, tol):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(256, 768, generator=g) * 2 + 0.5).to(dtype)
    gamma = torch.randn(768, generator=g)
    beta = torch.randn(768, generator=g)
    ref = layernorm_plain(x, gamma, beta, 1e-12)
    cs.held(ref, ref, tol, "no fault")
    with pytest.raises(cs.SmokeFailure):
        cs.held(layernorm_plain(x, gamma * 1.01, beta, 1e-12), ref, tol,
                "gamma x1.01")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layernorm_bwd_tolerance_catches_dgamma_fault(dtype):
    """The backward check's limits pass the plain version against itself
    and catch a dgamma 1 % high (and a dx 1 % high in fp32, where one step
    of rounding is far below 1 %)."""
    g = torch.Generator().manual_seed(0)
    x, gamma, _ = cs._ln_inputs("cpu", g, 256, 768, dtype)
    dy = torch.randn(256, 768, generator=g).to(dtype)
    dx, dg, db = layernorm_bwd_plain(x, gamma, dy, 1e-12)
    mdx, mdg, mdb = cs.layernorm_bwd_magnitudes(x, gamma, dy, 1e-12)
    assert bool((mdg >= dg.abs()).all()) and bool((mdb >= db.abs()).all())
    dx_tol = cs.LN_BWD_DX_TOL[str(dtype)[6:]]
    for got, ref, tol, mag in ((dx, dx, dx_tol, mdx),
                               (dg, dg, cs.LN_BWD_PARAM_TOL, mdg),
                               (db, db, cs.LN_BWD_PARAM_TOL, mdb)):
        assert cs.held(got, ref, tol, "no fault", mag)["worst_ratio"] == 0
    with pytest.raises(cs.SmokeFailure):
        cs.held(dg * 1.01, dg, cs.LN_BWD_PARAM_TOL, "dgamma x1.01", mdg)
    with pytest.raises(cs.SmokeFailure):
        cs.held(db * 1.01, db, cs.LN_BWD_PARAM_TOL, "dbeta x1.01", mdb)
    if dtype == torch.float32:
        with pytest.raises(cs.SmokeFailure):
            cs.held(dx * 1.01, dx, dx_tol, "dx x1.01", mdx)


@pytest.mark.parametrize("fault", list(FLASH_FAULTS))
def test_flash_f32_tolerance_catches_faults(fault):
    """The same faults on fp32 operands, against the limit the flash
    forward's fp32 form is held to (the quantized paths' attention)."""
    q, k, v = cs._qkv("cpu", torch.Generator().manual_seed(1), 2, 4, T, 64,
                      torch.float32)
    ref, _ = _flash(q, k, v, return_lse=True)
    mag = cs.flash_magnitude(q, k, v, torch.full((2,), T, dtype=torch.int32))
    got, _ = FLASH_FAULTS[fault](q, k, v)
    if fault == "none":
        assert cs.held(got, ref, cs.FLASH_F32_TOL, fault,
                       mag)["worst_ratio"] == 0
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.held(got, ref, cs.FLASH_F32_TOL, fault, mag)
