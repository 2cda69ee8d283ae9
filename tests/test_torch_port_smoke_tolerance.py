"""The tolerance ``chip_smoke.py`` holds each kernel to on the card, checked
on the CPU: the plain version passes against itself, and small faults of
the kind a kernel can have (a scale off by 1 %, one dropped key or key
tile, a gamma off by 1 %) are caught in the long-row regime of the main
path (every key valid at seq 512), where attention outputs are small. A
scale off by 0.5 % is the size of the bf16 rounding of p, which the
elementwise flash limit must allow; the logsumexp check catches it."""
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain
from mxnet_tpu_torch.ops.cuda.layernorm import layernorm_plain

T = 512


def _flash(q, k, v, vl=T, scale=1.0 / 8, return_lse=False):
    vlt = torch.full((q.shape[0],), vl, dtype=torch.int32)
    return flash_attention_plain(q, k, v, kv_valid_len=vlt, scale=scale,
                                 return_lse=return_lse)


FLASH_FAULTS = {
    "none": {},
    "scale x1.01": {"scale": 1.01 / 8},
    "last key tile dropped": {"vl": T - 64},
    "last key dropped": {"vl": T - 1},
}


@pytest.mark.parametrize("fault", list(FLASH_FAULTS))
def test_flash_tolerance_catches_faults(fault):
    q, k, v = cs._qkv("cpu", torch.Generator().manual_seed(0), 2, 4, T, 64)
    ref = _flash(q, k, v)
    mag = cs.flash_magnitude(q, k, v, torch.full((2,), T, dtype=torch.int32))
    assert bool((mag >= ref.abs()).all())
    got = _flash(q, k, v, **FLASH_FAULTS[fault])
    if fault == "none":
        assert cs.held(got, ref, cs.FLASH_TOL, fault, mag)["worst_ratio"] == 0
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.held(got, ref, cs.FLASH_TOL, fault, mag)


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
