"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these same plain versions); the JAX side runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does. Tolerances: fp32 1e-4, bf16
0.05 absolute (tests/test_kernels.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.flash_attention import _flash_fwd
from mxnet_tpu.ops.pallas.layernorm import fused_layernorm as jax_ln
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import layernorm as ln

_DT = {"float32": (jnp.float32, torch.float32, 1e-4),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    jdt, tdt, _ = _DT[dtype]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [
    pytest.param(64, 256, id="256"),
    pytest.param(64, 200, id="200"),
    # a GPT decode step's rows, and a C that is not a multiple of 8
    pytest.param(8, 768, id="8x768"),
    pytest.param(64, 100, id="100"),
])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layernorm_matches_pallas(dtype, R, C, eps):
    rng = np.random.RandomState(C)
    x = (rng.randn(R, C) * 3 + 1).astype(np.float32)
    g = rng.randn(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jax_ln(jx, jnp.asarray(g), jnp.asarray(b), eps, interpret=True)
    got = ln.fused_layernorm(tx, torch.from_numpy(g), torch.from_numpy(b), eps)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=_DT[dtype][2], rtol=0)


def test_layernorm_wrapper_counts_only_kernel_launches():
    x = torch.randn(8, 32)
    before = ln.fused_layernorm.launches
    ln.fused_layernorm(x, torch.ones(32), torch.zeros(32))
    assert ln.fused_layernorm.launches == before  # CPU: plain version


def _qkv(seed, B, H, T, D, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_vl", [False, True])
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_forward_matches_pallas(causal, with_vl, return_lse):
    B, H, T, D = 3, 2, 128, 64
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, B, H, T, D, "float32")
    vl = np.array([0, 37, 128], np.int32) if with_vl else None
    scale = 1.0 / D ** 0.5
    want = _flash_fwd(jq, jk, jv, None if vl is None else jnp.asarray(vl),
                      scale, causal, 64, 64, interpret=True,
                      return_lse=return_lse)
    got = fa.flash_attention(tq, tk, tv, causal=causal, scale=scale,
                             kv_valid_len=None if vl is None
                             else torch.from_numpy(vl),
                             return_lse=return_lse)
    if return_lse:
        (want, want_lse), (got, got_lse) = want, got
        assert got_lse.shape == want_lse.shape == (B * H, T, 1)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    if with_vl:  # vl = 0 gives exact zeros, as the TPU kernel does
        assert not got[0].any()


@pytest.mark.parametrize("T,D", [(200, 64), (128, 128)])
def test_flash_forward_bf16_ragged_and_wide_head(T, D):
    """T = 200 (no power-of-two tile divides it) and D = 128; the Pallas
    kernel takes T = 200 as one whole block."""
    B, H = 2, 2
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, B, H, T, D, "bfloat16")
    vl = np.array([T, 77], np.int32)
    scale = 1.0 / D ** 0.5
    want = _flash_fwd(jq, jk, jv, jnp.asarray(vl), scale, False, T, T,
                      interpret=True)
    got = fa.flash_attention(tq, tk, tv, scale=scale,
                             kv_valid_len=torch.from_numpy(vl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05, rtol=0)


@pytest.mark.parametrize("T,D,causal,vl,return_lse", [
    (192, 64, True, [192, 100, 0], False),  # a 64- but not 128-multiple
    (1, 64, False, None, True),
    (256, 128, True, None, True),
])
def test_flash_forward_edge_shapes_match_pallas(T, D, causal, vl, return_lse):
    """The shapes the card's kernel takes at its tile edges: the last
    128-row query tile half empty, a single row and key, head dim 128 with
    the causal edge; fp32, so the algorithm and not bf16 rounding is held."""
    B, H = 3 if vl else 2, 2
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, B, H, T, D, "float32")
    vl = None if vl is None else np.array(vl, np.int32)
    block = min(T, 64)
    scale = 1.0 / D ** 0.5
    want = _flash_fwd(jq, jk, jv, None if vl is None else jnp.asarray(vl),
                      scale, causal, block, block, interpret=True,
                      return_lse=return_lse)
    got = fa.flash_attention(tq, tk, tv, causal=causal, scale=scale,
                             kv_valid_len=None if vl is None
                             else torch.from_numpy(vl),
                             return_lse=return_lse)
    if return_lse:
        (want, want_lse), (got, got_lse) = want, got
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    if vl is not None:
        assert not got[2].any()


def test_flash_forward_kernel_source_is_wgmma_with_a_cp_async_ring():
    """The forward kernel computes both products with wgmma (S = Q K^T with
    both operands in shared memory, O += P V with P from registers) and
    streams K and V through cp.async; no mma.sync or ldmatrix is left."""
    src = open(os.path.join(os.path.dirname(fa.__file__), "..", "..", "csrc",
                            "flash_attention_fwd.cu")).read()
    assert "wgmma_ss<" in src and "wgmma_rs<" in src
    assert "load_tile_async<" in src and "cp_async_wait<" in src
    assert "mma.sync" not in src and "ldmatrix" not in src
    assert "mma_16816" not in src


@pytest.mark.parametrize("B,H,T,D,causal,vl", [
    (1, 2, 256, 64, True, None),        # a quantized GPT prefill's bucket
    (2, 2, 130, 64, False, [130, 45]),  # BERT's key padding, a ragged tile
    (2, 1, 96, 128, True, [96, 0]),     # head dim 128, vl 0
])
def test_flash_forward_f32_form_matches_pallas(B, H, T, D, causal, vl):
    """fp32 operands (the quantized models' attention) go through the
    forward kernel's fp32 form, counted apart from the bf16 kernel; on the
    CPU both wrappers take the plain version and count nothing."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, B, H, T, D, "float32")
    vl = None if vl is None else np.array(vl, np.int32)
    block = min(T, 64) if T % 64 == 0 else T
    scale = 1.0 / D ** 0.5
    want, want_lse = _flash_fwd(
        jq, jk, jv, None if vl is None else jnp.asarray(vl), scale, causal,
        block, block, interpret=True, return_lse=True)
    before = (fa.flash_attention.launches, fa.flash_attention_f32.launches)
    got, got_lse = fa.flash_attention(
        tq, tk, tv, causal=causal, scale=scale, return_lse=True,
        kv_valid_len=None if vl is None else torch.from_numpy(vl))
    assert got.dtype == torch.float32 and got.shape == tq.shape
    assert (fa.flash_attention.launches,
            fa.flash_attention_f32.launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-4)
    if vl is not None and vl[-1] == 0:
        assert not got[-1].any()
