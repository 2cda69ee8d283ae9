"""The port's attention seam against the JAX package's
(``mxnet_tpu/ops/attention.py``): the dense path with a prefix mask, the
valid-length recovery, and the routing rule to the flash kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu_torch.ops import attention as tattn


def _prefix_mask(vl, T):
    return (np.arange(T)[None, None, None, :]
            < np.asarray(vl)[:, None, None, None]).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_path_with_prefix_mask_matches_jax(dtype, tol, causal):
    rng = np.random.RandomState(3)
    B, H, T, D = 3, 2, 48, 64
    q, k, v = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    mask = _prefix_mask([48, 20, 1], T)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jattn.scaled_dot_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask),
        causal=causal, prefix_mask=True)
    got = tattn.scaled_dot_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(mask), causal=causal, prefix_mask=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def test_prefix_mask_to_valid_len_matches_jax():
    vl = np.array([5, 0, 64, 17], np.int32)
    mask = _prefix_mask(vl, 64)
    want = np.asarray(jattn._prefix_mask_to_valid_len(jnp.asarray(mask)))
    got = tattn._prefix_mask_to_valid_len(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), vl)


@pytest.mark.parametrize("T,D,dtype,prefix,flash", [
    (256, 64, torch.bfloat16, True, True),
    (256, 128, torch.bfloat16, True, True),
    (255, 64, torch.bfloat16, True, False),   # below the threshold
    (256, 64, torch.float32, True, True),     # the forward's fp32 form
    (256, 32, torch.bfloat16, True, False),   # nor head dim 32
    (256, 64, torch.bfloat16, False, False),  # arbitrary mask: dense
])
def test_seam_routes_to_flash(monkeypatch, T, D, dtype, prefix, flash):
    """Long bf16 or fp32 sequences with a declared prefix mask take the
    flash path, with the recovered valid lengths; on real rows it agrees
    with dense."""
    calls = []
    real = tattn.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw["kv_valid_len"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, T, D).astype(np.float32))
               .to(dtype) for _ in range(3))
    vl = [T, 100]
    mask = torch.from_numpy(_prefix_mask(vl, T))
    out = tattn.scaled_dot_attention(q, k, v, mask, prefix_mask=prefix)
    assert len(calls) == int(flash)
    if flash:
        np.testing.assert_array_equal(calls[0].numpy(), vl)
    dense = tattn.dense_attention(q, k, v, mask)
    np.testing.assert_allclose(out.float().numpy(), dense.float().numpy(),
                               atol=0.05 if dtype == torch.bfloat16 else 1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype,flash", [(torch.bfloat16, True),
                                         (torch.float32, False)])
def test_seam_under_autograd_takes_flash_for_bf16_only(monkeypatch, dtype,
                                                       flash):
    """A recorded attention needs the backward kernel, which takes bf16:
    fp32 operands that require grad take the dense path, and its gradient
    agrees with the flash plain version's."""
    calls = []
    real = tattn.flash_attention_with_grad

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention_with_grad", spy)
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
               .to(dtype).requires_grad_() for _ in range(3))
    out = tattn.scaled_dot_attention(q, k, v, causal=True)
    assert len(calls) == int(flash)
    out.float().square().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == dtype
               for t in (q, k, v))
