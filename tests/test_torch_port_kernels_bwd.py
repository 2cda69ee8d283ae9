"""The port's differentiable kernel ops against the JAX package's, forward
and backward: softmax cross-entropy, flash attention (the fused dq, dk, dv
backward), the LayerNorm backward and the dense attention backward.

On the CPU each kernel wrapper takes its plain PyTorch version (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these same plain versions); the JAX side runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does, and takes gradients with
``jax.vjp``. Inputs are seeded numpy arrays handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from mxnet_tpu.ops.pallas.layernorm import layernorm as jax_ln
from mxnet_tpu.ops.pallas.softmax_xent import softmax_xent as jax_xent
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import layernorm as ln
from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    return jnp.asarray(arr, _JDT[dtype]), torch.from_numpy(arr).to(_TDT[dtype])


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grads(out, inputs, cot):
    return torch.autograd.grad(out, inputs, cot)


# ---------------------------------------------------------- softmax-xent


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,V", [(16, 2), (12, 1000), (4, 30522)])
def test_softmax_xent_matches_pallas(dtype, R, V):
    """Loss within 1e-5 (+1e-6 relative: fp32 row sums in another order);
    dx within 1e-5 in fp32, and within two bf16 steps (2**-6 relative) in
    bf16, where both sides round fp32 values a few steps apart."""
    rng = np.random.RandomState(V)
    x = (rng.randn(R, V) * 3).astype(np.float32)
    lab = rng.randint(0, V, R).astype(np.int32)
    lab[0] = V - 1
    dy = rng.randn(R).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want, vjp = jax.vjp(lambda a: jax_xent(a, jnp.asarray(lab), True), jx)
    (want_dx,) = vjp(jnp.asarray(dy))
    tx.requires_grad_()
    got = sx.softmax_xent(tx, torch.from_numpy(lab))
    (got_dx,) = _grads(got, [tx], torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got_dx.dtype == _TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got_dx), _np(want_dx), atol=1e-5,
                                   rtol=0)
    else:
        np.testing.assert_allclose(_np(got_dx), _np(want_dx), atol=1e-6,
                                   rtol=2.0 ** -6)


def test_softmax_xent_rows_and_label_outside_vocab():
    """The fwd/bwd pair agrees with torch's own cross-entropy; a label
    outside [0, V) picks nothing (loss = lse), as the TPU kernel does."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 50, generator=g, requires_grad=True)
    lab = torch.tensor([0, 49, 7, 3, -1, 50], dtype=torch.int32)
    loss = sx.softmax_xent(x, lab)
    ref = torch.nn.functional.cross_entropy(x[:4], lab[:4].long(),
                                            reduction="none")
    torch.testing.assert_close(loss[:4], ref, atol=1e-5, rtol=1e-6)
    lse = torch.logsumexp(x.detach(), dim=1)
    torch.testing.assert_close(loss[4:].detach(), lse[4:], atol=1e-5,
                               rtol=1e-6)
    (dx,) = _grads(loss.sum(), [x], None)
    want = torch.softmax(x.detach(), dim=1)
    want[torch.arange(4), lab[:4].long()] -= 1
    torch.testing.assert_close(dx, want, atol=1e-6, rtol=1e-5)


def test_softmax_xent_wrappers_count_only_kernel_launches():
    x = torch.randn(3, 10, requires_grad=True)
    before = (sx.softmax_xent_fwd.launches, sx.softmax_xent_bwd.launches)
    sx.softmax_xent(x, torch.zeros(3, dtype=torch.int32)).sum().backward()
    assert (sx.softmax_xent_fwd.launches,
            sx.softmax_xent_bwd.launches) == before  # CPU: plain versions


# ---------------------------------------------------------- flash attention


def _flash_case(seed, B, H, T, D, dtype):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("causal,T,D,vl", [
    (False, 128, 64, None),
    (True, 128, 64, None),
    (False, 128, 64, [0, 37, 128]),
    (True, 128, 64, [100, 1, 128]),
    (False, 200, 64, [200, 0, 77]),   # ragged T
    (False, 128, 128, [128, 60, 5]),  # head dim 128
])
def test_flash_forward_backward_matches_pallas(causal, T, D, vl):
    """fp32 through both packages: output and dq, dk, dv within 2e-4
    relative + 2e-5 absolute (tests/test_kernels.py:273), and dk/dv of keys
    past the valid length exactly zero."""
    B, H = 3, 2
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _flash_case(T + D, B, H, T, D,
                                                         "float32")
    scale = 1.0 / D ** 0.5
    jvl = None if vl is None else jnp.asarray(vl, jnp.int32)
    tvl = None if vl is None else torch.tensor(vl, dtype=torch.int32)
    want, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, scale=scale, interpret=True,
        kv_valid_len=jvl), jq, jk, jv)
    want_grads = vjp(jdo)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    got = fa.flash_attention_with_grad(*leaves, causal=causal, scale=scale,
                                       kv_valid_len=tvl)
    got_grads = _grads(got, leaves, tdo)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-4, atol=2e-5)
    for b, n in enumerate(vl or []):
        assert not got_grads[1][b, :, n:].any()
        assert not got_grads[2][b, :, n:].any()
        if n == 0:
            assert not got_grads[0][b].any() and not got[b].any()


@pytest.mark.parametrize("causal,vl", [(False, [256, 0]), (True, [256, 90])])
def test_flash_backward_bf16_matches_pallas(causal, vl):
    """bf16 through both packages, T = 256, D = 64: dq, dk and dv within
    0.08 in relative L2 norm. Both sides round p and ds to bf16 before each
    product, from fp32 scores summed in another order, and round every
    output; the outputs' elementwise scatter is a few bf16 steps."""
    B, H, T, D = 2, 2, 256, 64
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _flash_case(5, B, H, T, D,
                                                         "bfloat16")
    jvl, tvl = jnp.asarray(vl, jnp.int32), torch.tensor(vl, dtype=torch.int32)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, interpret=True, kv_valid_len=jvl), jq, jk, jv)
    want_grads = vjp(jdo)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention_with_grad(*leaves, causal=causal,
                                       kv_valid_len=tvl)
    got_grads = _grads(out, leaves, tdo)
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, w) < 0.08
    for b, n in enumerate(vl):
        assert not got_grads[1][b, :, n:].any()
        assert not got_grads[2][b, :, n:].any()


def test_flash_backward_wrappers_count_only_kernel_launches():
    (_, q), (_, k), (_, v), (_, do) = _flash_case(0, 1, 1, 64, 64, "float32")
    before = fa.flash_attention_bwd.launches
    out = fa.flash_attention_with_grad(
        *(t.requires_grad_() for t in (q, k, v)))
    out.backward(do)
    assert fa.flash_attention_bwd.launches == before  # CPU: plain versions


@pytest.mark.parametrize("causal,T,D,vl", [
    (False, 128, 64, None),
    (True, 128, 64, None),
    (False, 128, 64, [0, 37, 128]),
    (True, 128, 64, [100, 1, 128]),
    (False, 200, 64, [200, 0, 77]),   # ragged T
    (False, 128, 128, [128, 60, 5]),  # head dim 128
])
def test_flash_bwd_plain_is_dq_and_dkv_plain(causal, T, D, vl):
    """The fused backward's plain version (and the wrapper on the CPU)
    returns exactly the dq and dk/dv plain versions' tensors, bf16."""
    B, H = 3, 2
    (_, q), (_, k), (_, v), (_, do) = _flash_case(T + D, B, H, T, D,
                                                  "bfloat16")
    tvl = None if vl is None else torch.tensor(vl, dtype=torch.int32)
    o, lse = fa.flash_attention_plain(q, k, v, kv_valid_len=tvl,
                                      causal=causal, return_lse=True)
    delta = (o.float() * do.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta)
    kw = {"kv_valid_len": tvl, "causal": causal}
    want_dq = fa.flash_attention_dq_plain(*args, **kw)
    want_dk, want_dv = fa.flash_attention_dkv_plain(*args, **kw)
    for got in (fa.flash_attention_bwd_plain(*args, **kw),
                fa.flash_attention_bwd(*args, **kw)):
        assert len(got) == 3
        for g, w in zip(got, (want_dq, want_dk, want_dv)):
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_seam_takes_differentiable_flash_only_when_recording():
    """With grad recording, the flash path runs the op whose forward keeps
    the lse (the ``mxnet_tpu_torch::flash_fwd`` op with its registered
    autograd formula); without it (serving), the forward alone."""
    _, q = _flash_case(1, 1, 2, 256, 64, "bfloat16")[0]
    k, v = q.clone(), q.clone()
    with torch.no_grad():
        assert tattn.scaled_dot_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    out = tattn.scaled_dot_attention(q, k, v)
    assert "mxnet_tpu_torch_flash_fwd" in type(out.grad_fn).__name__


# ---------------------------------------------------------- LayerNorm


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("R,C,eps", [
    pytest.param(64, 256, 1e-12, id="256"),
    pytest.param(64, 200, 1e-12, id="200"),
    # a GPT decode step's rows at its eps, and a C that is not a multiple
    # of 8
    pytest.param(8, 768, 1e-5, id="8x768-eps1e-05"),
    pytest.param(64, 100, 1e-12, id="100"),
])
def test_layernorm_grads_match_pallas(dtype, tol, R, C, eps):
    """The analytic backward (``_ln_bwd``) through both packages: dx in x's
    dtype, dgamma and dbeta in gamma's (fp32), fp32 within 1e-4 and bf16
    within 0.05 absolute (tests/test_kernels.py)."""
    rng = np.random.RandomState(C)
    x = (rng.randn(R, C) * 3 + 1).astype(np.float32)
    gamma = rng.randn(C).astype(np.float32)
    beta = rng.randn(C).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    _, vjp = jax.vjp(lambda a, g, b: jax_ln(a, g, b, eps, True), jx,
                     jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jdy)
    leaves = [tx.requires_grad_(), torch.from_numpy(gamma).requires_grad_(),
              torch.from_numpy(beta).requires_grad_()]
    got = _grads(ln.layernorm(*leaves, eps), leaves, tdy)
    assert got[0].dtype == _TDT[dtype] and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=tol,
                                   rtol=tol if g.dim() == 1 else 0)


def test_layernorm_bwd_wrapper_takes_plain_version_on_cpu():
    """On the CPU the backward wrapper is its plain version (bit-equal
    outputs) and counts no kernel launch."""
    rng = np.random.RandomState(3)
    x, dy = (torch.from_numpy(rng.randn(16, 96).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    gamma = torch.from_numpy(rng.randn(96).astype(np.float32))
    before = ln.fused_layernorm_bwd.launches
    got = ln.fused_layernorm_bwd(x, gamma, dy, 1e-5)
    want = ln.layernorm_bwd_plain(x, gamma, dy, 1e-5)
    assert ln.fused_layernorm_bwd.launches == before
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------- dense attention


def _prefix_mask(vl, T):
    return (np.arange(T)[None, None, None, :]
            < np.asarray(vl)[:, None, None, None]).astype(np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_backward_matches_jax(dtype, tol, causal):
    """The hand-written VJP ``_dense_attention_bwd`` through both packages:
    fp32 within 1e-4; bf16 within 0.05 absolute (its one cast of ds * scale
    and of p to bf16 on both sides)."""
    rng = np.random.RandomState(7)
    B, H, T, D = 3, 2, 48, 64
    arrs = [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = [_pair(a, dtype) for a in arrs]
    mask = _prefix_mask([48, 20, 1], T)
    bias = jattn._mask_bias(jnp.asarray(mask), causal, T, T)
    _, vjp = jax.vjp(lambda q, k, v: jattn._dense_attention_core(
        q, k, v, bias, 1.0 / 8), jq, jk, jv)
    want = vjp(jdo)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tattn.dense_attention(*leaves, torch.from_numpy(mask),
                                causal=causal)
    got = _grads(out, leaves, tdo)
    for g, w in zip(got, want):
        assert g.dtype == _TDT[dtype]
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=0)
