"""The kernels as ``torch.library`` ops (``torch.ops.mxnet_tpu_torch``) on
the CPU, where each op's implementation is its kernel's plain version:
``torch.library.opcheck`` of every op, each op against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs (fp32 1e-4,
bf16 0.05), the fakes' shapes and dtypes equal to the plain versions',
``meta`` tensors answered only inside ``shape_inference``, and a small
GPT's forward and backward through ``torch.compile(backend="aot_eager",
fullgraph=True)`` (one compile, module-scoped) equal to eager with equal
launch counters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mxnet_tpu.ops.pallas.flash_attention import _flash_fwd
from mxnet_tpu.ops.pallas.layernorm import fused_layernorm as jax_ln
from mxnet_tpu.ops.pallas.softmax_xent import softmax_xent as jax_xent
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from mxnet_tpu_torch.ops.cuda import launch_counters, shape_inference
from mxnet_tpu_torch.ops.cuda import layernorm as ln
from mxnet_tpu_torch.ops.cuda import softmax_xent as sx
from torch_port_helpers import SMALL_GPT, jax_trace_state  # noqa: F401

OPS = torch.ops.mxnet_tpu_torch


def _cases():
    """(op, args) of each op at small shapes, the differentiable inputs of
    the ops with a formula requiring grad."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 64, generator=g)
    gamma, beta = torch.randn(64, generator=g), torch.randn(64, generator=g)
    lg = torch.randn(16, 50, generator=g)
    lab = torch.randint(0, 50, (16,), generator=g).to(torch.int32)
    _, lse = sx.softmax_xent_fwd_plain(lg, lab)
    q, k, v = (torch.randn(2, 2, 32, 64, generator=g) for _ in range(3))
    vl = torch.tensor([32, 9], dtype=torch.int32)
    o, flse = fa.flash_attention_plain(q, k, v, None, 0.125, True,
                                       return_lse=True)
    do = torch.randn_like(q)
    delta = (o * do).sum(-1)
    qb, kb, vb = (t.to(torch.bfloat16).requires_grad_() for t in (q, k, v))
    return {
        "layernorm_fwd": (ln._layernorm_fwd_op,
                          (x.clone().requires_grad_(), gamma, beta, 1e-5)),
        "layernorm_bwd": (ln._layernorm_bwd_op, (x, gamma, x * 0.5, 1e-5)),
        "xent_fwd": (sx._xent_fwd_op, (lg.clone().requires_grad_(), lab)),
        "xent_bwd": (sx._xent_bwd_op, (lg, lab, lse, torch.rand(16))),
        "flash_fwd": (fa._flash_fwd_op, (qb, kb, vb, vl, 0.125, False,
                                         True)),
        "flash_fwd_f32": (fa._flash_fwd_f32_op, (q, k, v, None, 0.125,
                                                 True, False)),
        "flash_bwd": (fa._flash_bwd_op, (q, k, v, do, flse, delta, None,
                                         0.125, True)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_opcheck(name):
    op, args = _cases()[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_fake_shapes_and_dtypes_are_the_plain_versions(name):
    op, args = _cases()[name]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(t.shape), t.dtype) for t in fake] == \
        [(tuple(t.shape), t.dtype) for t in real]


def test_meta_tensors_only_inside_shape_inference():
    x = torch.empty(8, 64, device="meta", dtype=torch.bfloat16)
    g = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        OPS.layernorm_fwd(x, g, g, 1e-5)
    with shape_inference():
        y = OPS.layernorm_fwd(x, g, g, 1e-5)
        loss, lse = OPS.xent_fwd(x, torch.empty(8, dtype=torch.int32,
                                                device="meta"))
    assert y.shape == (8, 64) and y.dtype == torch.bfloat16
    assert loss.dtype == lse.dtype == torch.float32 and lse.shape == (8,)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_ops_match_pallas(dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(7)
    x = (rng.randn(32, 200) * 2 + 0.5).astype(np.float32)
    g, b = rng.randn(200).astype(np.float32), rng.randn(200).astype(
        np.float32)
    want = jax_ln(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b), 1e-5,
                  interpret=True)
    got = OPS.layernorm_fwd(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)
    lab = rng.randint(0, 200, 32).astype(np.int32)
    want = jax_xent(jnp.asarray(x, jdt), jnp.asarray(lab), interpret=True)
    loss, _ = OPS.xent_fwd(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(lab))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want, np.float32),
                               atol=tol)
    q, k, v = (rng.randn(2, 2, 64, 64).astype(np.float32) * 0.5
               for _ in range(3))
    want = _flash_fwd(*(jnp.asarray(t, jdt) for t in (q, k, v)), None,
                      0.125, True, 64, 64, interpret=True)
    op = OPS.flash_fwd_f32 if dtype == "float32" else OPS.flash_fwd
    out, lse = op(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), None,
                  0.125, True, False)
    assert lse.shape == (0,) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.fixture(scope="module")
def compiled_gpt():
    """The small GPT's loss through ``torch.compile(backend="aot_eager",
    fullgraph=True)`` (traced once) and eagerly, with the gradients and
    each run's launch counters."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.models.gpt import GPTModel

    model = GPTModel(**SMALL_GPT)
    model.initialize(device="cpu")
    params = list(model.collect_params().values())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(3)
    seq = torch.from_numpy(rng.randint(0, SMALL_GPT["vocab_size"],
                                       (2, 257)).astype(np.int32))
    x, y = seq[:, :-1], seq[:, 1:]

    def f(a, b):
        return loss_fn(model(a), b)

    runs = {}
    for name, fn in (("eager", f), ("compiled", torch.compile(
            f, backend="aot_eager", fullgraph=True))):
        for p in params:
            p.zero_grad()
        for c in launch_counters().values():
            c.launches = 0
        with autograd.record():
            loss = fn(x, y)
        autograd.backward(loss)
        runs[name] = (loss.detach(), [p._tensor().grad.clone()
                                      for p in params],
                      {k: c.launches for k, c in launch_counters().items()})
    return runs


def test_compiled_gpt_step_equals_eager(compiled_gpt):
    (le, ge, ce), (lc, gc, cc) = compiled_gpt["eager"], \
        compiled_gpt["compiled"]
    torch.testing.assert_close(lc, le, rtol=1e-5, atol=1e-5)
    for a, b in zip(gc, ge):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert cc == ce
