"""The port's vision ``F`` ops against the JAX package's, forward and
gradient: ``Convolution`` (1-3 d, groups, dilation, bias), ``Deconvolution``
(``adj``, groups), ``Pooling`` (max, avg, sum, global, ``count_include_pad``,
ties), ``BatchNorm`` (training, inference, ``fix_gamma``,
``use_global_stats``, another axis, the moving statistics), ``InstanceNorm``,
``GroupNorm``, every ``Activation`` and ``LeakyReLU`` type, ``flatten`` and
``clip``.

Inputs are made from a seed with numpy. A gradient is the JAX op's
``jax.vjp`` against torch's ``autograd.grad`` with the same cotangent.
Tolerances: fp32 within 1e-5 of the largest element (sums in another
order); bf16 within a relative L2 of 1e-2 (each output is rounded once to
bf16, 2**-9 of itself, from fp32 sums taken in another order and, for a
convolution, by another library's blocking). A bf16 parameter's gradient
(a weight's or a bias's, or gamma's, the sum over the batch and the
positions of a bf16 cotangent, which the JAX op accumulates in bf16)
within a relative L2 of 2**-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import functional as JF
from mxnet_tpu_torch.ops import functional as F
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

FP32_TOL = 1e-5
BF16_REL_L2 = 1e-2
BF16_PARAM_REL_L2 = 2.0 ** -5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, what="", rel_l2=BF16_REL_L2):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err <= FP32_TOL * scale, (what, err, scale)
    else:
        den = max(float(np.linalg.norm(want)), 1e-30)
        rel = float(np.linalg.norm(got - want)) / den
        assert rel <= rel_l2, (what, rel)


def _both(jfn, tfn, arrays, dtype, seed=0, diff=None, params=(),
          ref32=False):
    """Run ``jfn`` on jnp arrays and ``tfn`` on torch tensors made from the
    same numpy ``arrays``; compare the output and the gradient of every
    input whose index is in ``diff`` (default: all) under one cotangent.
    The inputs whose index is in ``params`` are parameters (their bf16
    gradient is held to ``BF16_PARAM_REL_L2``). With ``ref32`` a bf16 case
    takes the JAX op in fp32 on the same bf16-rounded inputs and
    cotangent as its reference."""
    diff = range(len(arrays)) if diff is None else diff
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jin = [jnp.asarray(a, jdt) for a in arrays]
    if ref32:
        jin = [a.astype(jnp.float32) for a in jin]
    tin = [torch.from_numpy(np.asarray(a, np.float32)).to(tdt)
           .requires_grad_(i in diff) for i, a in enumerate(arrays)]
    jout, vjp = jax.vjp(jfn, *jin)
    tout = tfn(*tin)
    assert tout.dtype == tdt
    _close(tout, jout, dtype, "output")
    cot = np.random.RandomState(seed + 99).randn(*jout.shape).astype(
        np.float32)
    cot = np.asarray(jnp.asarray(cot, jdt).astype(jnp.float32))
    jgrads = vjp(jnp.asarray(cot, jout.dtype))
    tgrads = torch.autograd.grad(
        tout, [tin[i] for i in diff],
        torch.from_numpy(cot).to(tout.dtype), allow_unused=True)
    for i, g in zip(diff, tgrads):
        if g is None:  # an input the op does not read (fix_gamma's gamma)
            g = torch.zeros_like(tin[i])
        _close(g, jgrads[i], dtype, "gradient %d" % i,
               BF16_PARAM_REL_L2 if i in params else BF16_REL_L2)
    return tout, jout


CONV_CASES = [
    # (x shape, weight shape, kwargs)
    ((2, 4, 9), (6, 4, 3), dict(stride=2, pad=1)),
    ((2, 4, 9, 8), (6, 4, 3, 3), dict(stride=1, pad=1)),
    ((2, 4, 9, 8), (6, 2, 3, 3), dict(stride=2, pad=1, num_group=2)),
    ((2, 4, 11, 10), (6, 4, 3, 2), dict(stride=(2, 1), pad=(2, 0),
                                        dilate=2)),
    ((1, 2, 5, 6, 5), (4, 2, 3, 3, 3), dict(stride=1, pad=1)),
    ((2, 6, 8, 8), (6, 1, 3, 3), dict(pad=1, num_group=6)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,kw", CONV_CASES)
def test_convolution_matches_jax(xs, ws, kw, dtype):
    """Forward and the gradients of x, weight and bias; the weight and
    bias are fp32 (an amp model's masters are bf16, its BatchNorm fp32:
    either way they are cast to x's dtype)."""
    rng = np.random.RandomState(len(xs) + ws[0])
    x, w = rng.randn(*xs), rng.randn(*ws) * 0.3
    b = rng.randn(ws[0])
    _both(lambda x, w, b: JF.Convolution(x, w, b, **kw),
          lambda x, w, b: F.Convolution(x, w, b, **kw), [x, w, b], dtype,
          params=(1, 2))


def test_convolution_checks_num_filter():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1)
    with pytest.raises(ValueError, match="num_filter"):
        F.Convolution(x, w, num_filter=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,ws,kw", [
    ((2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, pad=1, adj=1)),
    ((2, 4, 5, 5), (4, 3, 4, 4), dict(stride=2, pad=1)),
    ((2, 3, 7), (3, 5, 3), dict(stride=3, pad=0, adj=2)),
])
def test_deconvolution_matches_jax(xs, ws, kw, dtype):
    rng = np.random.RandomState(xs[-1])
    x, w, b = rng.randn(*xs), rng.randn(*ws) * 0.3, rng.randn(ws[1])
    _both(lambda x, w, b: JF.Deconvolution(x, w, b, **kw),
          lambda x, w, b: F.Deconvolution(x, w, b, **kw), [x, w, b], dtype,
          params=(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_deconvolution_matches_jax_per_group(dtype):
    """groups = 2 with ``adj``: the JAX op refuses a grouped weight (its
    (I, O / groups, k) layout against ``feature_group_count``, ROADMAP.md
    C.2), so the reference is its ungrouped op on each group's channels,
    concatenated; the port's grouped op must give the same, gradients
    included."""
    rng = np.random.RandomState(5)
    x, w = rng.randn(2, 4, 5, 6), rng.randn(4, 3, 3, 3) * 0.3
    kw = dict(stride=2, pad=1, adj=1)

    def jfn(x, w):
        return jnp.concatenate([
            JF.Deconvolution(x[:, 2 * g:2 * g + 2], w[2 * g:2 * g + 2], **kw)
            for g in range(2)], axis=1)

    t, _ = _both(jfn, lambda x, w: F.Deconvolution(x, w, num_group=2, **kw),
                 [x, w], dtype, params=(1,))
    assert t.shape == (2, 6, 10, 12)


def _tied(rng, shape):
    """relu of small integers: most of x is exactly 0, many windows hold
    ties (as after a relu in bf16), every sum exact."""
    return np.maximum(rng.randint(-3, 3, shape), 0).astype(np.float32)


POOL_CASES = [
    ((2, 3, 9, 8), dict(kernel=3, stride=2, pad=1, pool_type="max")),
    ((2, 3, 8, 8), dict(kernel=2, pool_type="max")),
    ((2, 3, 9, 8), dict(kernel=3, stride=2, pad=1, pool_type="avg")),
    ((2, 3, 9, 8), dict(kernel=3, stride=1, pad=1, pool_type="avg",
                        count_include_pad=False)),
    ((2, 3, 8, 9), dict(kernel=(2, 3), stride=(2, 2), pool_type="sum")),
    ((2, 3, 9), dict(kernel=3, stride=2, pad=1, pool_type="max")),
    ((2, 3, 9), dict(kernel=3, stride=2, pad=1, pool_type="avg",
                     count_include_pad=False)),
    ((1, 2, 5, 6, 5), dict(kernel=2, stride=2, pool_type="max")),
    ((1, 2, 5, 6, 5), dict(kernel=3, stride=1, pad=1, pool_type="avg")),
    ((2, 3, 5, 4), dict(pool_type="max", global_pool=True)),
    ((2, 3, 5, 4), dict(pool_type="avg", global_pool=True)),
    ((2, 3, 5, 4), dict(pool_type="sum", global_pool=True)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,kw", POOL_CASES)
def test_pooling_with_ties_matches_jax(xs, kw, dtype):
    """On relu'd small integers (ties in most windows) the forward and the
    gradient are exact, bf16 too: max pooling sends a window's gradient to
    its first largest element (row-major), as ``reduce_window``'s VJP does;
    a global max splits it among the ties, as ``jnp.max``'s does. The
    cotangent is made of small integers as well, so every gradient is an
    exact sum."""
    rng = np.random.RandomState(sum(xs))
    x = _tied(rng, xs)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    jout, vjp = jax.vjp(lambda a: JF.Pooling(a, **kw), jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tout = F.Pooling(tx, **kw)
    assert tout.dtype == tx.dtype
    cot = rng.randint(1, 4, jout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(cot, jdt))
    (tg,) = torch.autograd.grad(tout, tx, torch.from_numpy(cot).to(tx.dtype))
    exact = kw["pool_type"] == "max" or (
        kw["pool_type"] == "sum" and not kw.get("global_pool"))
    if exact:
        np.testing.assert_array_equal(_np(tout), _np(jout))
        np.testing.assert_array_equal(_np(tg), _np(jg))
    else:
        _close(tout, jout, dtype, "output")
        _close(tg, jg, dtype, "gradient")


def test_max_pooling_pads_with_minus_infinity():
    x = -torch.ones(1, 1, 2, 2) * 5
    y = F.Pooling(x, kernel=3, stride=1, pad=1, pool_type="max")
    assert torch.equal(y, x)


def _bn_inputs(rng, shape, axis=1):
    C = shape[axis]
    return (rng.randn(*shape) * 2 + 0.5, rng.rand(C) + 0.5, rng.randn(C),
            rng.randn(C) * 0.1, rng.rand(C) + 0.5)


def _bn_pair(training, **kw):
    def jfn(x, g, b, mm, mv):
        return JF.BatchNorm(x, g, b, mm, mv, training=training, **kw)

    def tfn(x, g, b, mm, mv):
        return F.BatchNorm(x, g, b, mm, mv, training=training, **kw)

    return jfn, tfn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", [
    ((4, 3, 5, 6), {}),
    ((4, 3, 5, 6), dict(fix_gamma=True, eps=1e-3, momentum=0.8)),
    ((4, 3, 5, 6), dict(use_global_stats=True)),
    ((4, 5, 3), dict(axis=2)),
    ((2, 4, 1, 1), {}),
])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(shape, kw, training, dtype):
    """y, and the gradients of x, gamma and beta (fp32 parameters, as amp
    keeps them), in training (batch statistics) and in inference (the
    moving ones); y comes back in x's dtype. The new moving statistics
    (fp32, biased batch variance, MXNet's momentum) within 1e-6 of the
    JAX op's, and unchanged outside training."""
    axis = kw.get("axis", 1)
    rng = np.random.RandomState(len(shape) + training)
    arrays = _bn_inputs(rng, shape, axis)
    jfn, tfn = _bn_pair(training, **kw)
    _both(lambda *a: jfn(*a)[0], lambda *a: tfn(*a)[0], arrays, dtype,
          diff=(0, 1, 2), params=(1, 2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx = jnp.asarray(arrays[0], jdt)
    tx = torch.from_numpy(arrays[0].astype(np.float32)).to(tdt)
    jp = [jnp.asarray(a, jnp.float32) for a in arrays[1:]]
    tp = [torch.from_numpy(a.astype(np.float32)) for a in arrays[1:]]
    _, jm, jv = jfn(jx, *jp)
    _, tm, tv = tfn(tx, *tp)
    assert tm.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-6, atol=1e-6)
    if not training or kw.get("use_global_stats"):
        assert tm is tp[2] and tv is tp[3]
    if kw.get("axis") == 2:
        # the port also takes the axis counted from the end (the JAX op
        # reduces over every axis then: ROADMAP.md C.2)
        kw2 = dict(kw, axis=-1)
        for a, b in zip(F.BatchNorm(tx, *tp, training=training, **kw2),
                        tfn(tx, *tp)):
            assert torch.equal(a, b)


def _bn_moving_var_agrees(bn):
    """Whether ``bn``'s new moving variance at N*H*W = 2 (a (2, C, 1, 1)
    batch: the unbiased variance there is twice the biased one) is the
    JAX op's within 1e-6."""
    rng = np.random.RandomState(7)
    x, g, b, mm, mv = _bn_inputs(rng, (2, 4, 1, 1))
    _, _, jv = JF.BatchNorm(*[jnp.asarray(a, jnp.float32)
                              for a in (x, g, b, mm, mv)],
                            training=True, momentum=0.5)
    _, _, tv = bn(*[torch.from_numpy(a.astype(np.float32))
                    for a in (x, g, b, mm, mv)],
                  training=True, momentum=0.5)
    return np.allclose(_np(tv), _np(jv), rtol=1e-6, atol=1e-6)


def _unbiased_moving_var(x, gamma, beta, mm, mv, *, training, momentum,
                         eps=1e-5):
    """A planted fault: torch's own training BatchNorm, whose moving
    variance takes the unbiased batch variance (its momentum is MXNet's
    1 - momentum)."""
    mm, mv = mm.clone(), mv.clone()
    y = torch.nn.functional.batch_norm(x, mm, mv, gamma, beta, training,
                                       1 - momentum, eps)
    return y, mm, mv


def test_batchnorm_moving_variance_is_biased_at_two_elements():
    """At N*H*W = 2 an unbiased moving variance is 2x off: the port's is
    the JAX op's, and the check reads the planted unbiased one as wrong."""
    assert _bn_moving_var_agrees(F.BatchNorm)
    assert not _bn_moving_var_agrees(_unbiased_moving_var)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_and_group_norm_match_jax(dtype):
    """Both compute in x's dtype, as the JAX ops: with fp32 gamma and beta
    the result is fp32."""
    rng = np.random.RandomState(11)
    x, g, b = rng.randn(2, 6, 5, 4) * 3 + 1, rng.rand(6) + 0.5, rng.randn(6)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for jfn, tfn in (
            (lambda x, g, b: JF.InstanceNorm(x, g, b, eps=1e-3),
             lambda x, g, b: F.InstanceNorm(x, g, b, eps=1e-3)),
            (lambda x, g, b: JF.GroupNorm(x, g, b, num_groups=3),
             lambda x, g, b: F.GroupNorm(x, g, b, num_groups=3))):
        jout, vjp = jax.vjp(jfn, jnp.asarray(x, jdt),
                            jnp.asarray(g, jnp.float32),
                            jnp.asarray(b, jnp.float32))
        tin = [torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
               .requires_grad_(),
               torch.from_numpy(g.astype(np.float32)).requires_grad_(),
               torch.from_numpy(b.astype(np.float32)).requires_grad_()]
        tout = tfn(*tin)
        assert str(tout.dtype).endswith(str(jout.dtype))
        _close(tout, jout, dtype, "output")
        cot = rng.randn(*jout.shape).astype(np.float32)
        jg = vjp(jnp.asarray(cot, jout.dtype))
        tg = torch.autograd.grad(tout, tin, torch.from_numpy(cot))
        for a, b_ in zip(tg, jg):
            _close(a, b_, dtype, "gradient")


ACT_TYPES = ["relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
             "gelu_tanh", "swish", "silu", "relu6"]


def _act_input(rng, shape):
    """Normal values with exact 0 and 6 planted (relu's and relu6's
    corners, where the gradient's rule at a tie shows)."""
    x = rng.randn(*shape) * 4
    x.flat[::7] = 0.0
    x.flat[3::11] = 6.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACT_TYPES)
def test_activation_matches_jax(act, dtype):
    """bf16 against the JAX op in fp32 on the same bf16 inputs: the JAX
    op's own bf16 evaluation of sigmoid's derivative s (1 - s) rounds s to
    a bf16 step of 2**-9 near 1, so its gradient at |x| ~ 10 is wrong by
    far more than the port's, which takes the derivative in fp32."""
    rng = np.random.RandomState(len(act))
    x = _act_input(rng, (4, 33))
    _both(lambda a: JF.Activation(a, act_type=act),
          lambda a: F.Activation(a, act_type=act), [x], dtype, ref32=True)


def test_activation_refuses_unknown_type():
    with pytest.raises(ValueError, match="act_type"):
        F.Activation(torch.zeros(2), act_type="nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,kw", [("leaky", dict(slope=0.1)),
                                    ("elu", dict(slope=0.7)),
                                    ("selu", {}), ("gelu", {})])
def test_leaky_relu_matches_jax(act, kw, dtype):
    rng = np.random.RandomState(3)
    x = _act_input(rng, (4, 5, 6))
    _both(lambda a: JF.LeakyReLU(a, act_type=act, **kw),
          lambda a: F.LeakyReLU(a, act_type=act, **kw), [x], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_matches_jax(dtype):
    """The per-channel slope on axis 1, and its gradient."""
    rng = np.random.RandomState(4)
    x, g = _act_input(rng, (2, 5, 3, 3)), rng.rand(5)
    _both(lambda a, g: JF.LeakyReLU(a, g, act_type="prelu"),
          lambda a, g: F.LeakyReLU(a, g, act_type="prelu"), [x, g], dtype,
          params=(1,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_and_flatten_match_jax(dtype):
    """clip's gradient at a bound is split as JAX's max and min split it."""
    rng = np.random.RandomState(6)
    x = np.round(rng.randn(3, 4, 5) * 2)   # many values exactly at +-1
    _both(lambda a: JF.clip(a, -1.0, 1.0), lambda a: F.clip(a, -1.0, 1.0),
          [x], dtype)
    _both(JF.flatten, F.flatten, [x], dtype)
    assert F.flatten(torch.zeros(3, 4, 5)).shape == (3, 20)
