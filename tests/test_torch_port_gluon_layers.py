"""The port's Gluon layers against the JAX package's, each block through
``from_jax_params`` (the JAX layer's own parameters carried over by name):
the convolutions and their transposed forms, the twelve pooling classes,
``ReflectionPad2D``, the containers and lambdas, ``BatchNorm`` (training
inside ``autograd.record()``, moving its statistics in place; inference),
``InstanceNorm``, ``GroupNorm``, the activation blocks, ``Dropout(axes=)``;
``amp``'s norm rule; and the initializers: the deterministic ones
(``Constant``, ``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``Mixed``,
``Load``) exactly, the random ones (``Xavier``, ``MSRAPrelu``) by their
distribution (seeded streams cannot match JAX's threefry).

Inputs are made from a seed with numpy; fp32 within 1e-5 of the largest
element (sums in another order), parameter gradients within 1e-4 in
relative L2.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd, initializer
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import nn
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.asnumpy(), np.float32)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def _heads(x, seed=1):
    """A fixed random weighting of an output (the head of a backward): with
    the plain sum, gamma's gradient through a normalization is 0 up to
    rounding."""
    w = np.random.RandomState(seed).randn(*x.shape).astype(np.float32)
    return mx.nd.array(w), torch.from_numpy(w)


def _pair(make, x, record=False):
    """(JAX block, port block with its parameters, JAX output, port output)
    for ``make(module)`` on the numpy input x; inside ``record()`` when
    asked (training)."""
    jb = make(jnn)
    jb.initialize()
    tb = make(nn)
    jx = mx.nd.array(x)
    tx = torch.from_numpy(x)
    if record:
        jb(jx)      # materialize the deferred shapes, then carry over
        if list(jb.collect_params().values()):
            from_jax_params(tb, jax_params(jb))
        with jag.record():
            jy = jb(jx)
        with autograd.record():
            ty = tb(tx)
        return jb, tb, jy, ty
    jy = jb(jx)
    if list(jb.collect_params().values()):
        from_jax_params(tb, jax_params(jb))
    return jb, tb, jy, tb(tx)


CONV_LAYERS = [
    ("Conv1D", (2, 3, 11), dict(channels=4, kernel_size=3, strides=2,
                               padding=1, activation="relu")),
    ("Conv2D", (2, 3, 9, 8), dict(channels=4, kernel_size=3, padding=1,
                                  dilation=2, use_bias=False)),
    ("Conv2D", (2, 4, 9, 8), dict(channels=6, kernel_size=(3, 1),
                                  strides=(2, 1), groups=2)),
    ("Conv3D", (1, 2, 5, 6, 5), dict(channels=3, kernel_size=3, padding=1)),
    ("Conv1DTranspose", (2, 3, 7), dict(channels=4, kernel_size=3,
                                        strides=2, output_padding=1)),
    ("Conv2DTranspose", (2, 3, 5, 4), dict(channels=4, kernel_size=4,
                                           strides=2, padding=1,
                                           in_channels=3)),
    ("Conv3DTranspose", (1, 2, 3, 4, 3), dict(channels=3, kernel_size=2,
                                              strides=2)),
]


@pytest.mark.parametrize("cls,shape,kw", CONV_LAYERS,
                         ids=[c[0] + str(i) for i, c in enumerate(CONV_LAYERS)])
def test_conv_layers_match_jax(jax_trace_state, cls, shape, kw):  # noqa: F811
    """Forward, and under ``record()`` the weight's and bias's gradients
    (the output's sum as the head)."""
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    jb, tb, jy, ty = _pair(lambda m: getattr(m, cls)(**kw), x)
    _close(ty, jy, cls)
    assert tb.weight.shape == jb.weight.shape
    jw, tw = _heads(ty)
    with jag.record():
        jl = (jb(mx.nd.array(x)) * jw).sum()
    jag.backward(jl)
    with autograd.record():
        tl = (tb(torch.from_numpy(x)) * tw).sum()
    autograd.backward(tl)
    for name in ("weight", "bias"):
        jp, tp = getattr(jb, name, None), getattr(tb, name, None)
        if jp is None:
            assert tp is None
            continue
        a, b = _np(tp._tensor().grad), _np(jp.grad())
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name


POOL_LAYERS = [
    ("MaxPool1D", (2, 3, 9), dict(pool_size=3, strides=2, padding=1)),
    ("MaxPool2D", (2, 3, 9, 8), dict(pool_size=3, strides=2, padding=1)),
    ("MaxPool3D", (1, 2, 4, 6, 4), dict()),
    ("AvgPool1D", (2, 3, 9), dict(pool_size=3, strides=2,
                                  count_include_pad=False, padding=1)),
    ("AvgPool2D", (2, 3, 9, 8), dict(pool_size=2)),
    ("AvgPool3D", (1, 2, 4, 6, 4), dict(pool_size=2, strides=1)),
    ("GlobalMaxPool1D", (2, 3, 9), {}),
    ("GlobalMaxPool2D", (2, 3, 9, 8), {}),
    ("GlobalMaxPool3D", (1, 2, 4, 6, 4), {}),
    ("GlobalAvgPool1D", (2, 3, 9), {}),
    ("GlobalAvgPool2D", (2, 3, 9, 8), {}),
    ("GlobalAvgPool3D", (1, 2, 4, 6, 4), {}),
]


@pytest.mark.parametrize("cls,shape,kw", POOL_LAYERS,
                         ids=[c[0] for c in POOL_LAYERS])
def test_pool_layers_match_jax(jax_trace_state, cls, shape, kw):  # noqa: F811
    """Every pooling class; ``ceil_mode`` is accepted and the size follows
    floor, as in the JAX package."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    _, _, jy, ty = _pair(lambda m: getattr(m, cls)(**kw), x)
    _close(ty, jy, cls)
    y = nn.MaxPool2D(3, 2, ceil_mode=True)(torch.zeros(1, 1, 8, 8))
    assert y.shape == (1, 1, 3, 3)


def test_reflection_pad_and_containers_match_jax(jax_trace_state):  # noqa: F811
    """``ReflectionPad2D`` (int and 8-tuple), ``Sequential`` and
    ``HybridSequential`` (with slicing), ``Flatten``, ``Lambda`` and
    ``HybridLambda`` (an ``F`` op's name and a function)."""
    x = np.random.RandomState(4).randn(2, 3, 5, 6).astype(np.float32)
    for pad in (2, (0, 0, 0, 0, 1, 2, 2, 1)):
        _, _, jy, ty = _pair(lambda m: m.ReflectionPad2D(pad), x)
        _close(ty, jy, "ReflectionPad2D %s" % (pad,))

    def seq(m, hybrid):
        s = (m.HybridSequential if hybrid else m.Sequential)()
        with s.name_scope():
            s.add(m.Conv2D(4, 3, padding=1), m.BatchNorm(),
                  m.Activation("relu"), m.MaxPool2D(), m.Flatten(),
                  m.Dense(5))
        return s

    for hybrid in (False, True):
        jb, tb, jy, ty = _pair(lambda m: seq(m, hybrid), x)
        _close(ty, jy, "sequential")
        assert len(tb) == 6 and isinstance(tb[1], nn.BatchNorm)
        head = tb[:3]
        assert len(head) == 3 and type(head) is type(tb)
        _close(head(torch.from_numpy(x)), jb[:3](mx.nd.array(x)), "slice")
    for make in (lambda m: m.Lambda("flatten"),
                 lambda m: m.Lambda(lambda a: a * 2),
                 lambda m: m.HybridLambda("sigmoid"),
                 lambda m: m.HybridLambda(lambda F, a: F.flatten(a))):
        _, _, jy, ty = _pair(make, x)
        _close(ty, jy, "lambda")


@pytest.mark.parametrize("kw", [{}, dict(scale=False, center=False),
                                dict(momentum=0.7, epsilon=1e-3),
                                dict(use_global_stats=True)])
def test_batchnorm_block_matches_jax(jax_trace_state, kw):  # noqa: F811
    """Inside ``record()`` (training) the batch statistics normalize and
    the moving ones move, in the same tensors (their addresses kept, as a
    server's captured graphs need); gamma's and beta's gradients; outside
    it the moving statistics normalize and stay."""
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 3, 5, 6) * 2 + 1).astype(np.float32)
    jb, tb, jy, ty = _pair(lambda m: m.BatchNorm(**kw), x, record=True)
    addr = (tb.running_mean._tensor().data_ptr(),
            tb.running_var._tensor().data_ptr())
    jb2, tb2, jy0, ty0 = _pair(lambda m: m.BatchNorm(**kw), x)
    _close(ty0, jy0, "inference")
    _close(ty, jy, "training")
    for name in ("running_mean", "running_var"):
        _close(getattr(tb, name)._tensor(), getattr(jb, name).data(), name)
    assert (tb.running_mean._tensor().data_ptr(),
            tb.running_var._tensor().data_ptr()) == addr
    moved = not kw.get("use_global_stats")
    assert moved == (not np.allclose(_np(tb.running_mean._tensor()), 0.0))
    if tb.gamma.grad_req != "null":
        jw, tw = _heads(ty)
        jag.backward(jy, jw)
        autograd.backward(ty, tw)
    for name in ("gamma", "beta"):
        if getattr(tb, name).grad_req == "null":
            continue
        a = _np(getattr(tb, name)._tensor().grad)
        b = _np(getattr(jb, name).grad())
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name
    # outside record(): the moving statistics normalize and do not move
    before = tb.running_mean._tensor().clone()
    _close(tb(torch.from_numpy(x)), jb(mx.nd.array(x)), "inference after")
    assert torch.equal(tb.running_mean._tensor(), before)


@pytest.mark.parametrize("make", [
    lambda m: m.InstanceNorm(epsilon=1e-3),
    lambda m: m.GroupNorm(num_groups=3),
    lambda m: m.LeakyReLU(0.2), lambda m: m.PReLU(in_channels=6),
    lambda m: m.ELU(0.8), lambda m: m.SELU(), lambda m: m.GELU(),
    lambda m: m.Swish(1.5), lambda m: m.Activation("softrelu"),
    lambda m: m.Dropout(0.5, axes=(2, 3)),
], ids=["instancenorm", "groupnorm", "leakyrelu", "prelu", "elu", "selu",
        "gelu", "swish", "activation", "dropout_axes"])
def test_norm_and_activation_blocks_match_jax(jax_trace_state, make):  # noqa: F811
    """Each block's forward; a parameter's gradient (gamma, beta, PReLU's
    alpha). ``Dropout(axes=)`` is accepted (the identity outside
    ``record()``)."""
    x = np.random.RandomState(6).randn(2, 6, 4, 5).astype(np.float32)
    jb, tb, jy, ty = _pair(make, x)
    _close(ty, jy)
    if not list(jb.collect_params().values()):
        return
    jw, tw = _heads(ty)
    with jag.record():
        jl = (jb(mx.nd.array(x)) * jw).sum()
    jag.backward(jl)
    with autograd.record():
        tl = (tb(torch.from_numpy(x)) * tw).sum()
    autograd.backward(tl)
    jp = {p.name[len(jb.prefix):]: p for p in jb.collect_params().values()}
    for p in tb.collect_params().values():
        local = p.name[len(tb.prefix):]
        a, b = _np(p._tensor().grad), _np(jp[local].grad())
        assert np.linalg.norm(a - b) <= 1e-4 * max(np.linalg.norm(b), 1e-6), \
            local


def test_dropout_axes_draws_per_element_in_training():
    """As in the JAX package, ``axes`` shares nothing: the mask is drawn
    per element (ROADMAP.md C.2)."""
    drop = nn.Dropout(0.5, axes=(2, 3))
    with autograd.record():
        y = drop(torch.ones(2, 3, 16, 16))
    kept = (y != 0).float()
    assert 0.3 < float(kept.mean()) < 0.7
    assert not torch.equal(kept[0, 0], kept[0, 1])


def test_amp_keeps_every_norm_in_fp32():
    """``convert_hybrid_block`` casts to bf16 and keeps BatchNorm (its
    moving statistics too), InstanceNorm, GroupNorm and LayerNorm fp32, as
    the JAX package's ``_fix_norms``."""
    def net(m):
        s = m.HybridSequential()
        with s.name_scope():
            s.add(m.Conv2D(4, 3, in_channels=3), m.BatchNorm(in_channels=4),
                  m.InstanceNorm(in_channels=4), m.GroupNorm(2, in_channels=4),
                  m.LayerNorm(in_channels=4), m.Dense(3, in_units=4))
        return s

    jb, tb = net(jnn), net(nn)
    jb.initialize()
    tb.initialize(device="cpu")
    jamp.convert_hybrid_block(jb, "bfloat16")
    tamp.convert_hybrid_block(tb, "bfloat16")
    jd = {p.name[len(jb.prefix):]: str(p.data().dtype)
          for p in jb.collect_params().values()}
    td = {p.name[len(tb.prefix):]: str(p._tensor().dtype).replace("torch.", "")
          for p in tb.collect_params().values()}
    assert td == jd
    assert td["batchnorm0_running_var"] == "float32"
    assert td["conv2d0_weight"] == "bfloat16"


def _jax_init(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(jinit.InitDesc(name), arr)
    return arr.asnumpy()


def _port_init(init, name, shape, seed=0):
    return init(name, shape, torch.float32, torch.device("cpu"),
                torch.Generator().manual_seed(seed)).numpy()


@pytest.mark.parametrize("make,shape", [
    (lambda I: I.Constant(0.37), (3, 4)),
    (lambda I: I.Orthogonal(), (6, 4)),
    (lambda I: I.Orthogonal(scale=0.5, rand_type="normal"), (3, 2, 2, 2)),
    (lambda I: I.Bilinear(), (2, 1, 4, 4)),
    (lambda I: I.LSTMBias(forget_bias=2.0), (16,)),
    (lambda I: I.One(), (2, 3)),
], ids=["constant", "orthogonal", "orthogonal_normal", "bilinear",
        "lstmbias", "one"])
def test_deterministic_initializers_equal_jax(make, shape):
    """The same values, bit for bit, under a weight's name; LSTMBias also
    under a bias's."""
    for name in ("w_weight", "lstm_bias") if shape == (16,) \
            else ("w_weight",):
        np.testing.assert_array_equal(
            _port_init(make(initializer), name, shape),
            _jax_init(make(jinit), name, shape))


def test_naming_rules_and_mixed_and_load_equal_jax():
    """bias/beta/running_mean zero, gamma/running_var one whatever the
    initializer; ``Mixed`` by the first matching pattern; ``Load`` from a
    dict (a name's ``arg:`` prefix dropped), ``default_init`` for the
    rest: the port alone, as the JAX package's ``Load`` fails on a dict of
    numpy arrays (it names ``numpy``, which it does not import; ROADMAP.md
    C.2)."""
    for name in ("a_bias", "a_beta", "a_gamma", "bn_running_mean",
                 "bn_running_var", "x_moving_var"):
        np.testing.assert_array_equal(
            _port_init(initializer.Constant(5.0), name, (3,)),
            _jax_init(jinit.Constant(5.0), name, (3,)))
    pats, names = [".*bias", ".*"], ["fc_bias", "fc_weight"]
    tm = initializer.Mixed(pats, [initializer.Constant(2.0),
                                  initializer.Orthogonal()])
    jm = jinit.Mixed(pats, [jinit.Constant(2.0), jinit.Orthogonal()])
    for name in names:
        np.testing.assert_array_equal(_port_init(tm, name, (4, 3)),
                                      _jax_init(jm, name, (4, 3)))
    saved = {"fc_weight": np.arange(12, dtype=np.float32).reshape(4, 3)}
    for name in ("fc_weight", "arg:fc_weight"):
        got = _port_init(initializer.Load(saved, initializer.Constant(1.0)),
                         name, (4, 3))
        np.testing.assert_array_equal(got, saved["fc_weight"])
    got = _port_init(initializer.Load({}, initializer.Constant(1.0)),
                     "other_weight", (2,))
    np.testing.assert_array_equal(got, np.ones(2, np.float32))
    with pytest.raises(ValueError, match="shape"):
        _port_init(initializer.Load(saved), "fc_weight", (3, 4))
    assert isinstance(initializer.create("xavier", magnitude=2),
                      initializer.Xavier)


@pytest.mark.parametrize("rnd_type,factor_type,magnitude", [
    ("uniform", "avg", 3), ("gaussian", "in", 2), ("uniform", "out", 1)])
def test_xavier_draws_the_jax_distribution(rnd_type, factor_type, magnitude):
    """Xavier on a conv weight (fans count the kernel): both packages'
    draws lie within the same bound (uniform) and have the same standard
    deviation within 3% (2e4 samples: the sample std's own spread is under
    1%); MSRAPrelu is Xavier gaussian with magnitude 2 / (1 + slope**2)."""
    shape = (64, 32, 3, 3)
    t = _port_init(initializer.Xavier(rnd_type, factor_type, magnitude),
                   "c_weight", shape)
    j = _jax_init(jinit.Xavier(rnd_type, factor_type, magnitude),
                  "c_weight", shape)
    fan_in, fan_out = 32 * 9, 64 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = np.sqrt(magnitude / factor)
    std = scale / np.sqrt(3) if rnd_type == "uniform" else scale
    for a in (t, j):
        assert abs(a.std() / std - 1) < 0.03
        assert abs(a.mean()) < 0.03 * std
        if rnd_type == "uniform":
            assert np.abs(a).max() <= scale
    m = _port_init(initializer.MSRAPrelu(slope=0.5), "c_weight", shape)
    assert abs(m.std() / np.sqrt(2 / 1.25 / ((fan_in + fan_out) / 2)) - 1) \
        < 0.03
