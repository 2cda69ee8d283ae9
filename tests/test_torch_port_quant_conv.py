"""The port's quantized convolution against the JAX package's on the CPU:
``F.quantized_conv`` (the int8 accumulator exact, so bit for bit with the
JAX op; fp8 within 1e-6 of the sum of the product's absolute terms),
``quantize_model`` swapping every ``Conv2D`` of a small ResNet for a
``QuantizedConv2D`` (int8 under every mode, as the JAX package), with the
JAX names, dtypes and grad_req, the calibrated quantized ResNet's logits
against the JAX one's, and its parameter files both ways.

The JAX functions run op by op, as in ``test_torch_port_quant.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import quantization as jq
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ops import functional as F
from mxnet_tpu_torch.ops import lowbit
from mxnet_tpu_torch.util import to_tensor
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

CONVS = [
    # (x shape, weight shape, kwargs)
    ((2, 5, 9, 8), (12, 5, 3, 3), dict(stride=1, pad=1)),
    ((2, 5, 11, 10), (12, 5, 7, 7), dict(stride=2, pad=3)),
    ((2, 6, 9, 8), (8, 3, 3, 3), dict(stride=2, pad=1, num_group=2)),
    ((2, 4, 9, 9), (4, 1, 3, 3), dict(stride=1, pad=1, num_group=4)),
    ((2, 5, 11, 10), (6, 5, 3, 2), dict(stride=(2, 1), pad=(2, 0),
                                        dilate=2)),
    ((2, 5, 13), (6, 5, 3), dict(stride=2, pad=1)),
    ((2, 32, 7, 7), (40, 32, 1, 1), {}),
]


def _x(seed, shape, bf16):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2.0
    jx = jnp.asarray(x)
    if bf16:
        jx = jx.astype(jnp.bfloat16)
        return jx, to_tensor(np.asarray(jx))
    return jx, torch.from_numpy(x)


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("xs,ws,kw", CONVS)
def test_int8_quantized_conv_bit_equal_to_jax(xs, ws, kw, bf16, calibrated):
    """The int8 output (and so its int32 accumulator) bit for bit, with a
    bias, dynamic or with a calibrated activation scale; 1-d and 2-d,
    strides, padding, dilation, groups and depthwise."""
    jx, tx = _x(len(xs) + ws[0], xs, bf16)
    w = np.random.RandomState(ws[-1]).randn(*ws).astype(np.float32)
    b = np.random.RandomState(7).randn(ws[0]).astype(np.float32)
    jqw, jws = jq.quantize_weight(jnp.asarray(w), 0, "int8")
    tqw, tws = tq.quantize_weight(torch.from_numpy(w), 0, "int8")
    xs_ = 0.017 if calibrated else None
    want = np.asarray(jq.quantized_conv(jx, jqw, jws, jnp.asarray(b),
                                        x_scale=xs_, **kw))
    got = F.quantized_conv(tx, tqw, tws, torch.from_numpy(b),
                           x_scale=None if xs_ is None
                           else torch.tensor(xs_), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_conv_accumulator_is_the_integer_product():
    """The accumulator equals the fp64 convolution of the same int8
    operands (exact: every sum is an integer far below 2**53)."""
    rng = np.random.RandomState(1)
    qx = torch.from_numpy(rng.randint(-127, 128, (2, 6, 9, 8)).astype(
        np.int8))
    qw = torch.from_numpy(rng.randint(-127, 128, (8, 3, 3, 3)).astype(
        np.int8))
    acc = lowbit.quantized_conv_acc(qx, qw, stride=2, pad=1, num_group=2)
    ref = torch.nn.functional.conv2d(qx.double(), qw.double(), stride=2,
                                     padding=1, groups=2)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.to(torch.int64), ref.to(torch.int64))


@pytest.mark.parametrize("mode", ["e4m3", "e5m2"])
def test_fp8_quantized_conv_matches_jax(mode):
    """fp8 weights (the route ``ops/lowbit.py`` takes for the mode): within
    1e-6 of the sum of the product's absolute terms (fp32 sums in another
    order)."""
    jx, tx = _x(2, (2, 5, 9, 8), False)
    w = np.random.RandomState(3).randn(12, 5, 3, 3).astype(np.float32)
    jqw, jws = jq.quantize_weight(jnp.asarray(w), 0, mode)
    tqw, tws = tq.quantize_weight(torch.from_numpy(w), 0, mode)
    want = np.asarray(jq.quantized_conv(jx, jqw, jws, pad=1))
    got = F.quantized_conv(tx, tqw, tws, pad=1).numpy()
    qmax = tq._QMAX[mode]
    x = np.asarray(jx)
    x_scale = max(np.abs(x).max(), 1e-8) / qmax
    terms = torch.nn.functional.conv2d(
        torch.from_numpy(np.abs(np.clip(x / x_scale, -qmax, qmax))),
        torch.from_numpy(np.abs(np.asarray(jqw.astype(jnp.float32)))),
        padding=1).numpy() * x_scale * np.asarray(jws).reshape(1, -1, 1, 1)
    assert np.all(np.abs(got - want) <= 1e-6 * terms + 1e-7)


def _resnets(x):
    jm = jvision.get_resnet(1, 18, classes=10, thumbnail=True)
    jm.initialize()
    jm(mx.nd.array(x))
    tm = from_jax_params(vision.get_resnet(1, 18, classes=10,
                                           thumbnail=True), jax_params(jm))
    return jm, tm


@pytest.mark.parametrize("mode", ["int8", "e4m3"])
def test_quantize_model_swaps_every_conv2d(jax_trace_state, mode):  # noqa: F811
    """Every Conv2D of a thumbnail resnet18_v1 becomes a QuantizedConv2D
    with int8 weights, in an fp8 mode too (fp8 takes only the Dense), the
    Dense a QuantizedDense of the mode; the names, dtypes and grad_req are
    the JAX package's, and a second call keeps the layers."""
    x = np.zeros((1, 3, 32, 32), np.float32)
    jm, tm = _resnets(x)
    n_conv = sum(isinstance(b, tnn.Conv2D) for b in tm.modules())
    jq.quantize_model(jm, mode=mode)
    tq.quantize_model(tm, mode=mode)
    convs = [b for b in tm.modules() if isinstance(b, tq.QuantizedConv2D)]
    assert n_conv == len(convs) == 20
    assert not any(isinstance(b, tnn.Conv2D) for b in tm.modules())
    assert all(c.qweight._tensor().dtype == torch.int8 for c in convs)
    dense = [b for b in tm.modules() if isinstance(b, tq.QuantizedDense)]
    assert len(dense) == 1
    assert dense[0].qweight._tensor().dtype == tq.quant_dtype(mode)
    jn = {n: str(np.asarray(p.data()._data).dtype)
          for n, p in jm._collect_params_with_prefix().items()}
    tn = {n: str(p._tensor().dtype).replace("torch.", "")
          for n, p in tm._collect_params_with_prefix().items()}
    assert tn == jn
    for layer in convs:
        for p in layer.collect_params().values():
            assert p.grad_req == "null" and not p._tensor().requires_grad
    assert tq.stats()["quantized_layers"] == 21
    tq.quantize_model(tm, mode=mode)
    assert [b for b in tm.modules()
            if isinstance(b, tq.QuantizedConv2D)] == convs


def test_calibrated_int8_resnet_matches_jax(jax_trace_state, tmp_path):  # noqa: F811
    """A thumbnail resnet18_v1 quantized to int8 with naive calibration on
    the same batch in both packages. The first convolution's activation
    scale (the amax of the input itself) bit for bit. Each int8 product is
    exact, but every later layer's input is an fp32 BatchNorm's output,
    rounded in each package's own order, which can move a quantized
    activation by one step (1/127 of the layer's range), and a random
    deep network carries such a step on, so the later scales are held
    within 1e-2. With the JAX package's scales in both, most samples'
    logits are bit for bit the JAX ones, and every sample's within 2e-2 of
    the largest (one flipped step of 1/127 of a late layer's range moves
    them that far). The quantized parameter files cross both ways with
    every bit."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    jm, tm = _resnets(x)
    jq.quantize_model(jm, calib_mode="naive", calib_data=[mx.nd.array(x)])
    tq.quantize_model(tm, calib_mode="naive", calib_data=[x])
    jl = {b.prefix[len(jm.prefix):]: b for b in jq._quantized_layers(jm, [])}
    tl = {b.prefix[len(tm.prefix):]: b for b in tq._quantized_layers(tm, [])}
    assert len(tl) == 21 and tl.keys() == jl.keys()
    np.testing.assert_array_equal(tl["conv2d0_"]._x_scale.numpy(),
                                  np.float32(jl["conv2d0_"]._x_scale))
    for name, b in tl.items():
        want = np.float32(jl[name]._x_scale)
        np.testing.assert_allclose(b._x_scale.numpy(), want, rtol=1e-2,
                                   err_msg=name)
        b._x_scale = torch.tensor(want)
    jy = np.asarray(jm(mx.nd.array(x)).asnumpy())
    ty = tm(torch.from_numpy(x)).numpy()
    same = [bool(np.array_equal(a, b)) for a, b in zip(ty, jy)]
    assert sum(same) > len(same) // 2, same
    assert np.abs(ty - jy).max() <= 2e-2 * np.abs(jy).max()
    path = str(tmp_path / "q.params")
    tm.save_parameters(path)
    jm.load_parameters(path)
    jm.save_parameters(path)
    tm.load_parameters(path)
    for n, p in tm._collect_params_with_prefix().items():
        jp = jm._collect_params_with_prefix()[n]
        a = p._tensor().detach().cpu().reshape(-1)
        assert np.array_equal(a.view(torch.uint8).numpy() if a.dtype ==
                              torch.int8 else a.numpy(),
                              np.asarray(jp.data()._data).reshape(-1)
                              .view(np.uint8) if a.dtype == torch.int8
                              else np.asarray(jp.data()._data).reshape(-1)), n
