"""C.13: calibration batches may be NDArrays. ``quantize_model(net,
calib_mode=..., calib_data=[nd.array(...)])``, as
``examples/quantize_int8.py`` calls it, runs on the port, and its frozen
activation scales equal the JAX package's from the same weights and
batches (a conv net and a Dense stack, naive and entropy); the int8
forward agrees with the JAX package's."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import quantization as jq
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.convert import from_jax_params
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")


def _conv_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3))
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=8))
        net.add(nn.Flatten())
        net.add(nn.Dense(10, in_units=8 * 8 * 8))
    return net


def _batches(seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(4, 3, 8, 8).astype(np.float32) * (i + 1)
            for i in range(n)]


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_ndarray_calibration_scales_equal_jax(jax_trace_state, mode):
    jnet = _conv_net(jmx)
    jnet.initialize()
    with mx.cpu():
        tnet = from_jax_params(_conv_net(mx), jax_params(jnet))
        batches = _batches(11)
        jq.quantize_model(jnet, calib_mode=mode, num_bins=2001,
                          calib_data=[jmx.nd.array(b) for b in batches])
        tq.quantize_model(tnet, calib_mode=mode, num_bins=2001,
                          calib_data=[mx.nd.array(b) for b in batches])
    jl, tl = jq._quantized_layers(jnet, []), tq._quantized_layers(tnet, [])
    assert len(jl) == len(tl) == 3
    # the first layer sees the same input: its threshold is exact; later
    # layers see the previous layer's int8 output, equal in both
    got = [float(t._x_scale) for t in tl]
    want = [float(np.float32(j._x_scale)) for j in jl]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    x = _batches(12, 1)[0]
    with torch.no_grad():
        y = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, jnet(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-4, atol=1e-4)


def test_example_recipe_runs():
    """``examples/quantize_int8.py``'s calls, NDArray batches and all, on
    the CPU."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    with mx.cpu():
        net = get_resnet(1, 18, classes=10, thumbnail=True)
        net.initialize()
        rng = np.random.RandomState(0)
        calib = [mx.nd.array(rng.randn(2, 3, 32, 32).astype(np.float32))
                 for _ in range(2)]
        ref = net(calib[0]).asnumpy()
        tq.quantize_model(net, calib_mode="entropy", calib_data=calib)
        net.hybridize()
        out = net(calib[0]).asnumpy()
    assert out.shape == ref.shape == (2, 10)
    assert np.isfinite(out).all()
    assert (out.argmax(1) == ref.argmax(1)).mean() >= 0.5
    assert all(l._x_scale is not None
               for l in tq._quantized_layers(net, []))
