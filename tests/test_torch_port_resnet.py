"""The port's ResNets against the JAX package's: v1, v2 and v1b at depths
18 and 34 (forward in inference and in training, the moving statistics),
every gradient of ``resnet18_v2``, and parameter files crossing between
the packages both ways. ``tests/test_torch_port_resnet_step.py`` holds a
ResNet-50 v1 training step.

A deep post-activation ResNet at random weights is chaotic at small
batches (see that file); ``resnet18_v2`` (pre-activation, thumbnail,
batch 4) is well conditioned at its random start: the port's own
gradients move by about 4e-6 when its input moves by 1e-6, so it holds
every gradient of a whole network at fp32 tolerances.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from torch_port_helpers import f32 as _f32
from torch_port_helpers import jax_class_step as _jax_step
from torch_port_helpers import local_params as _local
from torch_port_helpers import port_class_step as _port_step
from torch_port_helpers import rel_l2 as _rel_l2
from torch_port_helpers import jax_params, jax_trace_state  # noqa: F401

SGD = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True,
       "wd": 1e-4}
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _pair(name, x, **kw):
    """The JAX zoo model ``name`` initialized and shaped by one forward of
    x, and the port's with its parameters."""
    jm = jvision.get_model(name, **kw)
    jm.initialize()
    jm(mx.nd.array(x))
    return jm, from_jax_params(vision.get_model(name, **kw), jax_params(jm))


DEPTHS = [(v, d) for v in ("v1", "v2", "v1b") for d in (18, 34)]


@pytest.mark.parametrize("version,depth", DEPTHS,
                         ids=["%s_%d" % vd for vd in DEPTHS])
def test_resnet_forward_matches_jax(jax_trace_state, version, depth):  # noqa: F811
    """Thumbnail ResNets (a 3x3 stem, no pooling) at 32x32, batch 4: the
    inference logits within 1e-5 of the largest; in training (inside
    ``record()``) the logits within 1e-4 and every BatchNorm's moving
    statistics within 1e-4 in relative L2 (a batch mean is a sum that
    cancels to about 1e-3 of its terms)."""
    x = np.random.RandomState(depth).randn(4, 3, 32, 32).astype(np.float32)
    jm, tm = _pair("resnet%d_%s" % (depth, version), x, classes=10,
                   thumbnail=True)
    jy = _f32(jm(mx.nd.array(x)))
    ty = _f32(tm(torch.from_numpy(x)))
    assert np.abs(ty - jy).max() <= 1e-5 * max(np.abs(jy).max(), 1)
    with jag.record():
        jy = _f32(jm(mx.nd.array(x)))
    with autograd.record():
        ty = _f32(tm(torch.from_numpy(x)))
    assert np.abs(ty - jy).max() <= 1e-4 * max(np.abs(jy).max(), 1)
    jp, tp = _local(jm), _local(tm)
    stats = [n for n in jp if n.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 2 * (2 * depth // 2)
    for n in stats:
        assert _rel_l2(_f32(tp[n]._tensor()), _f32(jp[n].data())) < 1e-4, n


def test_resnet18_v2_gradients_match_jax(jax_trace_state):  # noqa: F811
    """Every gradient of a whole pre-activation network (``resnet18_v2``,
    thumbnail, 32x32, batch 4, fp32) within 1e-4 in relative L2."""
    x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
    y = np.array([1, 2, 3, 4], np.int32)
    jm, tm = _pair("resnet18_v2", x, classes=10, thumbnail=True)
    kw = dict(SGD, learning_rate=0.0)
    _, jg = _jax_step(jm, jgluon.Trainer(jm.collect_params(), "sgd", kw),
                      mx.nd.array(x), y)
    _, tg = _port_step(tm, gluon.Trainer(tm.collect_params(), "sgd", kw),
                       torch.from_numpy(x), y)
    assert len(tg) > 50
    for n in jg:
        assert _rel_l2(tg[n], jg[n]) < 1e-4, n


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_files_cross_both_ways(jax_trace_state, tmp_path,  # noqa: F811
                                         writer):
    """An amp ResNet-50's ``save_parameters`` file (bf16 weights, fp32
    BatchNorm statistics) from either package loads into the other with
    every array's bits and dtype."""
    x = np.zeros((1, 3, 32, 32), np.float32)
    jm = jvision.resnet50_v1(classes=10)
    jm.initialize()
    jm(mx.nd.array(x))
    jamp.convert_hybrid_block(jm, "bfloat16")
    path = str(tmp_path / "r50.params")
    if writer == "jax":
        jm.save_parameters(path)
        tm = vision.resnet50_v1(classes=10)
        tm.initialize(device="cpu")
        tm(torch.from_numpy(x))
        tamp.convert_hybrid_block(tm, "bfloat16")
        tm.load_parameters(path)
        src, dst = jm, tm
    else:
        tm = from_jax_params(vision.resnet50_v1(classes=10), jax_params(jm))
        tm.save_parameters(path)
        jm2 = jvision.resnet50_v1(classes=10)
        jm2.initialize()
        jm2(mx.nd.array(x))
        jamp.convert_hybrid_block(jm2, "bfloat16")
        jm2.load_parameters(path)
        src, dst = tm, jm2
    a = {n: p.data() for n, p in src._collect_params_with_prefix().items()}
    b = {n: p.data() for n, p in dst._collect_params_with_prefix().items()}
    assert set(a) == set(b) and len(a) == len(jm.collect_params())
    for n in a:
        ta = a[n] if isinstance(a[n], torch.Tensor) else None
        tb = b[n] if isinstance(b[n], torch.Tensor) else None
        na = _f32(a[n]) if ta is None else ta.detach().float().numpy()
        nb = _f32(b[n]) if tb is None else tb.detach().float().numpy()
        np.testing.assert_array_equal(na, nb, err_msg=n)
        da = str(a[n].dtype).replace("torch.", "")
        db = str(b[n].dtype).replace("torch.", "")
        assert da == db, n
    assert str(b["features.1.running_var"].dtype).endswith("float32")
