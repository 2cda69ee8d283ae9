"""The port's ResNet-50 v1 training step against the JAX package's: one
step of ``bench.py``'s recipe (fp32 and amp bf16) through
``autograd.record``, ``SoftmaxCrossEntropyLoss``, ``backward`` and
``gluon.Trainer("sgd")``, at batch 2 and 64x64: the loss, each gradient,
each parameter's update and every BatchNorm's moving statistics.

At random weights a deep post-activation ResNet is chaotic at batch 2:
the port's own ResNet-50 v1 gradients move by a few percent when its input
moves by 1e-6 (measured at 64x64 and at 224x224), so no tolerance that
means anything holds two packages that round differently. The step starts
from the "zero-init residual" weights (Goyal et al., 2017: each
bottleneck's last BatchNorm gamma at 0, every block its shortcut at the
start), where the same 1e-6 moves the gradients by about 3e-6; every
BatchNorm still normalizes in training mode and moves its statistics. The
bottleneck bodies' convolutions get no gradient there (their update is the
weight decay alone); ``tests/test_torch_port_resnet.py`` holds every
gradient of a whole ``resnet18_v2``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from torch_port_helpers import f32 as _f32
from torch_port_helpers import jax_class_step as _jax_step
from torch_port_helpers import jax_trace_state_module  # noqa: F401
from torch_port_helpers import local_params as _local
from torch_port_helpers import numpy_uniform
from torch_port_helpers import port_class_step as _port_step
from torch_port_helpers import rel_l2 as _rel_l2

SGD = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True,
       "wd": 1e-4}
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _masters(model, trainer=None):
    """{name: fp32 weight}: the optimizer's fp32 master where it keeps one
    (a bf16 weight under multi_precision), else the weight. The trainer's
    states are indexed by its parameters with a gradient, in order."""
    states = trainer._states if trainer is not None else {}
    trained = [n for n, p in _local(model).items() if p.grad_req != "null"]
    index = {n: i for i, n in enumerate(trained)}
    out = {}
    for n, p in _local(model).items():
        s = states.get(index[n]) if n in index else None
        w = s["master"] if isinstance(s, dict) and "master" in s else p.data()
        out[n] = _f32(w)
    return out


def _resnet50_step(side, params, x, y, bf16):
    """One step of bench.py's recipe on ``side``'s resnet50_v1 from the
    JAX weights ``params`` at the zero-init residual start: (loss, {name:
    gradient}, {name: update of the fp32 master}, {name: moving statistic
    after the step})."""
    jax_side = side == "jax"
    if jax_side:
        m = jvision.resnet50_v1(classes=10)
        m.initialize(numpy_uniform())
        m(mx.nd.array(x))
        for n, p in _local(m).items():
            p.set_data(mx.nd.array(params[n]))
    else:
        m = vision.resnet50_v1(classes=10)
        from_jax_params(m, {m.prefix + n: a for n, a in params.items()})
    for name, p in m._collect_params_with_prefix().items():
        if name.endswith("body.7.gamma"):
            zero = np.zeros(p.shape, np.float32)
            p.set_data(mx.nd.array(zero) if jax_side
                       else torch.from_numpy(zero))
    xx = mx.nd.array(x) if jax_side else torch.from_numpy(x)
    if bf16:
        (jamp if jax_side else tamp).convert_hybrid_block(m, "bfloat16")
        xx = xx.astype("bfloat16") if jax_side else xx.to(torch.bfloat16)
    trainer = (jgluon if jax_side else gluon).Trainer(m.collect_params(),
                                                       "sgd", SGD)
    w0 = _masters(m)
    loss, grads = (_jax_step if jax_side else _port_step)(m, trainer, xx, y)
    upd = {n: w - w0[n] for n, w in _masters(m, trainer).items()}
    stats = {n: _f32(p.data()) for n, p in _local(m).items()
             if n.endswith(("running_mean", "running_var"))}
    return loss, grads, upd, stats


@pytest.fixture(scope="module")
def resnet50_case(jax_trace_state_module):  # noqa: F811
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    jm = jvision.resnet50_v1(classes=10)
    jm.initialize(numpy_uniform())
    jm(mx.nd.array(x))
    params = {n: _f32(p.data()) for n, p in _local(jm).items()}
    return params, x, np.array([3, 7], np.int32), {}


def _step_of(case, side, bf16):
    params, x, y, memo = case
    if (side, bf16) not in memo:
        memo[side, bf16] = _resnet50_step(side, params, x, y, bf16)
    return memo[side, bf16]


def test_resnet50_fp32_sgd_step_matches_jax(resnet50_case):
    """``resnet50_v1`` at batch 2, 64x64, from the zero-init residual start
    (module docstring), one fp32 step of bench.py's recipe in both
    packages: SGD lr 0.1 momentum 0.9 wd 1e-4, ``SoftmaxCrossEntropyLoss``.
    The loss within 1e-5, each gradient within 1e-4 in relative L2 (a zero
    gradient stays zero; a conv bias before a BatchNorm has no gradient but
    rounding's), each parameter's update and each moving statistic within
    1e-4."""
    jl, jg, jd, js = _step_of(resnet50_case, "jax", False)
    tl, tg, td, ts = _step_of(resnet50_case, "port", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(jg) == set(tg) and set(js) == set(ts) and len(ts) == 106
    zero = 0
    for n in jg:
        if not np.any(jg[n]):
            assert not np.any(tg[n]), n
            zero += 1
        elif "conv" in n and n.endswith("bias"):
            assert np.abs(tg[n]).max() < 1e-3 * np.abs(jg[n]).max() + 1e-6
        else:
            assert _rel_l2(tg[n], jg[n]) < 1e-4, n
            assert _rel_l2(td[n], jd[n]) < 1e-4, n
    # the bodies' convolutions get no gradient at this start; their update
    # is the weight decay alone
    assert 0 < zero < len(jg)
    for n in js:
        assert _rel_l2(ts[n], js[n]) < 1e-4, n


def test_resnet50_bf16_sgd_step_matches_jax(resnet50_case):
    """The same step under amp (bf16 weights with fp32 masters and fp32
    BatchNorm, the input cast to bf16 at entry). bf16 through 50 layers
    moves this step's gradients by about 20% (relative L2) from the fp32
    step's in either package, each rounding in its own places, so each is
    held to the fp32 step too: every gradient and update of the port at
    most 1.5x as far from the fp32 step's as the JAX package's bf16 one
    (plus 0.02), and from the JAX bf16 one no farther than that one is
    from fp32 (plus 0.02); the loss within 1e-2 of the JAX bf16 loss, the
    moving statistics (fp32 statistics of bf16 activations) within 0.05."""
    jl, jg, jd, js = _step_of(resnet50_case, "jax", True)
    tl, tg, td, ts = _step_of(resnet50_case, "port", True)
    _, fg, fd, _ = _step_of(resnet50_case, "jax", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for n in fg:
        if not np.any(fg[n]) or ("conv" in n and n.endswith("bias")):
            continue
        for got, want, ref in ((tg[n], jg[n], fg[n]), (td[n], jd[n], fd[n])):
            jax_err = _rel_l2(want, ref)
            assert _rel_l2(got, ref) <= 1.5 * jax_err + 0.02, n
            assert _rel_l2(got, want) <= jax_err + 0.02, n
    for n in js:
        assert _rel_l2(ts[n], js[n]) < 0.05, n
