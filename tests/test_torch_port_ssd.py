"""SSD of the port against the JAX package's on a small SSD at 64 x 64 (the
VGG base at full width, two scales: 60 anchors, 3 classes), weights and
BatchNorm statistics carried with ``from_jax_params``: the predict-mode
forward (class and box predictions within 1e-5 of the largest element,
anchors within 1e-6); one training step at ``bench.py``'s recipe (the
mean of ``SSDLoss`` with BatchNorm on the batch's statistics): the loss
within 1e-5, every gradient within 1e-2 relative L2, the moving
statistics within 1e-5; and ``detect``: the same entries kept, ids exact,
scores and boxes within 1e-5.

The gradients' limit is wide because the step is ill-conditioned at this
size, not because the two packages compute differently: the down block's
BatchNorm normalizes 8 values a channel (2 images of 2 x 2), and 50 of its
512 channels have zero variance after the ReLU, so rounding differences
of 1e-7 before it are multiplied by 1 / sqrt(eps) = 316. The training
forward's outputs then differ by 5e-3 of 2.6 and the base's gradients by
2.5e-3 relative L2, while the predict-mode forward agrees to 1.2e-5 of
the largest element and the targets, the loss and the heads' gradients
to 3e-4 or better."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.models.ssd import SSD as JSSD, SSDLoss as JSSDLoss
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.ssd import SSD, SSDLoss, ssd_512
from mxnet_tpu_torch.ops import F
from torch_port_helpers import jax_params, jax_trace_state_module  # noqa: F401
from torch_port_helpers import few_threads, jax_rng_kept  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads", "jax_rng_kept")

SMALL = dict(num_classes=3, sizes=((0.2, 0.3), (0.5, 0.6)),
             ratios=((1, 2),) * 2)
# the JAX model's initial weights: drawn from this seed, so the case is the
# same whichever files ran before in the worker
SEED = 0


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.asnumpy(), np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: %g" % (what, err)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def pair(jax_trace_state_module, jax_rng_kept):  # noqa: F811
    jm = JSSD(**SMALL)
    jmx.random.seed(SEED)
    jm.initialize()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    jm(jmx.nd.array(x))  # materialize the deferred shapes
    tm = SSD(**SMALL)
    from_jax_params(tm, jax_params(jm))
    labels = np.array([[[0, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.2, 0.9, 0.6]],
                       [[1, 0.5, 0.5, 0.9, 0.9], [-1, 0, 0, 0, 0]]],
                      np.float32)
    return jm, tm, x, labels


def test_forward_matches_jax(pair):
    jm, tm, x, _ = pair
    jc, jb, ja = jm(jmx.nd.array(x))
    tc, tb, ta = tm(torch.from_numpy(x))
    assert ta.shape == (1, 60, 4) and tc.shape == (2, 60, 4)
    _close(ta, ja, 1e-6, "anchors")
    _close(tc, jc, 1e-5, "cls_preds")
    _close(tb, jb, 1e-5, "box_preds")


def test_train_step_matches_jax(pair):
    jm, tm, x, labels = pair
    jloss, tloss = JSSDLoss(3), SSDLoss(3)
    with jag.record():
        jc, jb, ja = jm(jmx.nd.array(x))
        jl = jmx.nd.mean(jloss(jc, jb, jmx.nd.array(labels), ja))
    jl.backward()
    with autograd.record():
        tc, tb, ta = tm(torch.from_numpy(x))
        tl = tloss(tc, tb, torch.from_numpy(labels), ta).mean()
    autograd.backward(tl)
    _close(tl, jl, 1e-5, "loss")
    tparams = tm.collect_params()
    n_grads = 0
    for name, p in jm.collect_params().items():
        tp = tparams[tm.prefix + name[len(jm.prefix):]]
        if p.grad_req == "null":  # the moving statistics
            _close(tp._tensor(), p.data(), 1e-5, name)
            continue
        assert _rel_l2(tp.grad()._data, p.grad()) <= 1e-2, name
        n_grads += 1
    assert n_grads == 38


def test_detect_matches_jax(pair):
    jm, tm, x, _ = pair
    jd = _np(jm.detect(jmx.nd.array(x)))
    td = _np(tm.detect(torch.from_numpy(x), device="cpu"))
    np.testing.assert_array_equal(td[..., 1] > 0, jd[..., 1] > 0)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    np.testing.assert_allclose(td[..., 1:], jd[..., 1:], rtol=0, atol=1e-5)
    assert (td[..., 1] > 0).sum() > 0 and (td[..., 1] < 0).sum() > 0


def test_ssd_512_anchors():
    """``ssd_512``: (32² + 16² + 8² + 4² + 2²) x 4 = 5456 anchors, as the
    JAX model's."""
    m = ssd_512(num_classes=20)
    anchors = [F.multibox_prior(torch.zeros(1, 1, s, s), sizes=m._sizes[i],
                                ratios=m._ratios[i])
               for i, s in enumerate((32, 16, 8, 4, 2))]
    assert sum(a.shape[1] for a in anchors) == 5456
