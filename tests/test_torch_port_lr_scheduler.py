"""The port's five learning-rate schedulers against the JAX package's, with
and without warmup (linear and constant), at every update count 0..2000:
equal within 1e-7 (both are the same Python arithmetic in doubles)."""
import numpy as np
import pytest

from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu_torch import lr_scheduler as tlrs

SCHEDULERS = {
    "factor": ("FactorScheduler", (250,), dict(factor=0.5,
                                                stop_factor_lr=1e-4)),
    "multifactor": ("MultiFactorScheduler", ([300, 900, 1500],),
                    dict(factor=0.3)),
    "poly": ("PolyScheduler", (1800,), dict(pwr=2, final_lr=1e-3)),
    "cosine": ("CosineScheduler", (1700,), dict(final_lr=1e-4)),
}
WARMUPS = {
    "none": {},
    "linear": dict(warmup_steps=120, warmup_begin_lr=1e-4),
    "constant": dict(warmup_steps=80, warmup_begin_lr=2e-3,
                     warmup_mode="constant"),
}


@pytest.mark.parametrize("warmup", sorted(WARMUPS))
@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_scheduler_matches_jax(kind, warmup):
    cls, args, kw = SCHEDULERS[kind]
    kw = dict(kw, base_lr=0.1, **WARMUPS[warmup])
    want = getattr(jlrs, cls)(*args, **kw)
    got = getattr(tlrs, cls)(*args, **kw)
    steps = range(2001)
    np.testing.assert_allclose([got(t) for t in steps],
                               [want(t) for t in steps], rtol=0, atol=1e-7)


@pytest.mark.parametrize("warmup", ["linear", "constant"])
def test_base_scheduler_warmup_matches_jax(warmup):
    """The base class's warmup rate, which every scheduler starts with."""
    kw = dict(base_lr=0.1, **WARMUPS[warmup])
    want, got = jlrs.LRScheduler(**kw), tlrs.LRScheduler(**kw)
    for t in range(kw["warmup_steps"]):
        assert abs(got.get_warmup_lr(t) - want.get_warmup_lr(t)) <= 1e-7
    with pytest.raises(NotImplementedError):
        got(0)
