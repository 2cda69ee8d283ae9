"""Testing helpers (ref: python/mxnet/test_utils.py; the JAX package's
``mxnet_tpu/test_utils.py``): comparisons of NDArrays with numpy values,
random arrays and shapes, and a finite-difference gradient check."""
from __future__ import annotations

import numpy as np

from . import context as _ctx_mod
from .context import current_context
from .ndarray import NDArray, array


def default_context():
    return current_context()


def set_default_context(ctx):
    """Make ``ctx`` the default for creation calls outside any ``with
    ctx:`` scope."""
    _ctx_mod._default = ctx


def list_gpus():
    """The CUDA device ordinals of this process."""
    return list(range(_ctx_mod.num_gpus()))


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def almost_equal(a, b, rtol=1e-5, atol=1e-8):
    return np.allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def same(a, b):
    return np.array_equal(_np(a), _np(b))


def rand_ndarray(shape, dtype=np.float32, ctx=None):
    return array(np.random.randn(*shape).astype(dtype), ctx=ctx)


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-3,
                           n_checks=5, ctx=None):
    """Hold the autograd gradients of scalar ``fn(*inputs)`` to central
    differences at ``n_checks`` elements of each input."""
    from . import autograd

    arrs = [array(_np(x), ctx=ctx) for x in inputs]
    for a in arrs:
        a.attach_grad()
    with autograd.record():
        out = fn(*arrs)
    out.backward()
    vals = [_np(a).copy() for a in arrs]

    def eval_at(vs):
        return float(_np(fn(*[array(v, ctx=ctx) for v in vs])).sum())

    for k, a in enumerate(arrs):
        g = a.grad.asnumpy().ravel()
        flat = vals[k].ravel()
        rng = np.random.RandomState(0)
        for i in rng.choice(flat.size, size=min(n_checks, flat.size),
                            replace=False):
            orig = flat[i]
            flat[i] = orig + eps
            fp = eval_at(vals)
            flat[i] = orig - eps
            fm = eval_at(vals)
            flat[i] = orig
            fd = (fp - fm) / (2 * eps)
            if not np.isclose(g[i], fd, rtol=rtol, atol=atol):
                raise AssertionError(
                    "gradient mismatch at input %d elem %d: autograd %g vs "
                    "fd %g" % (k, i, g[i], fd))
    return True


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("%r did not raise %s" % (f, exception_type.__name__))
