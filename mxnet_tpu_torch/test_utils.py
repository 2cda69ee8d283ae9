"""Testing helpers (ref: python/mxnet/test_utils.py; the JAX package's
``mxnet_tpu/test_utils.py``): comparisons of NDArrays with numpy values,
random arrays and shapes, a finite-difference gradient check, and the
symbolic checks (``check_symbolic_forward``/``check_symbolic_backward``,
through ``Symbol.bind`` and the Executor, on the default context)."""
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


def check_symbolic_forward(sym, inputs, expected, rtol=1e-5, atol=1e-8,
                           ctx=None):
    """Bind ``sym`` to ``inputs`` (positional, in ``list_arguments`` order)
    on ``ctx`` and compare its outputs with ``expected`` (ref:
    test_utils.py:check_symbolic_forward). Returns the outputs."""
    names = sym.list_arguments()
    args = {n: array(_np(v), ctx=ctx) for n, v in zip(names, inputs)}
    outs = sym.bind(ctx=ctx or current_context(), args=args).forward()
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    assert len(outs) == len(expected), (
        "%d outputs vs %d expected values" % (len(outs), len(expected)))
    for o, e in zip(outs, expected):
        np.testing.assert_allclose(_np(o), _np(e), rtol=rtol, atol=atol)
    return outs


def check_symbolic_backward(sym, inputs, out_grads, expected_grads,
                            rtol=1e-5, atol=1e-8, grad_req="write",
                            ctx=None):
    """Forward and backward ``sym`` on ``inputs`` with the output gradients
    ``out_grads`` and compare the arguments' gradients with
    ``expected_grads`` (a list in ``list_arguments`` order, or a dict by
    name; ref: test_utils.py:check_symbolic_backward). Returns the
    executor's ``grad_dict``."""
    names = sym.list_arguments()
    args = {n: array(_np(v), ctx=ctx) for n, v in zip(names, inputs)}
    grads = {n: array(np.zeros_like(_np(v)), ctx=ctx)
             for n, v in zip(names, inputs)}
    ex = sym.bind(ctx=ctx or current_context(), args=args, args_grad=grads,
                  grad_req=grad_req)
    ex.forward(is_train=True)
    ex.backward([array(_np(g), ctx=ctx) for g in out_grads]
                if isinstance(out_grads, (list, tuple))
                else array(_np(out_grads), ctx=ctx))
    if isinstance(expected_grads, dict):
        items = expected_grads.items()
    else:
        assert len(names) == len(expected_grads), (
            "%d arguments vs %d expected gradients"
            % (len(names), len(expected_grads)))
        items = zip(names, expected_grads)
    for n, e in items:
        np.testing.assert_allclose(_np(ex.grad_dict[n]), _np(e), rtol=rtol,
                                   atol=atol)
    return ex.grad_dict
