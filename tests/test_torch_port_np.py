"""``mx.np`` (``numpy_api``), ``mx.npx`` and ``util``'s numpy-mode
switches of the port against the JAX package's, on the CPU: the explicit
wrappers over the registry, numpy's semantics written on torch, the names
resolved through torch, the host-only names and the refusal of any other,
``linalg``/``fft``, the dtype names (``bfloat16`` is
``torch.bfloat16``), the ``npx`` ops, and ``set_np``/``reset_np``/the
``use_np`` family.

Tolerance: fp32 1e-5 relative, 1e-6 absolute (the same math, another
library's order of summation); integers exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from torch_port_helpers import jax_trace_state_module  # noqa: F401

import mxnet_tpu_torch as mx

pytestmark = pytest.mark.usefixtures("jax_trace_state_module")

TOL = dict(rtol=1e-5, atol=1e-6)

RNG = np.random.default_rng(0)
A = RNG.standard_normal((3, 4)).astype(np.float32)
B = RNG.standard_normal((3, 4)).astype(np.float32)
SQ = (RNG.standard_normal((3, 3)) + 3 * np.eye(3)).astype(np.float32)

# (name, a function of a package's np giving the args, kwargs): the
# explicit wrappers, then names resolved on first use
CALLS = [
    ("sum", lambda n: [n.array(A)], {"axis": 1}),
    ("mean", lambda n: [n.array(A)], {"axis": 0, "keepdims": True}),
    ("max", lambda n: [n.array(A)], {}),
    ("std", lambda n: [n.array(A)], {"axis": 1}),
    ("argmax", lambda n: [n.array(A)], {"axis": 1}),
    ("exp", lambda n: [n.array(A)], {}),
    ("tanh", lambda n: [n.array(A)], {}),
    ("add", lambda n: [n.array(A), n.array(B)], {}),
    ("less", lambda n: [n.array(A), n.array(B)], {}),
    ("dot", lambda n: [n.array(A), n.array(B.T)], {}),
    ("where", lambda n: [n.array(A > 0), n.array(A), n.array(B)], {}),
    ("clip", lambda n: [n.array(A), -0.5, 0.5], {}),
    ("reshape", lambda n: [n.array(A), (4, 3)], {}),
    ("transpose", lambda n: [n.array(A)], {"axes": (1, 0)}),
    ("concatenate", lambda n: [[n.array(A), n.array(B)]], {"axis": 1}),
    ("stack", lambda n: [[n.array(A), n.array(B)]], {"axis": 0}),
    ("cumsum", lambda n: [n.array(A)], {"axis": 1}),
    ("take", lambda n: [n.array(A), n.array(np.array([2, 0], np.int32))],
     {"axis": 1}),
    ("einsum", lambda n: ["ij,kj->ik", n.array(A), n.array(B)], {}),
    ("zeros_like", lambda n: [n.array(A)], {}),
    # through torch
    ("absolute", lambda n: [n.array(A)], {}),
    ("isclose", lambda n: [n.array(A), n.array(A + 1e-9)], {}),
    ("tril", lambda n: [n.array(SQ)], {}),
    ("outer", lambda n: [n.array(A[0]), n.array(B[0])], {}),
    ("diff", lambda n: [n.array(A)], {"axis": 1}),
    ("logaddexp", lambda n: [n.array(A), n.array(B)], {}),
    ("roll", lambda n: [n.array(A), 1], {"axis": 1}),
    ("trapz", lambda n: [n.array(A)], {}),
    ("average", lambda n: [n.array(A)], {"axis": 1}),
    # numpy's semantics on torch
    ("append", lambda n: [n.array(A), n.array(B)], {"axis": 0}),
    ("median", lambda n: [n.array(A)], {"axis": 1}),
    ("percentile", lambda n: [n.array(A), 30.0], {}),
    ("pad", lambda n: [n.array(A), ((1, 0), (2, 1))], {"mode": "reflect"}),
    ("cumprod", lambda n: [n.array(A)], {}),
    ("unique", lambda n: [n.array(np.array([3, 1, 3, 2], np.int32))],
     {"return_counts": True}),
]


def _np_of(out):
    if isinstance(out, (list, tuple)):
        return [_np_of(o) for o in out]
    return np.asarray(out.asnumpy() if hasattr(out, "asnumpy") else out)


@pytest.mark.parametrize("name,args,kw", CALLS, ids=[c[0] for c in CALLS])
def test_np_names_match_jax(name, args, kw):
    want = _np_of(getattr(jmx.np, name)(*args(jmx.np), **kw))
    with mx.cpu():
        got = _np_of(getattr(mx.np, name)(*args(mx.np), **kw))
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)
    assert np.asarray(got).shape == np.asarray(want).shape


def test_np_routes_linalg_fft_and_dtypes():
    with mx.cpu():
        # no array goes through the host: a name runs on torch, is one of
        # numpy's host-only objects, or is refused
        assert "absolute" in mx.np.TORCH_NAMES
        assert mx.np.degrees.__doc__.endswith("torch.rad2deg on the "
                                              "arrays' device.")
        assert mx.np.shape is np.shape and "shape" in mx.np.HOST_NAMES
        assert mx.np.shape(mx.np.array(A)) == A.shape
        with pytest.raises(AttributeError, match="HOST_NAMES"):
            mx.np.interp
        inv = mx.np.linalg.inv(mx.np.array(SQ))
        spec = mx.np.fft.fft(mx.np.array(A), axis=1)
        out = mx.np.array(np.zeros(2, np.float32))
        mx.np.copyto(out, [1.0, 2.0])
        np.testing.assert_array_equal(out.asnumpy(), [1.0, 2.0])
    np.testing.assert_allclose(inv.asnumpy(),
                               jmx.np.linalg.inv(jmx.np.array(SQ)).asnumpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(spec.asnumpy(), np.fft.fft(A, axis=1),
                               rtol=1e-4, atol=1e-5)
    assert mx.np.bfloat16 is torch.bfloat16
    assert mx.np.float32 is np.float32 and mx.np.pi == np.pi
    assert mx.np.newaxis is None and mx.np.int64 is jmx.np.int64
    with pytest.raises(AttributeError):
        mx.np.no_such_numpy_name


@pytest.mark.parametrize("name,kw", [
    ("softmax", {"axis": -1}), ("relu", {}), ("sigmoid", {}),
    ("log_softmax", {}), ("erf", {}), ("gammaln", {}),
    ("leaky_relu", {"slope": 0.1})])
def test_npx_ops_match_jax(name, kw):
    x = np.abs(A) + 0.1 if name == "gammaln" else A
    want = getattr(jmx.npx, name)(jmx.nd.array(x), **kw).asnumpy()
    with mx.cpu():
        got = getattr(mx.npx, name)(mx.nd.array(x), **kw).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_npx_reaches_every_registry_op():
    with mx.cpu():
        assert mx.npx.broadcast_like is not None
        y = mx.npx.div_sqrt_dim(mx.nd.ones((2, 4)))
        np.testing.assert_allclose(y.asnumpy(), 0.5)
        assert callable(mx.npx.ctc_loss)
    with pytest.raises(AttributeError):
        mx.npx.no_such_op


def test_numpy_mode_switches_match_jax():
    from mxnet_tpu import util as jutil

    from mxnet_tpu_torch import util

    seen = []
    for pkg in (jutil, util):
        pkg.reset_np()
        log = [pkg.is_np_array(), pkg.is_np_shape()]
        pkg.set_np()
        log.append(pkg.is_np_array())
        pkg.reset_np()
        with pkg.np_array():
            log.append(pkg.is_np_array())
        with pkg.np_shape(False):
            log.append(pkg.is_np_shape())
        log.append(pkg.is_np_array())

        @pkg.use_np
        def inside():
            return pkg.is_np_array()

        @pkg.use_np
        class Model:
            def __init__(self):
                self.mode = pkg.is_np_array()

            def __call__(self):
                return pkg.is_np_array()

            @staticmethod
            def static():
                return pkg.is_np_array()

        log += [inside(), Model().mode, Model()(), Model.static(),
                pkg.use_np_array(inside)(), pkg.use_np_shape(inside)(),
                pkg.is_np_array()]
        seen.append(log)
    assert seen[0] == seen[1]
    assert mx.use_np is util.use_np and mx.np_shape is util.np_shape
    assert mx.npx.is_np_array() is False
