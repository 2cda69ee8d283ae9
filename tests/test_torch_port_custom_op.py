"""``operator`` of the port (``CustomOp``, ``CustomOpProp``, ``register``,
``get``, ``nd.Custom``, ``register_torch_op``) against the JAX package's
(``nd.Custom`` and ``register_jax_op``) on the same ops and inputs, the
cases of its ``tests/test_custom_op.py``: forward and backward, several
outputs, auxiliary states with ``need_top_grad=False``, ``req`` add and
null, ``infer_type``, and the refusal under CUDA-graph capture.

Tolerance: fp32 1e-6 relative (the same elementwise math on both sides).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu import operator as jop
from torch_port_helpers import jax_trace_state_module  # noqa: F401

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch import operator as top

pytestmark = pytest.mark.usefixtures("jax_trace_state_module")

TOL = dict(rtol=1e-6, atol=0)


def _define(pkg, ndm, suffix):
    """The three ops of the JAX tests, registered in ``pkg`` under names
    ending in ``suffix``."""

    class Sigmoid(pkg.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], 1.0 / (1.0 + ndm.exp(
                -in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    @pkg.register("t_sigmoid" + suffix)
    class SigmoidProp(pkg.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sigmoid()

    class TwoOut(pkg.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2.0)
            self.assign(out_data[1], req[1], in_data[0] + in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2.0 + out_grad[1])
            self.assign(in_grad[1], req[1], out_grad[1])

    @pkg.register("t_twoout" + suffix)
    class TwoOutProp(pkg.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["double", "sum"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return TwoOut()

    class Square(pkg.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            aux[0][:] = in_data[0]
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            assert out_grad == []
            self.assign(in_grad[0], req[0], 2.0 * aux[0])

    @pkg.register("t_sq_notop" + suffix)
    class SquareProp(pkg.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_auxiliary_states(self):
            return ["stash"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Square()


# names of their own: the JAX package's tests/test_custom_op.py registers
# its ops in the same registry of the process
_define(jop, jnd, "_p24")
_define(top, nd, "_p24")


def _both(fn):
    """``fn(nd, autograd, make)`` through both packages: (jax, port)."""
    j = fn(jnd, jautograd, jnd.array)
    with mx.cpu():
        t = fn(nd, autograd, nd.array)
    return j, t


def _close(j, t):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, **TOL)


def test_custom_forward_backward_matches_jax():
    x0 = np.random.RandomState(0).randn(3, 4).astype(np.float32)

    def run(ndm, ag, make):
        x = make(x0)
        x.attach_grad()
        with ag.record():
            y = ndm.Custom(x, op_type="t_sigmoid_p24")
            loss = (y * make(np.arange(12, dtype=np.float32)
                             .reshape(3, 4))).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    ref = 1.0 / (1.0 + np.exp(-x0))
    np.testing.assert_allclose(t[0], ref, rtol=1e-5)


def test_custom_multi_output_matches_jax():
    def run(ndm, ag, make):
        a, b = make([[1.0, 2.0]]), make([[10.0, 20.0]])
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            d, s = ndm.Custom(a, b, op_type="t_twoout_p24")
            loss = (d + 3 * s).sum()
        loss.backward()
        return d.asnumpy(), s.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    np.testing.assert_array_equal(t[2], [[5.0, 5.0]])


def test_custom_aux_and_need_top_grad_match_jax():
    def run(ndm, ag, make):
        x = make([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = ndm.Custom(x, op_type="t_sq_notop_p24")
            y.sum().backward()
        return y.asnumpy(), x.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    np.testing.assert_array_equal(t[1], [2.0, 4.0, 6.0])


def test_custom_outside_record_and_errors():
    with mx.cpu():
        y = nd.Custom(nd.array([0.0]), op_type="t_sigmoid_p24")
        np.testing.assert_allclose(y.asnumpy(), [0.5])
        with pytest.raises(ValueError, match="op_type"):
            nd.Custom(nd.array([0.0]))
        with pytest.raises(ValueError, match="not registered"):
            nd.Custom(nd.array([0.0]), op_type="no_such_op")
    with pytest.raises(TypeError):
        top.register("bad")(object)
    assert top.get("t_sigmoid_p24").__name__ == "SigmoidProp"


def test_assign_requests():
    op = top.CustomOp()
    with mx.cpu():
        dst = nd.array([1.0, 2.0])
        op.assign(dst, "add", nd.array([10.0, 10.0]))
        np.testing.assert_array_equal(dst.asnumpy(), [11.0, 12.0])
        op.assign(dst, "null", nd.array([0.0, 0.0]))
        np.testing.assert_array_equal(dst.asnumpy(), [11.0, 12.0])
        op.assign(dst, "write", np.array([[3.0, 4.0]]))
        np.testing.assert_array_equal(dst.asnumpy(), [3.0, 4.0])
        op.assign(dst, "inplace", nd.array([5, 6], dtype="int32"))
        assert dst.dtype == np.float32


def test_infer_type_picks_the_output_dtype():
    class Half(top.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 0.5)

    @top.register("t_half_f16")
    class HalfProp(top.CustomOpProp):
        def infer_type(self, in_type):
            return in_type, [np.float16], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Half()

    with mx.cpu():
        y = nd.Custom(nd.array([1.0, 3.0]), op_type="t_half_f16")
    assert y.dtype == np.float16
    np.testing.assert_array_equal(y.asnumpy(), [0.5, 1.5])


@pytest.fixture
def registered_ops():
    """The ops a test registers leave both registries (and ``nd``/``npx``)
    after it: the registry-coverage test of
    tests/test_torch_port_nd_ops_legacy.py may run later in the process."""
    import mxnet_tpu.nd as jnd_mod
    from mxnet_tpu.base import OP_REGISTRY as JREG

    from mxnet_tpu_torch.base import OP_REGISTRY as TREG

    names = []
    yield names
    for n in names:
        for reg in (JREG, TREG):
            reg.pop(n, None)
        for mod in (jnd_mod, nd, mx.npx):
            mod.__dict__.pop(n, None)


def test_register_torch_op_matches_register_jax_op(registered_ops):
    registered_ops += ["st_clip_t24", "cube_t24"]
    jop.register_jax_op("st_clip_t24", lambda x: jnp.clip(x, -1.0, 1.0),
                        fwd=lambda x: (jnp.clip(x, -1.0, 1.0), None),
                        vjp=lambda res, g: (g,))
    top.register_torch_op("st_clip_t24", lambda x: torch.clamp(x, -1.0, 1.0),
                          fwd=lambda x: (torch.clamp(x, -1.0, 1.0), None),
                          vjp=lambda res, g: (g,))
    top.register_torch_op("cube_t24", lambda x, power=3: x ** power)

    def run(ndm, ag, make):
        x = make([-2.0, 0.5, 3.0])
        x.attach_grad()
        with ag.record():
            y = ndm.st_clip_t24(x)
            (y * make([1.0, 2.0, 3.0])).sum().backward()
        return y.asnumpy(), x.grad.asnumpy()

    j, t = _both(run)
    _close(j, t)
    np.testing.assert_array_equal(t[1], [1.0, 2.0, 3.0])  # straight through
    with mx.cpu():
        x = nd.array([2.0])
        x.attach_grad()
        with autograd.record():
            y = nd.cube_t24(x)
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [12.0])
        assert mx.npx.cube_t24(x).asnumpy()[0] == 8.0


def test_custom_refuses_under_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with mx.cpu():
        with pytest.raises(RuntimeError, match="CUDA graph"):
            nd.Custom(nd.array([0.0]), op_type="t_sigmoid_p24")
