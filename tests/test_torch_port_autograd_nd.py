"""The cases of ``tests/test_autograd.py`` through both packages' ``nd``
and ``autograd`` (the same script, the JAX package's result the reference):
first, second and third order, head gradients, ``grad_req="add"`` and
``"null"``, ``pause`` and the modes, ``BlockGrad``/``detach``,
``autograd.Function``, ``mark_variables``, an intermediate variable, the
WGAN-GP gradient penalty, and second order through ``_DenseAttention``,
``_Embedding`` and the plain paths of the three kernel Functions
(LayerNorm, softmax-xent, flash), which on the CPU are exact; on the card
those raise (``chip_smoke.py`` ``phase_create_graph``)."""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

TOL = dict(rtol=1e-5, atol=1e-6)


def _both(script):
    """``script(mx)`` run by both packages; the port's (CPU) results held
    to the JAX package's."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        got = script(tmx)
    want = script(jmx)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g.asnumpy(), np.float32),
                                   np.asarray(w.asnumpy(), np.float32),
                                   err_msg="result %d" % k, **TOL)
    return got


def _a(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_first_order(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array(_a(3, 4))
        w = nd.array(_a(4, 2, seed=1))
        w.attach_grad()
        x.attach_grad()
        with ag.record():
            z = nd.sum(nd.sigmoid(nd.dot(x, w)))
        z.backward()
        h = nd.array([1.0, 2.0, 3.0])
        h.attach_grad()
        with ag.record():
            y = h * 2
        y.backward(nd.array([1.0, 10.0, 100.0]))
        m = nd.array(_a(2, 6, seed=2))
        m.attach_grad()
        with ag.record():
            parts = nd.split(m, num_outputs=2, axis=1)
            s = (parts[0] * 2 + parts[1] * 3).sum()
        s.backward()
        return [z, w.grad, x.grad, h.grad, m.grad]

    _both(script)


def test_grad_req_add_null_and_modes(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array([1.0, 2.0])
        x.attach_grad(grad_req="add")
        for _ in range(3):
            with ag.record():
                y = (x * x).sum()
            y.backward()
        n = nd.array([1.0, 2.0])
        n.attach_grad(grad_req="null")
        p = nd.array([1.0])
        p.attach_grad()
        with ag.record():
            assert ag.is_recording() and ag.is_training()
            with ag.pause():
                assert not ag.is_recording()
                unrec = p * 5  # not recorded
            with ag.predict_mode():
                assert not ag.is_training()
            q = p * 3 + (n * n).sum() + unrec
        q.backward()
        d = nd.array([2.0])
        d.attach_grad()
        with ag.record():
            z = nd.BlockGrad(d * d) + d + (d * d).detach()
        z.backward()
        return [x.grad, n.grad, p.grad, d.grad]

    _both(script)


def test_grad_api_without_attach(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array([3.0, -1.0])
        with ag.record():
            y = (x * x * x).sum()
        (g,) = ag.grad(y, [x])
        u = nd.array([2.0])
        with ag.record():
            a = u * 2
            b = nd.array([5.0]) * 1  # not reached from the head
            c = (a * a).sum()
        ga, gb = ag.grad(c, [u, b])
        return [g, ga, gb]

    _both(script)


def test_second_and_third_order(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array(np.array([2.0, -1.5, 3.0], np.float32))
        x.attach_grad()
        with ag.record():
            y = (x * x * x).sum()
            (g,) = ag.grad(y, [x], create_graph=True)
            z = (g * g).sum()
        z.backward()
        t = nd.array(np.array([1.5], np.float32))
        with ag.record():
            y4 = (t * t * t * t).sum()
            (g1,) = ag.grad(y4, [t], create_graph=True)
            (g2,) = ag.grad(g1, [t], create_graph=True)
            (g3,) = ag.grad(g2, [t])
        return [g, x.grad, g1, g2, g3]

    got = _both(script)
    np.testing.assert_allclose(got[1].asnumpy(), 36 * np.array(
        [2.0, -1.5, 3.0]) ** 3, rtol=1e-5)


def test_intermediate_variables(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array(np.array([1.0, 2.0], np.float32))
        with ag.record():
            v = x * 2.0
            y = (v * v).sum()
            gx, gv = ag.grad(y, [x, v], create_graph=True)
        x2 = nd.array(np.array([1.0, 2.0], np.float32))
        x2.attach_grad()
        with ag.record():
            v2 = x2 * 2.0
            y2 = (v2 * v2).sum()
            (gv2,) = ag.grad(y2, [v2], create_graph=True)
            s = gv2.sum()
        s.backward()
        return [gx, gv, gv2, x2.grad]

    _both(script)


def test_mark_variables(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        x = nd.array(_a(2, 3))
        gbuf = nd.zeros((2, 3))
        ag.mark_variables([x], [gbuf])
        with ag.record():
            y = (nd.exp(x) * 2).sum()
        y.backward()
        a = nd.array(_a(3, seed=5))
        with ag.record():
            h = a * 3
            ag.mark_variables([h], [nd.zeros((3,))], grad_reqs="write")
            out = (h * h).sum()
        out.backward()
        return [gbuf, x.grad, h.grad]

    _both(script)


def test_gradient_penalty(jax_trace_state):  # noqa: F811
    """WGAN-GP: a loss made of ||dD/dx||; its gradients with respect to
    the critic's weights, both packages."""
    def script(mx):
        nd, ag = mx.nd, mx.autograd
        w1, b1, w2 = (nd.array(_a(4, 8, seed=1)), nd.array(_a(8, seed=2)),
                      nd.array(_a(8, 1, seed=3)))
        x = nd.array(_a(5, 4, seed=4))
        for p in (w1, b1, w2):
            p.attach_grad()
        with ag.record():
            out = nd.dot(nd.tanh(nd.dot(x, w1) + b1), w2)
            (gp,) = ag.grad(out.sum(), [x], create_graph=True)
            norm = nd.sqrt((gp * gp).sum(axis=1))
            loss = ((norm - 1.0) * (norm - 1.0)).mean()
        loss.backward()
        return [gp, loss, w1.grad, b1.grad, w2.grad]

    _both(script)


def test_gluon_block_takes_and_returns_ndarray(jax_trace_state):  # noqa
    """A block called with NDArrays returns NDArrays; second order through
    a Dense block (grad of the input, then of the weight)."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    xv = np.array([[1.0, -2.0, 0.5], [0.3, 0.7, -1.1]], np.float32)
    wv = np.array([[0.4, -0.3, 0.9]], np.float32)
    res = []
    for mx in (tmx, jmx):
        net = mx.gluon.nn.Dense(1, in_units=3, use_bias=False)
        if mx is tmx:
            net.initialize(device="cpu")
        else:
            net.initialize()
        net.hybridize()
        with (mx.cpu() if mx is tmx else jmx.cpu()):
            net.weight.set_data(mx.nd.array(wv))
            x = mx.nd.array(xv)
            with mx.autograd.record():
                out = net(x)
                (gx,) = mx.autograd.grad(out.sum(), [x], create_graph=True)
                loss = (gx * gx).sum()
            loss.backward()
        assert isinstance(out, mx.nd.NDArray)
        res.append((gx, net.weight.grad()))
    for g, w in zip(res[0], res[1]):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)
    # tensors in, tensors out
    with torch.no_grad():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize(device="cpu")
        assert isinstance(net(torch.from_numpy(xv)), torch.Tensor)


def test_function(jax_trace_state):  # noqa: F811
    def script(mx):
        nd, ag = mx.nd, mx.autograd

        class Sigmoid(ag.Function):
            def forward(self, x):
                y = 1.0 / (1.0 + nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1.0 - y)

        class SplitScale(ag.Function):
            def forward(self, a, b):
                return a + b, a * b

            def backward(self, dsum, dprod):
                a, b = self._ab
                return dsum + dprod * b, dsum + dprod * a

        x = nd.array(_a(10, lo=-2, hi=2))
        x.attach_grad()
        with ag.record():
            y = Sigmoid()(x * 2.0)
            z = nd.sum(y * y)
        z.backward()
        a = nd.array(np.array([1.0, 2.0], np.float32))
        b = nd.array(np.array([3.0, 4.0], np.float32))
        a.attach_grad()
        b.attach_grad()
        f = SplitScale()
        with ag.record():
            f._ab = (a, b)
            s, p = f(a, b)
            out = nd.sum(s) + nd.sum(p)
        out.backward()
        return [y, x.grad, a.grad, b.grad]

    _both(script)


def test_not_ported_surfaces_name_their_items():
    """``get_symbol`` is ported (it refuses a non-array as the JAX package
    does); an op still to port names its item."""
    from mxnet_tpu_torch import autograd, nd

    with pytest.raises(TypeError, match="NDArray"):
        autograd.get_symbol(None)
    with pytest.raises(NotImplementedError, match="A.17 \\(roi\\)"):
        nd.ROIAlign(None)


def _second_order(mx, op_fn, inputs, wrt):
    """grad of sum(op(inputs) * w) with respect to input ``wrt`` with a
    graph, then the gradient of sum(g ** 2) with respect to every float
    input."""
    nd, ag = mx.nd, mx.autograd
    arrs = [nd.array(x) for x in inputs]
    floats = [a for a, x in zip(arrs, inputs) if x.dtype.kind == "f"]
    for a in floats:
        a.attach_grad()
    with ag.record():
        out = op_fn(nd, *arrs)
        w = nd.array(_a(*out.shape, seed=9))
        (g,) = ag.grad((out * w).sum(), [arrs[wrt]], create_graph=True)
        pen = (g * g).sum()
    pen.backward()
    return [g] + [a.grad for a in floats]


@pytest.mark.parametrize("name", ["LayerNorm", "softmax_cross_entropy",
                                  "dense_attention", "Embedding"])
def test_second_order_through_port_functions(name, jax_trace_state):  # noqa
    """Second order through the kernel Functions' plain paths (LayerNorm,
    softmax-xent) and the torch-op backwards of ``_DenseAttention`` and
    ``_Embedding``, against the JAX package's CPU path."""
    cases = {
        "LayerNorm": (lambda nd, x, g, b: nd.LayerNorm(x, g, b),
                      [_a(4, 8), _a(8, seed=1, lo=0.5, hi=1.5),
                       _a(8, seed=2)], 0),
        "softmax_cross_entropy": (
            lambda nd, x, y: nd.softmax_cross_entropy(x, y).reshape(1),
            [_a(6, 11, lo=-3, hi=3), np.array([0, 3, 10, 2, 2, 7],
                                              np.int32)], 0),
        "dense_attention": (
            lambda nd, q, k, v: nd.scaled_dot_attention(q, k, v,
                                                        causal=True),
            [_a(1, 2, 6, 8, seed=3), _a(1, 2, 6, 8, seed=4),
             _a(1, 2, 6, 8, seed=5)], 0),
        "Embedding": (
            lambda nd, i, w, s: nd.Embedding(i, w * s),
            [np.array([[0, 3], [5, 3]], np.int32), _a(6, 4, seed=6),
             _a(6, 4, seed=7)], 1),
    }
    fn, inputs, wrt = cases[name]
    _both(lambda mx: _second_order(mx, fn, inputs, wrt))


def test_second_order_through_plain_flash():
    """The flash Function's plain path on the CPU (fp32 operands) against
    jax.grad of jax.grad of the JAX package's attention seam (its CPU
    path), causal."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.attention import scaled_dot_attention as jattn
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_with_grad)

    q, k, v = (_a(1, 2, 16, 64, seed=s) for s in (1, 2, 3))
    w = _a(1, 2, 16, 64, seed=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_with_grad(tq, tk, tv, causal=True)
    (gq,) = torch.autograd.grad((o * torch.from_numpy(w)).sum(), tq,
                                create_graph=True)
    (gq * gq).sum().backward()

    def pen(q, k, v):
        gq = jax.grad(lambda qq: (jattn(qq, k, v, causal=True) * w).sum())(q)
        return (gq * gq).sum()

    want = jax.grad(pen, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
