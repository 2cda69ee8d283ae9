"""``autograd.get_symbol`` of the port against the JAX package's on the
same numpy inputs: the recovered graph's value, bound executor and
gradients (fp32 1e-5), its arguments in first-use order, its refusals
(``tojson``, no history, an ``autograd.Function`` node), and a history
taken after other arrays of the recording were freed."""
import gc

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")
TOL = dict(rtol=1e-5, atol=1e-5)


def _a(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _program(nd, x, w, b):
    h = nd.FullyConnected(x, w, b, num_hidden=4)
    h = nd.relu(h) * 2.0 + nd.sin(x).sum(axis=1, keepdims=True)
    return nd.softmax(h).mean()


def _record(mod, arrays):
    nd, ag = mod.nd, mod.autograd
    for a in arrays:
        a.attach_grad()
    with ag.record():
        out = _program(nd, *arrays)
    return out


def _feeds():
    return [_a(3, 5, seed=1), _a(4, 5, seed=2), _a(4, seed=3)]


def test_value_bind_and_grad_match():
    import mxnet_tpu as jmx

    feeds = _feeds()
    jarr = [jmx.nd.array(v) for v in feeds]
    jout = _record(jmx, jarr)
    jsym = jmx.autograd.get_symbol(jout)
    with tmx.cpu():
        tarr = [tnd.array(v) for v in feeds]
        tout = _record(tmx, tarr)
        tsym = tag.get_symbol(tout)
    assert tsym.list_arguments() == jsym.list_arguments() == \
        ["arg0", "arg1", "arg2"]
    targs = {"arg%d" % i: tnd.array(v, ctx=tmx.cpu())
             for i, v in enumerate(feeds)}
    np.testing.assert_allclose(tsym.eval(**targs)[0].asnumpy(),
                               tout.asnumpy(), **TOL)
    np.testing.assert_allclose(tsym.eval(**targs)[0].asnumpy(),
                               jsym.eval(**{k: jmx.nd.array(v) for k, v in
                                            zip(targs, feeds)})[0].asnumpy(),
                               **TOL)
    # bound: forward and backward on the recovered graph
    grads = {k: tnd.zeros(v.shape, ctx=tmx.cpu()) for k, v in targs.items()}
    ex = tsym.bind(tmx.cpu(), targs, grads)
    ex.forward(is_train=True)
    ex.backward()
    jgrads = {k: jmx.nd.zeros(v.shape) for k, v in zip(targs, feeds)}
    jex = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in
                                zip(targs, feeds)}, jgrads)
    jex.forward(is_train=True)
    jex.backward()
    for k in targs:
        np.testing.assert_allclose(ex.grad_dict[k].asnumpy(),
                                   jex.grad_dict[k].asnumpy(),
                                   err_msg=k, **TOL)
    # and the recorded arrays' own gradients
    tout.backward()
    for a, k in zip(tarr, targs):
        np.testing.assert_allclose(a.grad.asnumpy(),
                                   ex.grad_dict[k].asnumpy(), **TOL)


def test_refusals_match():
    import mxnet_tpu as jmx

    for mod, ctx in ((jmx, None), (tmx, tmx.cpu())):
        with (ctx or tmx.cpu()):
            arrs = [mod.nd.array(v) for v in _feeds()]
        out = _record(mod, arrs)
        s = mod.autograd.get_symbol(out)
        with pytest.raises(ValueError):
            s.tojson()
        with (ctx or tmx.cpu()):
            plain = mod.nd.array(_a(2, 2)) * 2.0
        with pytest.raises(ValueError):
            mod.autograd.get_symbol(plain)
        with pytest.raises(TypeError):
            mod.autograd.get_symbol(np.zeros(2))

    class Twice(tag.Function):
        def forward(self, x):
            return x * 2.0

        def backward(self, dy):
            return dy * 2.0

    x = tnd.array(_a(3), ctx=tmx.cpu())
    x.attach_grad()
    with tag.record():
        y = Twice()(x).sum()
    with pytest.raises(NotImplementedError):
        tag.get_symbol(y)


def test_history_after_other_arrays_were_freed():
    """The record pins no tensor and names each by a token: freeing the
    intermediate arrays (whose ids may be reused by new ones) leaves the
    history whole."""
    with tmx.cpu():
        x = tnd.array(_a(4, 3, seed=4))
        x.attach_grad()
        with tag.record():
            h = x * 3.0
            g = tnd.exp(h * 0.1)
            y = (g + 1.0).sum()
            junk = [tnd.array(_a(4, 3, seed=9)) * 1.0 for _ in range(50)]
        want = y.asnumpy()
        del h, g, junk
        gc.collect()
        fresh = [tnd.array(_a(4, 3, seed=s)) for s in range(50)]
        s = tag.get_symbol(y)
        assert s.list_arguments() == ["arg0"]
        got = s.eval(arg0=tnd.array(_a(4, 3, seed=4)))[0].asnumpy()
        np.testing.assert_allclose(got, want, **TOL)
        del fresh


def test_block_call_is_one_node_with_its_eager_forward():
    """A Gluon block's NDArray call (hybridized or not) is one node that
    replays the block's own ops."""
    from mxnet_tpu_torch import gluon

    for hyb in (False, True):
        net = gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(gluon.nn.Dense(5, activation="relu", in_units=3))
            net.add(gluon.nn.Dense(2, in_units=5))
        net.initialize(device="cpu")
        if hyb:
            net.hybridize()
        with tmx.cpu():
            x = tnd.array(_a(4, 3, seed=5))
            with tag.record():
                loss = (net(x) ** 2).mean()
            s = tag.get_symbol(loss)
            assert s.list_arguments() == ["arg0"]
            got = s.eval(arg0=x)[0]
            np.testing.assert_allclose(got.asnumpy(), loss.asnumpy(), **TOL)
            ex = s.bind(tmx.cpu(), {"arg0": x},
                        {"arg0": tnd.zeros(x.shape)})
            ex.forward(is_train=True)
            ex.backward()
            assert np.isfinite(ex.grad_dict["arg0"].asnumpy()).all()
