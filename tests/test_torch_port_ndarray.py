"""The port's NDArray against the JAX package's: creation and dtype rules,
arithmetic with scalars and the in-place operators, no aliasing after
``__setitem__``, indexing, reductions and shape methods, the context scope,
``DeviceError`` without a context on a host with no card, ``Parameter``
data as NDArray, and ``nd.save``/``nd.load`` (bfloat16 included) across
the two packages both ways."""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture
def both(jax_trace_state):  # noqa: F811
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        yield jmx, tmx


def _same(t, j, exact=False):
    tv, jv = t.asnumpy(), np.asarray(j.asnumpy())
    assert t.shape == j.shape and t.dtype.name == j.dtype.name, (
        t.shape, j.shape, t.dtype, j.dtype)
    if exact or jv.dtype.kind in "iub":
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, np.asarray(jv, np.float32),
                                   rtol=1e-6, atol=1e-7)


def test_creation_and_dtype_rules(both):
    jmx, tmx = both
    x64 = np.random.RandomState(0).randn(3, 4)
    for src, kw in ((x64, {}), (x64.astype(np.int64), {}),
                    ([[1, 2], [3, 4]], {}), ([1.5, 2.5], {}),
                    (x64, {"dtype": "float16"}), (x64, {"dtype": "int32"}),
                    (x64.astype(np.float32), {"dtype": "bfloat16"})):
        _same(tmx.nd.array(src, **kw), jmx.nd.array(src, **kw))
    for fn, args in (("zeros", ((2, 3),)), ("ones", ((3,),)),
                     ("full", ((2, 2), 7)), ("empty", ((2,),)),
                     ("arange", (5,)), ("arange", (1, 7, 2)),
                     ("linspace", (0, 1, 5)), ("eye", (3,)),
                     ("eye", (3, 4, 1))):
        _same(getattr(tmx.nd, fn)(*args), getattr(jmx.nd, fn)(*args))
    _same(tmx.nd.arange(0, 3, repeat=2), jmx.nd.arange(0, 3, repeat=2))
    _same(tmx.nd.zeros((2,), dtype="int32"), jmx.nd.zeros((2,),
                                                          dtype="int32"))
    _same(tmx.nd.linspace(0, 1, 4, endpoint=False),
          jmx.nd.linspace(0, 1, 4, endpoint=False))
    t = tmx.nd.array(x64)
    assert t.size == 12 and t.ndim == 2 and len(t) == 3
    assert t.context == tmx.cpu() and t.T.shape == (4, 3)
    b = tmx.nd.array(x64, dtype="bfloat16")
    assert b.dtype == "bfloat16" and b.asnumpy().dtype == np.float32
    np.testing.assert_array_equal(
        b.asnumpy(), np.asarray(jmx.nd.array(x64.astype(np.float32),
                                             dtype="bfloat16").asnumpy(),
                                np.float32))


def test_arithmetic_and_inplace(both):
    jmx, tmx = both
    rng = np.random.RandomState(1)
    x, y = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)
    ta, tb = tmx.nd.array(x), tmx.nd.array(y)
    ja, jb = jmx.nd.array(x), jmx.nd.array(y)
    for f in (lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
              lambda a, b: a / (b + 10), lambda a, b: a + 1.5,
              lambda a, b: 2 - a, lambda a, b: 3.0 / (b + 10),
              lambda a, b: -a, lambda a, b: abs(a), lambda a, b: a ** 2,
              lambda a, b: 2 ** a, lambda a, b: a % 0.7,
              lambda a, b: (a * 4) % -1.5, lambda a, b: a @ b.T,
              lambda a, b: a > b, lambda a, b: a <= 0.1,
              lambda a, b: a == a, lambda a, b: a != b):
        _same(f(ta, tb), f(ja, jb))
    ti = tmx.nd.array(np.array([-7, -3, 4, 9], np.int32))
    ji = jmx.nd.array(np.array([-7, -3, 4, 9], np.int32))
    _same(ti % 4, ji % 4)  # Python's sign
    _same(ti % -4, ji % -4)
    _same(ti * 2 + 1, ji * 2 + 1)
    h = tmx.nd.array(x).astype("bfloat16")
    assert (h * 0.5).dtype == h.dtype
    for a in (ta, ja):
        a += 1
        a *= 2
        a -= 0.5
        a /= 4
    _same(ta, ja)


def test_setitem_does_not_alias(both):
    jmx, tmx = both
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    for mx in (tmx, jmx):
        a = mx.nd.array(x)
        row = a[1]
        sub = a[1:3, :2]
        a[1] = 0.0
        a[:, 3] = mx.nd.array(np.array([9, 9, 9, 9], np.float32))
        a[2:, :1] = 5
        np.testing.assert_array_equal(row.asnumpy(), x[1])
        np.testing.assert_array_equal(sub.asnumpy(), x[1:3, :2])
    ta, ja = tmx.nd.array(x), jmx.nd.array(x)
    for a in (ta, ja):
        a[1] = 0.0
        a[:, 3] = 7.0
    _same(ta, ja)


def test_indexing(both):
    jmx, tmx = both
    x = np.random.RandomState(2).randn(4, 5, 3).astype(np.float32)
    ta, ja = tmx.nd.array(x), jmx.nd.array(x)
    for key in (1, -1, slice(1, 3), (2, slice(None), 0), (Ellipsis, 1),
                (slice(None), None, 2), (slice(None, None, 2), 1),
                (slice(None, None, -1),), (1, slice(4, 0, -2))):
        _same(ta[key], ja[key])
    idx = [3, 0, 3]
    _same(ta[tmx.nd.array(np.array(idx, np.int32))],
          ja[jmx.nd.array(np.array(idx, np.int32))])
    _same(ta[tmx.nd.array(np.array([0, 2], np.int32)), 1],
          ja[jmx.nd.array(np.array([0, 2], np.int32)), 1])
    assert [r.shape for r in ta] == [(5, 3)] * 4


def test_reductions_and_shape_methods(both):
    jmx, tmx = both
    x = np.random.RandomState(3).rand(2, 3, 4).astype(np.float32) + 0.5
    ta, ja = tmx.nd.array(x), jmx.nd.array(x)
    for f in (lambda a: a.sum(), lambda a: a.mean(axis=1),
              lambda a: a.max(axis=(0, 2)), lambda a: a.min(keepdims=True),
              lambda a: a.prod(axis=2), lambda a: a.argmax(axis=2),
              lambda a: a.argmin(), lambda a: a.norm(), lambda a: a.sqrt(),
              lambda a: a.exp(), lambda a: a.log(), lambda a: a.abs(),
              lambda a: a.clip(0.7, 1.2), lambda a: a.sigmoid(),
              lambda a: a.tanh(), lambda a: a.relu(), lambda a: a.softmax(),
              lambda a: a.reshape(6, 4), lambda a: a.reshape((0, -1)),
              lambda a: a.reshape(shape=(4, -1)), lambda a: a.flatten(),
              lambda a: a.transpose(), lambda a: a.transpose(2, 0, 1),
              lambda a: a.swapaxes(0, 2), lambda a: a.expand_dims(1),
              lambda a: a.expand_dims(0).squeeze(axis=0),
              lambda a: a[:, :1].broadcast_to((2, 3, 4)),
              lambda a: a.tile((1, 2, 1)), lambda a: a.repeat(2, axis=1),
              lambda a: a.slice_axis(2, 1, 3), lambda a: a.zeros_like(),
              lambda a: a.ones_like(), lambda a: a.astype("int32"),
              lambda a: a.copy(), lambda a: a.detach(),
              lambda a: a.take(a[0, 0, :2].astype("int32") * 0 + 1),
              lambda a: (a[0, 0] * 2).astype("int32").one_hot(4),
              lambda a: a.T):
        _same(f(ta), f(ja))
    for t, j in zip(ta.split(3, axis=1), ja.split(3, axis=1)):
        _same(t, j)
    _same(tmx.nd.concat(ta, ta, dim=2), jmx.nd.concat(ja, ja, dim=2))
    _same(tmx.nd.stack(ta, ta, axis=1), jmx.nd.stack(ja, ja, axis=1))
    assert float(ta[0, 0, 0]) == float(ja[0, 0, 0])
    assert ta[0, 0, 0].asscalar() == ta[0, 0, 0].item()
    with pytest.raises(ValueError):
        bool(ta)


def test_mxnet_reshape_codes():
    import mxnet_tpu_torch as tmx

    x = np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5)
    with tmx.cpu():
        a = tmx.nd.array(x)
        for shape, want in (((0, -1), (2, 60)), ((-2,), (2, 3, 4, 5)),
                            ((0, -2), (2, 3, 4, 5)), ((-3, 0, 0), (6, 4, 5)),
                            ((0, -3, 5), (2, 12, 5)),
                            ((-4, 1, 2, -2), (1, 2, 3, 4, 5)),
                            ((0, -4, -1, 1, -2), (2, 3, 1, 4, 5)),
                            ((-1, 0, 5), (8, 3, 5))):
            got = tmx.nd.Reshape(a, shape=shape)
            assert got.shape == want, (shape, got.shape)
            np.testing.assert_array_equal(got.asnumpy(), x.reshape(want))


def test_context_scope_and_device_error(monkeypatch):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.base import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        tmx.nd.array([1.0, 2.0])
    with pytest.raises(DeviceError):
        tmx.nd.zeros((2,))
    with pytest.raises(DeviceError):
        tmx.current_context()
    with pytest.raises(DeviceError):
        tmx.nd.array([1.0], ctx=tmx.gpu(0))
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.ones((2,)).context == tmx.cpu()
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
            with pytest.raises(DeviceError):
                tmx.nd.ones((2,))
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.random.uniform(shape=(3,)).context == tmx.cpu()
    assert tmx.nd.array([1.0], ctx=tmx.cpu()).context == tmx.cpu()
    # the scope is per thread
    import threading

    seen = []
    with tmx.cpu():
        t = threading.Thread(target=lambda: seen.append(
            getattr(tmx.context._tls, "stack", [])))
        t.start()
        t.join(timeout=30)
    assert seen == [[]]


def test_parameter_data_is_an_ndarray_over_the_live_tensor():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import gluon

    net = gluon.nn.Dense(3, in_units=2)
    net.initialize(device="cpu")
    w = net.weight.data()
    assert isinstance(w, tmx.NDArray) and w.shape == (3, 2)
    assert w._data is net.weight._tensor()  # no copy
    assert [d._data for d in net.weight.list_data()] == [w._data]
    w[:] = 1.0  # writes into the parameter, as MXNet's does
    assert float(net.weight._tensor().sum()) == 6.0
    net.weight.set_data(tmx.nd.array(np.full((3, 2), 2.0, np.float32),
                                     ctx=tmx.cpu()))
    assert float(net.weight._tensor().sum()) == 12.0
    assert net.weight.grad().shape == (3, 2) and isinstance(
        net.weight.list_grad()[0], tmx.NDArray)


def test_save_load_cross_both_ways(both, tmp_path):
    jmx, tmx = both
    rng = np.random.RandomState(4)
    f32 = rng.randn(3, 4).astype(np.float32)
    i32 = rng.randint(-5, 5, (5,)).astype(np.int32)
    tdata = {"w": tmx.nd.array(f32), "b": tmx.nd.array(f32,
                                                        dtype="bfloat16"),
             "i": tmx.nd.array(i32)}
    jdata = {"w": jmx.nd.array(f32), "b": jmx.nd.array(f32,
                                                        dtype="bfloat16"),
             "i": jmx.nd.array(i32)}
    for src, dst, data in ((tmx, jmx, tdata), (jmx, tmx, jdata)):
        p = str(tmp_path / ("d_%s.nd" % src.__name__))
        src.nd.save(p, data)
        got = dst.nd.load(p)
        assert sorted(got) == ["b", "i", "w"]
        for k in got:
            assert got[k].dtype.name == data[k].dtype.name
            np.testing.assert_array_equal(
                np.asarray(got[k].asnumpy(), np.float32),
                np.asarray(data[k].asnumpy(), np.float32))
        p = str(tmp_path / ("l_%s.nd" % src.__name__))
        src.nd.save(p, [data["w"], data["b"]])
        got = dst.nd.load(p)
        assert isinstance(got, list) and len(got) == 2
        assert got[1].dtype.name == "bfloat16"
        p = str(tmp_path / ("one_%s.nd" % src.__name__))
        src.nd.save(p, data["i"])
        (one,) = dst.nd.load(p)
        np.testing.assert_array_equal(one.asnumpy(), i32)
        p = str(tmp_path / ("empty_%s.nd" % src.__name__))
        src.nd.save(p, {})
        assert dst.nd.load(p) == {}


def test_legacy_parameter_dict_files_cross_both_ways(both, tmp_path):
    jmx, tmx = both
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import gluon as tgluon

    jnet = jgluon.nn.Dense(3, in_units=4, prefix="dense_")
    jnet.initialize()
    tnet = tgluon.nn.Dense(3, in_units=4, prefix="dense_")
    tnet.initialize(device="cpu")
    p = str(tmp_path / "legacy.params")
    jnet.collect_params().save(p)
    tnet.load_parameters(p)  # global names: read by those names
    np.testing.assert_array_equal(tnet.weight.data().asnumpy(),
                                  jnet.weight.data().asnumpy())
    tnet2 = tgluon.nn.Dense(3, in_units=4, prefix="dense_")
    tnet2.initialize(device="cpu")
    tnet2.collect_params().load(p)
    np.testing.assert_array_equal(tnet2.bias.data().asnumpy(),
                                  jnet.bias.data().asnumpy())
    tnet.weight.set_data(tnet.weight.data() * 2)
    q = str(tmp_path / "port.params")
    tnet.collect_params().save(q, strip_prefix="dense_")
    jnet.collect_params().load(q, restore_prefix="dense_")
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(),
                                  tnet.weight.data().asnumpy())
    with pytest.raises(KeyError):
        tnet.collect_params().load(q)  # names without the prefix


def test_test_utils(both):
    jmx, tmx = both
    from mxnet_tpu_torch import test_utils as tu

    a = tu.rand_ndarray((3, 4))
    assert a.shape == (3, 4) and tu.same(a, a.copy())
    tu.assert_almost_equal(a, a.asnumpy() + 1e-9)
    assert tu.almost_equal(a, a) and len(tu.rand_shape_nd(3)) == 3
    assert tu.default_context() == tmx.cpu()
    assert tu.check_numeric_gradient(
        lambda x: (x * x * x).sum(),
        [np.random.RandomState(0).rand(3).astype(np.float32)], ctx=tmx.cpu())
    tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
