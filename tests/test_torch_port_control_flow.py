"""Control flow of the port against the JAX package's on the same numpy
inputs (fp32 1e-5): ``nd.contrib`` ``foreach``/``while_loop``/``cond``
(values, and gradients against ``jax.grad`` of the JAX forms), the
``sym.contrib`` nodes through eval, the captured ``Executor`` (values and
gradients against the JAX executor), JSON both ways and ``infer_shape``;
the stochastic regions' structure (a shared node draws once a forward, a
body-private one each step and each forward); a cond whose unselected
branch has an infinite derivative keeps a finite gradient."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import engine
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch import symbol as tsymbol
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")
TOL = dict(rtol=1e-5, atol=1e-5)


def _a(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return tnd.array(x, ctx=tmx.cpu())


# ------------------------------------------------------------------- nd form

def _fe_body(x, s):
    return x * s + 1.0, s + x * 0.5


def test_nd_foreach_values_and_grads():
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import control_flow as jcf

    data, s0 = _a(5, 3), _a(3, seed=1)

    def jfun(d, s):
        outs, st = jcf.foreach(_fe_body, d, s)
        return (outs ** 2).sum() + (st * 3.0).sum(), (outs, st)

    (_, (jouts, jst)) = jfun(jnp.asarray(data), jnp.asarray(s0))
    jgd, jgs = jax.grad(lambda d, s: jfun(d, s)[0], argnums=(0, 1))(
        jnp.asarray(data), jnp.asarray(s0))
    d, s = _t(data), _t(s0)
    d.attach_grad()
    s.attach_grad()
    with tag.record():
        outs, st = tnd.contrib.foreach(_fe_body, d, s)
        loss = (outs ** 2).sum() + (st * 3.0).sum()
    loss.backward()
    np.testing.assert_allclose(outs.asnumpy(), np.asarray(jouts), **TOL)
    np.testing.assert_allclose(st.asnumpy(), np.asarray(jst), **TOL)
    np.testing.assert_allclose(d.grad.asnumpy(), np.asarray(jgd), **TOL)
    np.testing.assert_allclose(s.grad.asnumpy(), np.asarray(jgs), **TOL)


def test_nd_foreach_nested_states():
    from mxnet_tpu.ops import control_flow as jcf

    def body(x, states):
        h, c = states
        return [x + h, x * c], [h * 0.9 + x, c + 1.0]

    data, h0, c0 = _a(4, 2), _a(2, seed=2), _a(2, seed=3)
    jo, js = jcf.foreach(body, data, [h0, c0])
    to, ts = tnd.contrib.foreach(body, _t(data), [_t(h0), _t(c0)])
    for a, b in zip(to + ts, list(jo) + list(js)):
        np.testing.assert_allclose(a.asnumpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("max_iter", [3, 6, 10])
def test_nd_while_loop_bounded_matches(max_iter):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import control_flow as jcf

    def cond(vs):
        i, _ = vs
        return i < 5

    def func(vs):
        i, x = vs
        return x * 2.0, [i + 1, x * 1.5 + 0.25]

    x0 = _a(3, seed=4)

    def jfun(x):
        outs, (i, xf) = jcf.while_loop(cond, func, [jnp.asarray(0), x],
                                       max_iterations=max_iter)
        return outs.sum() + (xf ** 2).sum(), (outs, i, xf)

    _, (jo, ji, jx) = jfun(jnp.asarray(x0))
    jg = jax.grad(lambda x: jfun(x)[0])(jnp.asarray(x0))
    x = _t(x0)
    x.attach_grad()
    with tag.record():
        outs, (i, xf) = tnd.contrib.while_loop(
            cond, func, [tnd.array(np.int32(0), ctx=tmx.cpu()), x],
            max_iterations=max_iter)
        loss = outs.sum() + (xf ** 2).sum()
    loss.backward()
    assert outs.shape == (max_iter, 3)
    np.testing.assert_allclose(outs.asnumpy(), np.asarray(jo), **TOL)
    assert int(i.asscalar()) == int(ji)
    np.testing.assert_allclose(xf.asnumpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(jg), **TOL)


def test_nd_while_loop_sticky_flag():
    """The nd form's predicate is sticky: once false the loop stays done
    even if the predicate would turn true again (the JAX masked scan)."""
    from mxnet_tpu.ops import control_flow as jcf

    def cond(vs):
        return (vs[0] % 4) != 2  # false at 2, true again at 3

    def func(vs):
        return vs[0] * 1.0, [vs[0] + 1]

    jo, (ji,) = jcf.while_loop(cond, func, [np.int32(0)], max_iterations=6)
    to, (ti,) = tnd.contrib.while_loop(
        cond, func, [tnd.array(np.int32(0), ctx=tmx.cpu())],
        max_iterations=6)
    np.testing.assert_array_equal(to.asnumpy(), np.asarray(jo))
    assert int(ti.asscalar()) == int(ji) == 2


def test_nd_while_loop_unbounded_reads_on_the_host():
    from mxnet_tpu.ops import control_flow as jcf

    def cond(vs):
        return vs[1] < 100.0

    def func(vs):
        return None, [vs[0] + 1, vs[1] * 3.0]

    _, (jn, jx) = jcf.while_loop(cond, func, [np.int32(0), np.float32(1.5)])
    before = engine.while_host_read_counter.count
    out, (tn, tx) = tnd.contrib.while_loop(
        cond, func, [tnd.array(np.int32(0), ctx=tmx.cpu()),
                     tnd.array(np.float32(1.5), ctx=tmx.cpu())])
    assert out is None
    assert int(tn.asscalar()) == int(jn) == 4
    assert float(tx.asscalar()) == float(jx)
    assert engine.while_host_read_counter.count - before == 5


@pytest.mark.parametrize("flag", [True, False])
def test_nd_cond_values_and_grads(flag):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import control_flow as jcf

    x0 = _a(4, seed=5)

    def then_f(x):
        return x * 3.0

    def else_f(x):
        return x ** 2

    def jfun(x):
        return jcf.cond(jnp.asarray(flag), then_f, else_f, (x,)).sum()

    jg = jax.grad(jfun)(jnp.asarray(x0))
    x = _t(x0)
    x.attach_grad()
    before = engine.cond_host_read_counter.count
    with tag.record():
        out = tnd.contrib.cond(tnd.array(np.float32(flag), ctx=tmx.cpu()),
                               then_f, else_f, (x,))
        loss = out.sum()
    loss.backward()
    assert engine.cond_host_read_counter.count - before == 1
    np.testing.assert_allclose(float(loss.asscalar()), float(jfun(x0)),
                               **TOL)
    np.testing.assert_allclose(x.grad.asnumpy(), np.asarray(jg), **TOL)


def test_nd_cond_unselected_infinite_derivative_is_finite():
    x = _t(np.array([0.0, 1.0, 2.0], np.float32))
    x.attach_grad()
    with tag.record():
        out = tnd.contrib.cond(tnd.array(np.float32(1), ctx=tmx.cpu()),
                               lambda v: v * 2.0, lambda v: tnd.log(v), (x,))
        out.sum().backward()
    assert np.isfinite(x.grad.asnumpy()).all()
    np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 2.0, 2.0])


def test_nd_registry_nodes():
    """``nd._cond``, ``nd._foreach`` and ``nd._while`` are the graph nodes
    as ops over arrays (the JAX registry's)."""
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import sym as jsym_mod

    x0 = _a(4, 2, seed=6)
    for nd_mod, sym_mod, arr in ((jnd, jsym_mod, jnd.array),
                                 (tnd, tsym, _t)):
        x = sym_mod.var("x")
        then_sym, else_sym = x * 2.0, x - 1.0
        c = nd_mod._cond(arr(np.float32(0)), arr(x0), then_sym=then_sym,
                         else_sym=else_sym, arg_names=["x"])
        np.testing.assert_allclose(c.asnumpy(), x0 - 1.0, **TOL)
    assert not hasattr(tnd, "NOT_PORTED") or "_cond" not in tnd.NOT_PORTED


# ------------------------------------------------------------ symbol form

def _fe_graph(mod):
    data = mod.sym.var("data")
    s0 = mod.sym.var("s0")
    w = mod.sym.var("w")

    def body(x, s):
        h = mod.sym.tanh(mod.sym.broadcast_mul(x, w) + s)
        return h * 2.0, h

    outs, last = mod.sym.contrib.foreach(body, data, s0)
    return mod.sym.Group([outs, last])


def _wl_graph(mod):
    i0, x0 = mod.sym.var("i0"), mod.sym.var("x0")
    k = mod.sym.var("k")

    def cond(vs):
        return vs[0] < 3.0

    def func(vs):
        i, x = vs
        return x * k, [i + 1.0, mod.sym.sin(x) + k]

    outs, (i, x) = mod.sym.contrib.while_loop(cond, func, [i0, x0],
                                              max_iterations=5)
    return mod.sym.Group([outs, i, x])


def _cond_graph(mod):
    p, x = mod.sym.var("p"), mod.sym.var("x")
    return mod.sym.contrib.cond(p, lambda: x * 3.0 + 1.0,
                                lambda: mod.sym.log(x))


FEEDS = {
    "foreach": (_fe_graph, lambda: {"data": _a(6, 2, 3, seed=7),
                                    "s0": _a(2, 3, seed=8),
                                    "w": _a(3, seed=9)}),
    "while": (_wl_graph, lambda: {"i0": np.zeros((1,), np.float32),
                                  "x0": _a(2, 3, seed=10),
                                  "k": _a(2, 3, seed=11)}),
    "cond_true": (_cond_graph, lambda: {"p": np.ones((1,), np.float32),
                                        "x": _a(4, seed=12)}),
    "cond_false": (_cond_graph, lambda: {"p": np.zeros((1,), np.float32),
                                         "x": np.abs(_a(4, seed=12)) + .5}),
}


def _jax_exec(graph, feed):
    import mxnet_tpu as jmx
    from mxnet_tpu import nd as jnd

    sym = graph(jmx)
    args = {n: jnd.array(v) for n, v in feed.items()}
    grads = {n: jnd.zeros(v.shape) for n, v in feed.items()}
    ex = sym.bind(jmx.cpu(), args, grads)
    outs = ex.forward(is_train=True)
    ex.backward([jnd.ones(o.shape) for o in outs])
    return ([o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in ex.grad_dict.items()})


def _port_exec(graph, feed, ex=None):
    sym = graph(tmx)
    if ex is None:
        args = {n: _t(v) for n, v in feed.items()}
        grads = {n: tnd.zeros(v.shape, ctx=tmx.cpu())
                 for n, v in feed.items()}
        ex = sym.bind(tmx.cpu(), args, grads)
    outs = ex.forward(is_train=True, **{n: _t(v) for n, v in feed.items()})
    ex.backward()
    return ([o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in ex.grad_dict.items()}), ex, sym


@pytest.mark.parametrize("case", sorted(FEEDS))
def test_symbol_control_flow_matches(case):
    graph, make = FEEDS[case]
    feed = make()
    (jo, jg) = _jax_exec(graph, feed)
    (to, tg), ex, sym = _port_exec(graph, feed)
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    for n in feed:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)
    ev = sym.eval(**{n: _t(v) for n, v in feed.items()})
    for a, b in zip(ev, jo):
        np.testing.assert_allclose(a.asnumpy(), b, **TOL)
    # the JAX package's infer_shape through the nodes
    import mxnet_tpu as jmx

    shapes = {n: v.shape for n, v in feed.items()}
    ja, jout, _ = graph(jmx).infer_shape(**shapes)
    ta, tout, _ = sym.infer_shape(**shapes)
    assert [tuple(s) for s in ta] == [tuple(s) for s in ja]
    assert [tuple(s) for s in tout] == [tuple(s) for s in jout]


@pytest.mark.parametrize("case", sorted(FEEDS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_control_flow_json_both_ways(case, writer):
    import mxnet_tpu as jmx
    import mxnet_tpu.symbol as jsymbol
    from mxnet_tpu import nd as jnd

    graph, make = FEEDS[case]
    feed = make()
    if writer == "jax":
        text = graph(jmx).tojson()
    else:
        text = graph(tmx).tojson()
    tloaded, jloaded = tsymbol.loads(text), jsymbol.loads(text)
    tout = tloaded.eval(**{n: _t(v) for n, v in feed.items()})
    jout = jloaded.eval(**{n: jnd.array(v) for n, v in feed.items()})
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    assert tloaded.list_arguments() == jloaded.list_arguments()
    # a written graph reads back and writes the same text
    assert tsymbol.loads(tloaded.tojson()).tojson() == tloaded.tojson()


def test_executor_keys_its_program_on_the_predicate():
    """One program a branch. A forward runs the branch the last one took
    and reads the predicate its program computed; where the predicate
    flipped, it runs again on the other program (the then branch first)."""
    feed = FEEDS["cond_true"][1]()
    before = engine.cond_host_read_counter.count
    reruns = engine.cond_rerun_counter.count
    (_, _), ex, _ = _port_exec(_cond_graph, feed)
    (o2, _), ex, _ = _port_exec(_cond_graph, dict(feed, p=np.zeros(
        (1,), np.float32), x=np.abs(feed["x"]) + 1.0), ex)
    (_, _), ex, _ = _port_exec(_cond_graph, feed, ex)
    (_, _), ex, _ = _port_exec(_cond_graph, feed, ex)
    assert ex.stats["forward_captures"] == 2
    assert ex.stats["forward_replays"] == 6
    assert engine.cond_rerun_counter.count - reruns == 2
    assert engine.cond_host_read_counter.count - before == 6
    np.testing.assert_allclose(o2[0], np.log(np.abs(feed["x"]) + 1.0),
                               **TOL)


def test_cond_predicate_over_a_dropout_picks_its_own_draw():
    """A predicate over a Dropout the branches share: the branch taken is
    the one the forward's own mask picks (the mask drawn once a forward,
    a run again after a flip drawing the same one), both branches are
    taken over the forwards, and one seed gives one output."""
    x = tsym.var("x")
    d = tsym.Dropout(x, p=0.5)
    out = tsym.contrib.cond(tsym.sum(d) > 16.0, lambda: d * 2.0,
                            lambda: d * 3.0)
    graph = tsym.Group([out, d])
    ones = _t(np.ones((16,), np.float32))
    ex = graph.bind(tmx.cpu(), {"x": ones})
    tmx.random.seed(3)
    taken = []
    for _ in range(16):
        o, dv = [a.asnumpy() for a in ex.forward(is_train=True)]
        then = dv.sum() > 16.0
        np.testing.assert_array_equal(o, dv * (2.0 if then else 3.0))
        taken.append(bool(then))
    assert any(taken) and not all(taken)
    again = graph.bind(tmx.cpu(), {"x": ones})
    tmx.random.seed(3)
    for _ in range(16):
        o2 = again.forward(is_train=True)[0].asnumpy()
    np.testing.assert_array_equal(o2, o)


def test_cond_predicate_is_computed_once_a_run(monkeypatch):
    """The predicate's subgraph (here a LayerNorm, a kernel on the card)
    runs inside the forward's program, once a run: a forward whose
    predicate keeps its branch calls it once, a flip once more."""
    calls = []
    ln = tsymbol._registry()["LayerNorm"]

    def counted(*a, **k):
        calls.append(1)
        return ln(*a, **k)

    monkeypatch.setitem(tsymbol._registry(), "LayerNorm", counted)
    x, g, b = tsym.var("x"), tsym.var("g"), tsym.var("b")
    pred = tsym.mean(tsym.LayerNorm(x, g, b)) > tsym.var("t")
    out = tsym.contrib.cond(pred, lambda: x * 2.0, lambda: x - 1.0)
    feed = {"x": _t(_a(4, 8, seed=1)), "g": _t(np.ones(8, np.float32)),
            "b": _t(np.zeros(8, np.float32)),
            "t": _t(np.full((1,), -1.0, np.float32))}
    ex = out.bind(tmx.cpu(), feed)
    for _ in range(3):
        ex.forward(is_train=False)
    assert len(calls) == 3
    got = ex.forward(is_train=False,
                     t=_t(np.ones((1,), np.float32)))[0].asnumpy()
    assert len(calls) == 5
    np.testing.assert_allclose(got, _a(4, 8, seed=1) - 1.0, **TOL)


def test_symbol_cond_unselected_infinite_derivative_is_finite():
    """``lax.cond`` differentiates one branch; a graph that computed both
    and selected would give NaN here (log at 0 and below)."""
    feed = {"p": np.ones((1,), np.float32),
            "x": np.array([0.0, -1.0, 2.0], np.float32)}
    (jo, jg) = _jax_exec(_cond_graph, feed)
    (to, tg), _, _ = _port_exec(_cond_graph, feed)
    assert np.isfinite(tg["x"]).all()
    np.testing.assert_allclose(tg["x"], jg["x"], **TOL)
    np.testing.assert_allclose(tg["x"], [3.0, 3.0, 3.0])


def test_symbol_loop_refusals_and_errors():
    x = tsym.var("x")
    with pytest.raises(ValueError):
        tsym.contrib.while_loop(lambda v: v < 1, lambda v: (v, v), x,
                                max_iterations=None)
    with pytest.raises(TypeError):
        tsym.contrib.foreach(lambda a, s: (a, s), np.zeros(3), x)
    with pytest.raises(NotImplementedError):
        tsym.contrib.foreach(lambda a, s: ([a, a], s), x, x)
    with pytest.raises(ValueError):
        tsym.contrib.foreach(lambda a, s: (a, [s, s]), x, [x])


# ------------------------------------------------------- stochastic regions

def test_shared_node_draws_once_and_private_draws_each_step():
    data = tsym.var("data")
    s0 = tsym.var("s0")
    shared = tsym.Dropout(tsym.var("z"), p=0.5)  # outer and body

    def body(x, s):
        return tsym.Dropout(x, p=0.5), s + shared  # the mask: body only

    outs, last = tsym.contrib.foreach(body, data, s0)
    graph = tsym.Group([outs, last, shared])
    T, n = 6, 64
    feed = {"data": np.ones((T, n), np.float32),
            "s0": np.zeros((n,), np.float32),
            "z": np.ones((n,), np.float32)}
    ex = graph.bind(tmx.cpu(), {k: _t(v) for k, v in feed.items()})
    tmx.random.seed(0)
    o1, last1, shared1 = [o.asnumpy() for o in ex.forward(is_train=True)]
    # the shared draw: the state gathered it T times, the outer head once
    np.testing.assert_allclose(last1, T * shared1, **TOL)
    # the private mask changes from step to step
    assert any(not np.array_equal(o1[0] != 0, o1[t] != 0)
               for t in range(1, T))
    o2 = ex.forward(is_train=True)[0].asnumpy()
    assert not np.array_equal(o1 != 0, o2 != 0)  # and between forwards
    # eval mode: no draw at all
    o3, last3, shared3 = [o.asnumpy() for o in ex.forward(is_train=False)]
    np.testing.assert_array_equal(o3, np.ones((T, n), np.float32))
    np.testing.assert_array_equal(shared3, np.ones(n, np.float32))


def test_shared_stochastic_ids_regions():
    x = tsym.var("x")
    d = tsym.Dropout(x, p=0.5)
    c = tsym.contrib.cond(tsym.var("p"), lambda: d * 2.0,
                          lambda: x + 1.0)
    g = tsym.Group([c, d])
    shared = tsymbol._shared_stochastic_ids([g])
    assert id(d) in shared
    c2 = tsym.contrib.cond(tsym.var("p"), lambda: tsym.Dropout(x, p=.5),
                           lambda: x)
    inner = c2._attrs["then_sym"]
    assert id(inner) not in tsymbol._shared_stochastic_ids([c2])
