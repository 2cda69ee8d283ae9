"""The port's symbolic core (``name``, ``attribute``, ``symbol``, ``sym``,
``shape_inference``, ``Executor``, ``visualization``, the symbolic checks
of ``test_utils``) against the JAX package's on the same graphs and numpy
inputs (fp32 1e-5): naming and attribute scopes (tests/test_namespaces.py
:10-58), shape inference with parameter deduction (the cases of
tests/test_module_api.py:31-149), the JSON both ways, the Executor at
every ``grad_req``, ``is_train`` on Dropout and BatchNorm
(tests/test_module_api.py:208-282), ``reshape`` and
``copy_params_from``, ``check_symbolic_forward``/``_backward`` and
``print_summary``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import sym as jsym
from mxnet_tpu import symbol as jsymbol
from mxnet_tpu_torch import attribute, name, nd, sym, symbol, test_utils
from mxnet_tpu_torch.shape_inference import infer_shapes_partial
from mxnet_tpu_torch.visualization import plot_network, print_summary
from torch_port_helpers import jax_trace_state  # noqa: F401

CPU = "cpu"


def _conv_net(S):
    data, label = S.var("data"), S.var("softmax_label")
    c = S.Convolution(data, S.var("conv_weight"), S.var("conv_bias"),
                      kernel=(3, 3), num_filter=6, pad=1)
    bn = S.BatchNorm(c, S.var("bn_gamma"), S.var("bn_beta"), S.var("bn_mm"),
                     S.var("bn_mv"))[0]
    p = S.Pooling(S.relu(bn), kernel=(2, 2), stride=(2, 2),
                  pool_type="max")
    fc = S.FullyConnected(p, S.var("fc_weight"), S.var("fc_bias"),
                          num_hidden=5)
    return S.SoftmaxOutput(fc, label)


def test_name_manager_uniquifies_and_prefixes():
    a = sym.var("x", shape=(2, 2))
    s1, s2 = sym.relu(a), sym.relu(a)
    assert s1.name != s2.name
    with name.Prefix("net_"):
        assert sym.relu(a).name.startswith("net_relu")
    with name.NameManager():
        assert sym.relu(a).name == "relu0"
    assert sym.relu(a, name="myrelu").name == "myrelu"
    fc = sym.FullyConnected(sym.var("x"), num_hidden=3, name="fc1")
    assert fc.list_arguments() == ["x", "fc1_weight", "fc1_bias"]
    assert sym.FullyConnected(sym.var("x"), num_hidden=3, no_bias=True,
                              name="fc2").list_arguments() == \
        ["x", "fc2_weight"]


def test_attr_scope_attaches_nests_and_never_executes():
    a = sym.var("x", shape=(2, 2))
    with attribute.AttrScope(ctx_group="dev1"):
        s = sym.Activation(a, act_type="relu")
    assert s.attr("ctx_group") == "dev1" and s.attr("act_type") == "relu"
    with attribute.AttrScope(a1="x"):
        with attribute.AttrScope(a2="y"):
            s2 = sym.relu(a)
    assert s2.attr("a1") == "x" and s2.attr("a2") == "y"
    out = s.eval(x=nd.array([[1.0, -1.0], [2.0, -2.0]], ctx=CPU))
    np.testing.assert_array_equal(out[0].asnumpy(), [[1, 0], [2, 0]])
    with pytest.raises(ValueError):
        attribute.AttrScope(bad=3)


def test_attr_scope_does_not_leak_into_load(tmp_path):
    s = sym.relu(sym.var("x", shape=(2, 2)))
    p = str(tmp_path / "g.json")
    s.save(p)
    with attribute.AttrScope(ctx_group="dev9"):
        loaded = symbol.load(p)
    assert loaded.attr("ctx_group") is None


def test_infer_shape_no_declared_shapes(jax_trace_state):
    for S in (sym, jsym):
        net = _conv_net(S)
        args, outs, _ = net.infer_shape(data=(2, 3, 8, 8),
                                        softmax_label=(2,))
        got = dict(zip(net.list_arguments(), args))
        assert got["conv_weight"] == (6, 3, 3, 3)
        assert got["bn_gamma"] == (6,)
        assert got["fc_weight"] == (5, 96) and got["fc_bias"] == (5,)
        assert outs[0] == (2, 5)
    assert _conv_net(sym).list_arguments() == \
        _conv_net(jsym).list_arguments()


def test_deconv_embedding_inference():
    y = sym.Deconvolution(sym.var("data"), sym.var("deconv_weight"),
                          kernel=(2, 2), stride=(2, 2), num_filter=4,
                          no_bias=True)
    args, outs, _ = y.infer_shape(data=(1, 3, 5, 5))
    assert dict(zip(y.list_arguments(), args))["deconv_weight"] == \
        (3, 4, 2, 2)
    assert outs[0] == (1, 4, 10, 10)
    e = sym.Embedding(sym.var("idx"), sym.var("embed_weight"), input_dim=11,
                      output_dim=7)
    args, outs, _ = e.infer_shape(idx=(4, 3))
    assert dict(zip(e.list_arguments(), args))["embed_weight"] == (11, 7)
    assert outs[0] == (4, 3, 7)


def test_infer_shape_order_independent():
    data, w = sym.var("data"), sym.var("fc_weight")
    reg = sym.sum(w * w)
    fc = sym.FullyConnected(data, w, num_hidden=3, no_bias=True)
    for group in (sym.Group([reg, fc]), sym.Group([fc, reg])):
        args, _, _ = group.infer_shape(data=(2, 4))
        assert dict(zip(group.list_arguments(), args))["fc_weight"] == (3, 4)


def test_infer_errors_name_the_failing_node():
    for w in (sym.var("w", shape=(7, 4)), sym.var("w2", shape=(3, 5))):
        fc = sym.FullyConnected(sym.var("data"), w, num_hidden=3,
                                no_bias=True)
        with pytest.raises(ValueError, match="FullyConnected"):
            fc.infer_shape(data=(2, 4))


def test_nhwc_conv_inference():
    y = sym.Convolution(sym.var("data"), sym.var("w"), kernel=(3, 3),
                        num_filter=8, layout="NHWC", no_bias=True)
    var_shapes, _, _ = infer_shapes_partial(y, {"data": (2, 8, 8, 3)})
    assert var_shapes["w"] == (8, 3, 3, 3)


def test_infer_type():
    x = sym.var("x", shape=(2, 3))
    y = sym.cast(x, dtype="float16") + 1.0
    args, outs, _ = y.infer_type(x="float32")
    assert args == [np.float32] and outs == [np.float16]
    assert (y * 2.0).shape == (2, 3)


def test_json_both_ways(tmp_path, jax_trace_state):
    rng = np.random.RandomState(0)
    vals = {"data": rng.randn(2, 3, 8, 8).astype(np.float32),
            "conv_weight": rng.randn(6, 3, 3, 3).astype(np.float32),
            "conv_bias": rng.randn(6).astype(np.float32),
            "bn_gamma": rng.rand(6).astype(np.float32) + 0.5,
            "bn_beta": rng.randn(6).astype(np.float32),
            "bn_mm": rng.randn(6).astype(np.float32),
            "bn_mv": rng.rand(6).astype(np.float32) + 0.5,
            "fc_weight": rng.randn(5, 96).astype(np.float32) * 0.1,
            "fc_bias": rng.randn(5).astype(np.float32),
            "softmax_label": np.array([1, 3], np.float32)}
    port_file, jax_file = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    _conv_net(sym).save(port_file)
    _conv_net(jsym).save(jax_file)
    outs = []
    for loader, arr in ((symbol.load, lambda v: nd.array(v, ctx=CPU)),
                        (jsymbol.load, jmx.nd.array)):
        for f in (port_file, jax_file):
            g = loader(f)
            outs.append(g.eval(**{n: arr(vals[n])
                                  for n in g.list_arguments()})[0].asnumpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5)
    a, b = symbol.load(jax_file), symbol.load(port_file)
    assert [(s._op, s._attrs) for s in symbol._topo(a)] == \
        [(s._op, s._attrs) for s in symbol._topo(b)]


def _mlp(S):
    x = S.var("x")
    h = S.FullyConnected(x, S.var("w1"), S.var("b1"), num_hidden=5)
    return S.FullyConnected(S.tanh(h), S.var("w2"), S.var("b2"),
                            num_hidden=3)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_forward_backward_every_grad_req(req, jax_trace_state):
    rng = np.random.RandomState(1)
    vals = {"x": rng.randn(4, 6), "w1": rng.randn(5, 6), "b1": rng.randn(5),
            "w2": rng.randn(3, 5), "b2": rng.randn(3)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    og = rng.randn(4, 3).astype(np.float32)
    init = {k: np.full_like(v, 0.5) for k, v in vals.items()}
    got = {}
    for S, mk in ((sym, lambda v: nd.array(v, ctx=CPU)),
                  (jsym, jmx.nd.array)):
        ex = _mlp(S).bind(ctx=jmx.cpu() if S is jsym else CPU,
                          args={k: mk(v) for k, v in vals.items()},
                          args_grad={k: mk(init[k]) for k in vals},
                          grad_req=req)
        for _ in range(2):
            out = ex.forward(is_train=True)[0]
            ex.backward(mk(og))
        got[S is sym] = (out.asnumpy(), {k: ex.grad_dict[k].asnumpy()
                                         for k in vals})
    (po, pg), (jo, jg) = got[True], got[False]
    np.testing.assert_allclose(po, jo, atol=1e-5)
    for k in vals:
        if req == "null":
            # upstream's null leaves the buffer alone; the JAX Executor
            # writes it as "write" does (ROADMAP.md C.2, not copied)
            np.testing.assert_array_equal(pg[k], init[k])
            assert not np.array_equal(jg[k], init[k])
        else:
            np.testing.assert_allclose(pg[k], jg[k], atol=1e-5, rtol=1e-5)


def test_executor_is_train_governs_dropout_and_batchnorm(jax_trace_state):
    x = sym.var("x", shape=(4, 50))
    ex = sym.Dropout(x, p=0.5).bind(ctx=CPU, args={
        "x": nd.array(np.ones((4, 50), np.float32), ctx=CPU)})
    np.testing.assert_array_equal(ex.forward(is_train=False)[0].asnumpy(),
                                  np.ones((4, 50), np.float32))
    t1 = ex.forward(is_train=True)[0].asnumpy()
    t2 = ex.forward(is_train=True)[0].asnumpy()
    assert (t1 == 0).any() and not np.array_equal(t1, t2)
    assert set(np.unique(t1)) <= {0.0, 2.0}
    assert ex.stats["forward_captures"] == 2 and ex.stats["recaptures"] == 0
    X = (np.random.RandomState(2).randn(8, 4) * 3 + 1.5).astype(np.float32)
    args = {"d": X, "g": np.ones(4), "b": np.zeros(4), "m": np.zeros(4),
            "v": np.ones(4)}
    got = {}
    for S, mk, ctx in ((sym, lambda v: nd.array(v, ctx=CPU), CPU),
                       (jsym, jmx.nd.array, jmx.cpu())):
        bn = S.BatchNorm(S.var("d"), S.var("g"), S.var("b"), S.var("m"),
                         S.var("v"))
        ex = bn.bind(ctx=ctx, args={k: mk(np.asarray(v, np.float32))
                                    for k, v in args.items()})
        got[S is sym] = [ex.forward(is_train=t)[0].asnumpy()
                         for t in (True, False)]
    np.testing.assert_allclose(got[True][0].mean(0), 0, atol=1e-5)
    for a, b in zip(got[True], got[False]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert not np.allclose(got[True][0], got[True][1])


def test_executor_backward_after_eval_forward():
    x = sym.var("x", shape=(4, 8))
    y = sym.Dropout(x, p=0.5) * 2.0
    ex = y.bind(ctx=CPU, args={"x": nd.array(np.ones((4, 8), np.float32),
                                            ctx=CPU)},
                args_grad={"x": nd.array(np.zeros((4, 8), np.float32),
                                         ctx=CPU)})
    ex.forward(is_train=True)
    ex.forward(is_train=False)
    ex.backward()
    assert set(np.unique(ex.grad_dict["x"].asnumpy())) <= {0.0, 4.0}


def test_simple_bind_reshape_and_copy_params_from():
    net = _conv_net(sym)
    ex = net.simple_bind(ctx=CPU, data=(2, 3, 8, 8), softmax_label=(2,))
    assert ex.arg_dict["conv_weight"].shape == (6, 3, 3, 3)
    assert ex.arg_dict["fc_weight"].shape == (5, 96)
    w = nd.array(np.ones((6, 3, 3, 3), np.float32), ctx=CPU)
    ex.copy_params_from({"conv_weight": w})
    w._data = w._data * 2  # the caller's later rebind does not reach it
    assert float(ex.arg_dict["conv_weight"].asnumpy().max()) == 1.0
    with pytest.raises(ValueError):
        ex.copy_params_from({"nope": w})
    ex2 = _mlp(sym).simple_bind(ctx=CPU, x=(4, 6))
    ex3 = ex2.reshape(x=(7, 6))
    assert ex3.arg_dict["x"].shape == (7, 6)
    assert ex3.forward()[0].shape == (7, 3)
    assert ex3.grad_dict["w1"].shape == (5, 6)
    with pytest.raises(ValueError):
        ex2.reshape(nope=(1,))


def test_check_symbolic_forward_and_backward():
    x, w = sym.var("x"), sym.var("w")
    y = sym.dot(x, w)
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    wv = np.ones((3, 4), np.float32)
    test_utils.check_symbolic_forward(y, [xv, wv], [xv @ wv], ctx=CPU)
    og = np.ones((2, 4), np.float32)
    test_utils.check_symbolic_backward(y, [xv, wv], [og],
                                       [og @ wv.T, xv.T @ og], ctx=CPU)
    with pytest.raises(AssertionError):
        test_utils.check_symbolic_forward(y, [xv, wv], [xv @ wv + 1],
                                          ctx=CPU)


def test_print_summary_rows_are_the_jax_packages(capsys):
    rows = print_summary(_conv_net(sym))
    jrows = jmx.visualization.print_summary(_conv_net(jsym))
    assert [(r[1], r[2].count(",")) for r in rows] == \
        [(r[1], r[2].count(",")) for r in jrows]
    assert "Total nodes: %d" % len(rows) in capsys.readouterr().out
    assert plot_network(_conv_net(sym)).startswith("digraph plot {")


def test_graph_ops(jax_trace_state):
    """``_const``, ``_filled``, ``_arange`` and ``_item`` (the graph's
    source ops and the projection of a multi-output op) against the JAX
    package's, through ``sym`` and ``eval``."""
    got = {}
    for S, mk in ((sym, lambda v: nd.array(v, ctx=CPU)),
                  (jsym, jmx.nd.array)):
        x = S.var("x")
        outs = [S.ones((2, 3)) * 2.0 + 1.5,
                S.full((2, 2), 7.0, dtype="int32"),
                S.arange(1, 7, 2, repeat=2),
                S.moments(x, axes=(1,))[1] * 1.0]
        vals = [S.Group(outs).eval(
            x=mk(np.arange(6, dtype=np.float32).reshape(2, 3)))]
        got[S is sym] = [o.asnumpy() for o in vals[0]]
    for a, b in zip(got[True], got[False]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6)
