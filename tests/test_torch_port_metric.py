"""``mx.metric``, ``mx.callback`` and ``mx.monitor`` of the port against the
JAX package's on the same numpy inputs: every metric's name and value
(fp32 1e-5), the registry's names and configs, the callbacks' files, and
the Monitor's entries on an eager and a hybridized block."""
import logging

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import metric as tmetric
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")


def _inputs(seed, n=12, c=4):
    rng = np.random.RandomState(seed)
    pred = rng.rand(n, c).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rng.randint(0, c, n).astype(np.float32)
    return label, pred


def _reg_inputs(seed, n=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            rng.randn(n, 1).astype(np.float32))


CASES = [
    ("acc", {}, "cls"), ("accuracy", {}, "cls"),
    ("top_k_accuracy", {"top_k": 2}, "cls"), ("top_k_acc", {"top_k": 3},
                                              "cls"),
    ("f1", {}, "bin"), ("f1", {"average": "micro"}, "cls"),
    ("f1", {"average": "macro"}, "cls"), ("mcc", {}, "bin"),
    ("mae", {}, "reg"), ("mse", {}, "reg"), ("rmse", {}, "reg"),
    ("ce", {}, "cls"), ("crossentropy", {"eps": 1e-8}, "cls"),
    ("negativeloglikelihood", {}, "cls"),
    ("perplexity", {}, "cls"), ("perplexity", {"ignore_label": 1}, "cls"),
    ("pearsoncorrelation", {}, "reg"), ("loss", {}, "cls"),
]


def _feed(kind, seed):
    if kind == "reg":
        return _reg_inputs(seed)
    label, pred = _inputs(seed, c=2 if kind == "bin" else 4)
    return label, pred


@pytest.mark.parametrize("name,kw,kind", CASES,
                         ids=["%s-%s" % (c[0], "-".join(map(str, c[1].values())))
                              for c in CASES])
def test_metric_matches(name, kw, kind):
    import mxnet_tpu.metric as jmetric
    from mxnet_tpu import nd as jnd

    jm, tm = jmetric.create(name, **kw), tmetric.create(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    for seed in range(3):  # three batches: the metric accumulates
        label, pred = _feed(kind, seed)
        jm.update([jnd.array(label)], [jnd.array(pred)])
        with tmx.cpu():
            tm.update([tmx.nd.array(label)], [tmx.nd.array(pred)])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert tm.get_name_value() == [(tn, tv)]
    tm.reset()
    assert tm.num_inst == 0


def test_metric_accepts_bare_arrays_tensors_and_numpy():
    import torch

    label, pred = _inputs(0)
    vals = []
    for wrap in (np.asarray, torch.from_numpy,
                 lambda a: tmx.nd.array(a, ctx=tmx.cpu())):
        m = tmetric.Accuracy()
        m.update(wrap(label), wrap(pred))
        vals.append(m.get()[1])
    assert vals[0] == vals[1] == vals[2]


def test_composite_custom_np_and_configs():
    import mxnet_tpu.metric as jmetric

    label, pred = _inputs(5)

    def feval(l, p):
        return float((p.argmax(1) == l).sum()), l.size

    for mod in (jmetric, tmetric):
        assert isinstance(mod.create(["acc", "mse"]),
                          mod.CompositeEvalMetric)
    jc = jmetric.create(["acc", '{"type": "f1", "average": "micro"}'])
    tc = tmetric.create(["acc", '{"type": "f1", "average": "micro"}'])
    jc.update([label], [pred])
    tc.update([label], [pred])
    assert tc.get()[0] == jc.get()[0]
    np.testing.assert_allclose(tc.get()[1], jc.get()[1], rtol=1e-6)
    jn, tn = jmetric.np(feval, name="hits"), tmetric.np(feval, name="hits")
    jn.update([label], [pred])
    tn.update([label], [pred])
    assert tn.get() == jn.get()
    tcust = tmetric.create(lambda l, p: float(np.abs(l - p.argmax(1)).sum()))
    jcust = jmetric.create(lambda l, p: float(np.abs(l - p.argmax(1)).sum()))
    tcust.update([label], [pred])
    jcust.update([label], [pred])
    assert tcust.get()[1] == jcust.get()[1]
    with pytest.raises(ValueError):
        tmetric.CustomMetric(feval).update([label, label], [pred])
    with pytest.raises(ValueError):
        tmetric.create("no_such_metric")

    @tmetric.register
    class Zero(tmetric.EvalMetric):
        def __init__(self, name="zero", **kwargs):
            super().__init__(name, **kwargs)

        def update(self, labels, preds):
            self.num_inst += 1

    assert isinstance(tmetric.create("zero"), Zero)


@pytest.mark.parametrize("wrap,shape", [(False, False), (True, False),
                                        (True, True)])
def test_check_label_shapes_matches(wrap, shape):
    import mxnet_tpu.metric as jmetric

    a, b = np.zeros((4, 2)), np.zeros((4, 2))
    jl, jp = jmetric.check_label_shapes(a, b, wrap=wrap, shape=shape)
    tl, tp = tmetric.check_label_shapes(a, b, wrap=wrap, shape=shape)
    assert type(tl) is type(jl) and type(tp) is type(jp)
    for mod in (jmetric, tmetric):
        with pytest.raises(ValueError):
            mod.check_label_shapes(np.zeros(3), np.zeros(4), wrap=wrap,
                                   shape=shape)


# ---------------------------------------------------------------- callbacks

def test_callbacks_match(tmp_path, caplog):
    import mxnet_tpu.callback as jcb
    import mxnet_tpu.metric as jmetric
    from mxnet_tpu_torch import callback as tcb

    label, pred = _inputs(1)
    for mod, met in ((jcb, jmetric), (tcb, tmetric)):
        m = met.create("acc")
        m.update([label], [pred])
        with caplog.at_level(logging.INFO):
            caplog.clear()
            mod.log_train_metric(2)(mod.BatchEndParam(1, 4, m))
            mod.LogValidationMetricsCallback()(mod.BatchEndParam(1, 4, m))
            mod.ProgressBar(8, length=10)(mod.BatchEndParam(0, 4, m))
            msgs = [r.getMessage() for r in caplog.records]
        if mod is jcb:
            want = msgs
        else:
            assert msgs == want
    sp = tcb.Speedometer(8, frequent=2)
    m = tmetric.create("acc")
    m.update([label], [pred])
    for n in range(5):
        sp(tcb.BatchEndParam(0, n, m))
    assert len(sp.speeds) == 2 and all(s > 0 for s in sp.speeds)


def test_do_checkpoint_files_match(tmp_path):
    import mxnet_tpu.callback as jcb
    import mxnet_tpu.symbol as jsym
    from mxnet_tpu import nd as jnd
    from mxnet_tpu_torch import callback as tcb
    from mxnet_tpu_torch import symbol as tsym

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    jcb.do_checkpoint(str(tmp_path / "j"), period=2)(
        1, jsym.var("x") * 2, {"w": jnd.array(w)}, {})
    tcb.do_checkpoint(str(tmp_path / "t"), period=2)(
        1, tsym.var("x") * 2, {"w": tmx.nd.array(w, ctx=tmx.cpu())}, {})
    tcb.do_checkpoint(str(tmp_path / "t"), period=2)(
        2, None, {"w": tmx.nd.array(w, ctx=tmx.cpu())}, {})
    jz, tz = (np.load(str(tmp_path / (p + "-0002.params")))
              for p in "jt")
    np.testing.assert_array_equal(tz["w"], jz["w"])
    assert not (tmp_path / "t-0003.params").exists()
    loaded = tsym.load(str(tmp_path / "j-symbol.json"))
    assert loaded.list_arguments() == ["x"]


# ------------------------------------------------------------------ monitor

def _nets():
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu_torch import gluon as tgluon

    out = []
    for g in (jgluon, tgluon):
        net = g.nn.HybridSequential()
        with net.name_scope():
            net.add(g.nn.Dense(4, activation="relu", in_units=5))
            net.add(g.nn.Dense(3, in_units=4))
        out.append(net)
    return out


def _copy_weights(jnet, tnet):
    import torch

    jp, tp = jnet.collect_params(), tnet.collect_params()
    for (jn, jv), (tn, tv) in zip(sorted(jp.items()), sorted(tp.items())):
        tv.set_data(torch.from_numpy(np.asarray(jv.data()._data)))


@pytest.mark.parametrize("hybridize", [False, True])
def test_monitor_entries_match(hybridize):
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.monitor import Monitor as JMonitor
    from mxnet_tpu_torch.monitor import Monitor as TMonitor

    jnet, tnet = _nets()
    jnet.initialize()
    tnet.initialize(device="cpu")
    _copy_weights(jnet, tnet)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    jm, tm = JMonitor(1).install(jnet), TMonitor(1).install(tnet)
    for step in range(3):
        jm.tic()
        jnet(jnd.array(x))
        jrows = jm.toc()
        tm.tic()
        with tmx.cpu():
            tnet(tmx.nd.array(x))
        trows = tm.toc()
        assert [(s, n) for s, n, _ in trows] == [(s, n) for s, n, _ in jrows]
        np.testing.assert_allclose([v for *_, v in trows],
                                   [v for *_, v in jrows], rtol=1e-5,
                                   atol=1e-6)
    assert len(trows) == (1 if hybridize else 4)
    tm.tic()
    tm.toc_print()
