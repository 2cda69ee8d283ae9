"""C.14: the public names the port lacked, in behaviour, each against the
JAX package where both compute: a Parameter's ``lr_mult``/``wd_mult`` in
a Trainer step, ``setattr``/``reset_ctx``/``list_ctx``/``var``,
``mx.random.*`` through ``nd.random``, ``amp``'s names,
``BERTClassifier``, the exact npz bytes both ways, the serving snapshot
helpers, ``summary``/``serve``, the initializer names, the context ids,
``KVStore.set_weight_update_sharding``, ``util``'s environment helpers,
``profiler.op_scope`` and ``observability.note_compile``."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import from_jax_params
from torch_port_helpers import (SEQ, SMALL_BERT, bert_inputs,  # noqa: F401
                                jax_params, jax_trace_state)
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, in_units=4))
        net.add(pkg.gluon.nn.Dense(3, in_units=5))
    return net


def _step(pkg, net, x, y, mults):
    """One SGD step (wd 0.1) of a squared loss; ``mults``: {layer index:
    (lr_mult, wd_mult)} of its weight."""
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5, "wd": 0.1})
    for i, (lr, wd) in mults.items():
        w = net[i].weight
        if pkg is mx:  # the port honours the Parameter's own multipliers
            w.lr_mult, w.wd_mult = lr, wd
        else:  # the JAX Trainer reads the optimizer's tables only
            tr._optimizer.set_lr_mult({w.name: lr})
            tr._optimizer.set_wd_mult({w.name: wd})
    with pkg.autograd.record():
        loss = ((net(x) - y) ** 2).sum()
    loss.backward()
    tr.step(1)
    return {p.name[len(net.prefix):]: p.data().asnumpy()
            for p in net.collect_params().values()}


def test_lr_and_wd_mult_in_a_trainer_step(jax_trace_state):
    rng = np.random.RandomState(0)
    xa, ya = rng.randn(6, 4).astype(np.float32), rng.randn(6, 3)
    jnet = _mlp(jmx)
    jnet.initialize()
    with mx.cpu():
        tnet = from_jax_params(_mlp(mx), jax_params(jnet))
        mults = {0: (0.1, 2.0), 1: (0.0, 1.0)}
        got = _step(mx, tnet, mx.nd.array(xa),
                    mx.nd.array(ya.astype(np.float32)), mults)
    want = _step(jmx, jnet, jmx.nd.array(xa),
                 jmx.nd.array(ya.astype(np.float32)), mults)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    # lr_mult 0 kept the second weight; the first moved less than its bias
    w1 = jax_params(jnet)[jnet[1].weight.name]
    np.testing.assert_array_equal(got["dense1_weight"], w1)


def test_parameter_constructor_and_dict_helpers():
    with mx.cpu():
        p = mx.gluon.Parameter("w", shape=(2, 3), lr_mult=0.1, wd_mult=0.0,
                               differentiable=False)
        assert (p.lr_mult, p.wd_mult, p.grad_req) == (0.1, 0.0, "null")
        # sparse storage types are kept (A.17); an unknown one
        # raises
        sp = mx.gluon.Parameter("s", shape=(2,), stype="row_sparse",
                                grad_stype="row_sparse")
        assert (sp._stype, sp._grad_stype) == ("row_sparse", "row_sparse")
        with pytest.raises(ValueError):
            mx.gluon.Parameter("s", shape=(2,), grad_stype="dense")
        assert p.list_ctx() == []
        p.initialize(mx.init.One())
        assert p.list_ctx() == [mx.cpu()]
        p.reset_ctx(mx.cpu())
        v = p.var()
        assert v.name == "w" and v.list_arguments() == ["w"]
        net = _mlp(mx)
        net.initialize()
        net.collect_params().setattr("grad_req", "null")
        assert all(q.grad_req == "null"
                   for q in net.collect_params().values())
        net.collect_params().reset_ctx(mx.cpu())


def test_random_delegates_to_nd_random():
    with mx.cpu():
        for name, kw in (("uniform", {"shape": (3, 4)}),
                         ("normal", {"shape": (3, 4)}),
                         ("randint", {"low": 0, "high": 9, "shape": (5,)}),
                         ("exponential", {"shape": (4,)}),
                         ("gamma", {"shape": (4,)}),
                         ("poisson", {"shape": (4,)}),
                         ("negative_binomial", {"k": 3, "p": 0.5,
                                                "shape": (4,)})):
            mx.random.seed(7)
            a = getattr(mx.random, name)(**kw).asnumpy()
            mx.random.seed(7)
            b = getattr(mx.nd.random, name)(**kw).asnumpy()
            np.testing.assert_array_equal(a, b)
        mx.random.seed(3)
        assert mx.random.randn(2, 3).shape == (2, 3)
        probs = mx.nd.array(np.full((2, 4), 0.25, np.float32))
        assert mx.random.multinomial(probs).shape == (2,)
        x = mx.nd.array(np.arange(10, dtype=np.float32))
        assert mx.random.shuffle(x) is None
        assert sorted(x.asnumpy().tolist()) == list(range(10))


def test_amp_names_like_jax(jax_trace_state):
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp

    def bn_net(pkg):
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(4, in_units=4))
            net.add(pkg.gluon.nn.BatchNorm(in_channels=4))
        return net

    jnet, tnet = bn_net(jmx), bn_net(mx)
    jnet.initialize()
    tnet.initialize(ctx=mx.cpu())
    jamp.convert_model(jnet)
    amp.convert_model(tnet)
    jd = sorted((p.name[len(jnet.prefix):], np.dtype(p.dtype).name)
                for p in jnet.collect_params().values())
    td = sorted((p.name[len(tnet.prefix):],
                 str(p.dtype).replace("torch.", ""))
                for p in tnet.collect_params().values())
    assert jd == td
    amp.init()
    tr = mx.gluon.Trainer(tnet.collect_params(), "sgd")
    assert amp.init_trainer(tr) is tr and tr.optimizer.multi_precision
    loss = mx.nd.array(np.ones(2, np.float32), ctx=mx.cpu())
    with amp.scale_loss(loss, tr) as scaled:
        assert scaled is loss
    # the loss scaler's arithmetic and schedule equal the JAX one's
    js, ts = jamp.LossScaler(init_scale=8.0, scale_window=2), \
        amp.LossScaler(init_scale=8.0, scale_window=2)
    g = np.array([1.0, 2.0], np.float32)
    assert float(ts.scale(torch.tensor(3.0))) == float(js.scale(3.0))
    np.testing.assert_array_equal(ts.unscale([torch.from_numpy(g)])[0],
                                  np.asarray(js.unscale([g])[0]))
    bad = np.array([np.inf, 1.0], np.float32)
    assert ts.has_overflow([torch.from_numpy(bad)]) == \
        js.has_overflow([jmx.nd.array(bad)]) is True
    assert not ts.has_overflow([torch.from_numpy(g)])
    for overflow in (True, False, False, False, True):
        assert ts.update(overflow) == js.update(overflow)


def _structural(block):
    return {k: p for k, p in block._collect_params_with_prefix().items()}


def test_bert_classifier_equals_jax(jax_trace_state):
    from mxnet_tpu.models.bert import BERTClassifier as JCls
    from mxnet_tpu.models.bert import BERTModel as JBert
    from mxnet_tpu_torch.models.bert import BERTClassifier, BERTModel

    jcls = JCls(JBert(**SMALL_BERT), num_classes=3, dropout=0.0)
    jcls.initialize()
    tcls = BERTClassifier(BERTModel(**SMALL_BERT), num_classes=3,
                          dropout=0.0)
    tcls.initialize(ctx=mx.cpu())
    jp, tp = _structural(jcls), _structural(tcls)
    assert sorted(jp) == sorted(tp)
    for k, p in tp.items():
        p.set_data(torch.from_numpy(np.array(jp[k].data()._data)))
    tok, tt, vl = bert_inputs(5, 3)
    got = tcls(torch.from_numpy(tok), torch.from_numpy(tt),
               torch.from_numpy(vl)).detach().numpy()
    want = jcls(jmx.nd.array(tok, dtype="int32"),
                jmx.nd.array(tt, dtype="int32"),
                jmx.nd.array(vl, dtype="int32")).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    from mxnet_tpu_torch.models.bert import bert_large

    big = bert_large()
    assert (big._units, len(big.encoder.cells)) == (1024, 24)


def test_npz_bytes_both_ways(jax_trace_state):
    import jax.numpy as jnp

    from mxnet_tpu import util as jutil
    from mxnet_tpu_torch import util

    rng = np.random.RandomState(2)
    bf = torch.from_numpy(rng.randn(3, 5).astype(np.float32)).to(
        torch.bfloat16)
    ints = rng.randint(0, 9, (4,)).astype(np.int32)
    blob = util.dumps_npz_exact({"a": bf, "b": ints})
    back = jutil.loads_npz_exact(blob)
    assert back["a"].dtype == jnp.bfloat16 and back["b"].dtype == np.int32
    np.testing.assert_array_equal(back["a"].view(np.uint16),
                                  bf.view(torch.int16).numpy()
                                  .view(np.uint16))
    jblob = jutil.dumps_npz_exact({"a": np.asarray(jnp.asarray(
        rng.randn(2, 3), jnp.bfloat16)), "b": ints})
    mine = util.loads_npz_exact(jblob)
    assert mine["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mine["a"].view(torch.int16).numpy().view(np.uint16),
        jutil.loads_npz_exact(jblob)["a"].view(np.uint16))
    np.testing.assert_array_equal(mine["b"].numpy(), ints)
    # a round trip of the port's own bytes is exact
    again = util.loads_npz_exact(util.dumps_npz_exact(mine))
    assert torch.equal(again["a"], mine["a"])


def test_serving_names(tmp_path):
    from mxnet_tpu_torch import checkpoint, serve

    with mx.cpu():
        net = _mlp(mx)
        net.initialize()
        srv = net.serve([((4,), "float32")], buckets=(2,))
        assert isinstance(srv, serve.ModelServer)
        x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
        with srv:
            want = srv.predict(x)
        prefix = str(tmp_path / "mlp")
        path = srv.snapshot(prefix)
        assert os.path.exists(path)
        checkpoint.save_serving_snapshot(srv, prefix + "b")
        loaded = checkpoint.load_serving_snapshot(prefix + "b", device="cpu")
        with loaded:
            got = loaded.predict(x)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert isinstance(mx.gluon.nn.SymbolBlock.imports(
            prefix + "-symbol.json", ["data"], prefix + "-0000.params",
            ctx=mx.cpu()), mx.gluon.SymbolBlock)
        assert mx.gluon.metric.Accuracy is mx.metric.Accuracy
        out = net.summary(mx.nd.array(x))
        assert out.shape == (2, 3)


def test_initializer_context_and_env_names(tmp_path, monkeypatch):
    from mxnet_tpu_torch import context, kvstore, observability, profiler
    from mxnet_tpu_torch import quant, quantization, util

    @mx.init.register
    class Twos(mx.init.Initializer):
        def _init_weight(self, shape, device, generator):
            return torch.full(shape, 2.0, device=device)

    assert isinstance(mx.init.create("twos"), Twos)
    assert mx.initializer.Zeros is mx.init.Zero
    assert mx.init.Ones is mx.initializer.One
    desc = mx.init.InitDesc("w", attrs={"a": 1})
    assert desc == "w" and desc.attrs == {"a": 1}
    arr = mx.nd.zeros((2, 2), ctx=mx.cpu())
    Twos().init_array("fc_weight", arr)
    assert float(arr.asnumpy().min()) == 2.0
    assert mx.cpu().device_typeid == 1 and mx.gpu(0).device_typeid == 2
    assert mx.Context(2, 0) == mx.gpu(0)
    assert mx.Context.devtype2str[3] == "cpu_pinned"
    assert mx.Context.devstr2type["gpu"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.base.DeviceError):
        context.gpu_memory_info(0)
    kv = kvstore.create("local")
    with pytest.raises(RuntimeError):
        kv.set_weight_update_sharding(None)
    kv.set_optimizer(mx.optimizer.SGD())
    kv.set_weight_update_sharding(None)
    util.setenv("MXTPU_C14_PROBE", "1")
    assert util.getenv("MXTPU_C14_PROBE") == "1"
    monkeypatch.delenv("MXTPU_C14_PROBE")
    util.makedirs(str(tmp_path / "a" / "b"))
    assert os.path.isdir(tmp_path / "a" / "b")
    assert quant.QuantizedConv2D is quantization.QuantizedConv2D
    assert quant.quantized_conv is quantization.quantized_conv
    before = observability.snapshot()["metrics"]["counters"].get(
        "compiles_total", 0)
    observability.note_compile(0.25)
    assert observability.snapshot()["metrics"]["counters"][
        "compiles_total"] == before + 1
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.start()
    with profiler.op_scope("probe_op"):
        pass
    profiler.stop()
    assert "probe_op" in profiler.dumps(reset=True)
