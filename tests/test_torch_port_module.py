"""``mx.mod`` and ``mx.model`` of the port against the JAX package's on the
same numpy inputs and initial weights (fp32 1e-5): the cases of
``tests/test_module_api.py`` and ``tests/test_bucketing.py`` run in both
packages, a 2-layer GPT's loss symbol through ``Module.fit`` for 3 steps
(losses and parameters), the pooled ``predict`` against the per-batch
path, checkpoints read both ways (bf16 dtype-exact), and ``fit``'s unused
``batch_end_callback``/``eval_data`` pinned in both packages."""
import os
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.io import DataBatch as TBatch
from mxnet_tpu_torch.module import BucketingModule as TBucketing
from mxnet_tpu_torch.module import Module as TModule
from mxnet_tpu_torch.module import SequentialModule as TSequential
from torch_port_helpers import SMALL_GPT, jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = tmx.cpu()


def _jmx():
    import mxnet_tpu as jmx

    return jmx


def _arr(mod, x):
    if mod is tmx:
        return tnd.array(x, ctx=CPU)
    return mod.nd.array(x)


def _batch(mod, data, label=None, key=None):
    B = mod.io.DataBatch
    return B([_arr(mod, d) for d in data],
             None if label is None else [_arr(mod, l) for l in label],
             bucket_key=key)


def _np(a):
    return np.asarray(a.asnumpy(), np.float32)


def _init_from(jm, tm):
    """The JAX module's initial weights into the port module."""
    jargs, jaux = jm.get_params()
    merged = {k: _np(v) for k, v in {**jargs, **jaux}.items()}
    tm.set_params({k: torch.from_numpy(v) for k, v in merged.items()
                   if k in tm._arg_params}, allow_missing=False)


def _same_params(jm, tm, **tol):
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        np.testing.assert_allclose(_np(ta[k]), _np(ja[k]), err_msg=k,
                                   **(tol or TOL))
    for k in jx:
        np.testing.assert_allclose(_np(tx[k]), _np(jx[k]), err_msg=k,
                                   **(tol or TOL))


# --------------------------------------------------- test_module_api cases

def _conv_net(mod):
    S = mod.sym
    c = S.Convolution(S.var("data"), S.var("conv_weight"),
                      S.var("conv_bias"), kernel=(3, 3), num_filter=6, pad=1)
    bn = S.BatchNorm(c, S.var("bn_gamma"), S.var("bn_beta"), S.var("bn_mm"),
                     S.var("bn_mv"))[0]
    p = S.Pooling(S.relu(bn), kernel=(2, 2), stride=(2, 2), pool_type="max")
    fc = S.FullyConnected(p, S.var("fc_weight"), S.var("fc_bias"),
                          num_hidden=5)
    return S.SoftmaxOutput(fc, S.var("softmax_label"))


def _both(build, data_shapes, label_shapes=None, label_names=None,
          **bind_kw):
    jmx = _jmx()
    kw = {} if label_names is None else {"label_names": label_names}
    jm = jmx.mod.Module(build(jmx), **kw)
    tm = TModule(build(tmx), context=CPU, **kw)
    for m in (jm, tm):
        m.bind(data_shapes, label_shapes, **bind_kw)
    jm.init_params(jmx.init.Uniform(0.3))
    tm.init_params()
    _init_from(jm, tm)
    return jm, tm


def test_conv_bn_softmax_module_steps_match():
    """Three SGD steps of a conv + BatchNorm + SoftmaxOutput module: the
    outputs, the ``(prob - onehot) / N`` head, the BatchNorm write-back and
    the parameters."""
    jmx = _jmx()
    jm, tm = _both(_conv_net, [("data", (4, 3, 8, 8))],
                   [("softmax_label", (4,))])
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    for step in range(3):
        x = rng.randn(4, 3, 8, 8).astype(np.float32)
        y = rng.randint(0, 5, 4).astype(np.float32)
        outs = []
        for mod, m in ((jmx, jm), (tmx, tm)):
            m.forward(_batch(mod, [x], [y]), is_train=True)
            m.backward()
            m.update()
            outs.append(_np(m.get_outputs()[0]))
        np.testing.assert_allclose(outs[1], outs[0], **TOL)
    _same_params(jm, tm, rtol=1e-4, atol=1e-5)
    assert "bn_mm" in tm.get_params()[1] or "bn_mm" in tm.get_params()[0]


def test_infer_shape_and_binds_without_param_shapes():
    jmx = _jmx()
    for mod in (jmx, tmx):
        args, outs, _ = _conv_net(mod).infer_shape(data=(2, 3, 8, 8),
                                                   softmax_label=(2,))
        if mod is jmx:
            want = (args, outs)
        else:
            assert [tuple(a) for a in args] == [tuple(a) for a in want[0]]
            assert [tuple(o) for o in outs] == [tuple(o) for o in want[1]]
    tm = TModule(_conv_net(tmx), context=CPU)
    tm.bind([("data", (2, 3, 8, 8))], [("softmax_label", (2,))])
    tm.init_params()
    assert tm._arg_params["fc_weight"].shape == (5, 96)


def test_inputs_need_grad_matches():
    jmx = _jmx()

    def build(mod):
        S = mod.sym
        return S.FullyConnected(S.tanh(S.var("data")), S.var("w"),
                                S.var("b"), num_hidden=3)

    jm, tm = _both(build, [("data", (2, 4))], label_names=[],
                   inputs_need_grad=True)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    for mod, m in ((jmx, jm), (tmx, tm)):
        m.forward(_batch(mod, [x], []), is_train=True)
        m.backward([_arr(mod, np.ones((2, 3), np.float32))])
    np.testing.assert_allclose(_np(tm.get_input_grads()[0]),
                               _np(jm.get_input_grads()[0]), **TOL)
    tm2 = TModule(build(tmx), label_names=[], context=CPU)
    tm2.bind([("data", (2, 4))])
    tm2.init_params()
    with pytest.raises(AssertionError):
        tm2.get_input_grads()


def test_for_training_flag_default():
    S = tmx.sym
    fc = S.FullyConnected(S.var("data"), S.var("fc_weight"), num_hidden=2,
                          no_bias=True)
    m = TModule(fc, label_names=(), context=CPU)
    m.bind([("data", (2, 3))], for_training=False)
    m.init_params()
    m.forward(TBatch([tnd.array(np.ones((2, 3)), ctx=CPU)], None))
    assert m._exec._last is None  # an eval forward: nothing to backward


def test_sequential_module_matches():
    jmx = _jmx()
    mods = []
    for mod, M, Seq in ((jmx, jmx.mod.Module, jmx.mod.SequentialModule),
                        (tmx, TModule, TSequential)):
        S = mod.sym
        s1 = S.Activation(S.FullyConnected(S.var("data"), num_hidden=8,
                                           name="fc1"), act_type="relu")
        s2 = S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=3,
                                              name="fc2"), name="softmax")
        kw = {} if mod is jmx else {"context": CPU}
        seq = Seq()
        seq.add(M(s1, label_names=[], **kw))
        seq.add(M(s2, **kw), take_labels=True)
        seq.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))])
        seq.init_params()
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 1.0})
        mods.append(seq)
    jseq, tseq = mods
    for jm, tm in zip(jseq._modules, tseq._modules):
        _init_from(jm, tm)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    y = np.array([0, 1, 2, 0], np.float32)
    for _ in range(5):
        outs = []
        for mod, seq in ((jmx, jseq), (tmx, tseq)):
            outs.append(_np(seq.forward(_batch(mod, [x], [y]),
                                        is_train=True)[0]))
            seq.backward()
            seq.update()
        np.testing.assert_allclose(outs[1], outs[0], **TOL)
    ja, _ = jseq.get_params()
    ta, _ = tseq.get_params()
    for k in ja:
        np.testing.assert_allclose(_np(ta[k]), _np(ja[k]), err_msg=k,
                                   **TOL)


def test_group_outputs_preserved_with_bn():
    S = tmx.sym
    h = S.BatchNorm(S.var("data"), name="bn0")
    mod = TModule(S.Group([S.relu(h), S.tanh(h)]), label_names=[],
                  context=CPU)
    mod.bind(data_shapes=[("data", (4, 3))])
    mod.init_params()
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    outs = mod.forward(TBatch([tnd.array(x, ctx=CPU)], []), is_train=True)
    assert len(outs) == 2 and outs[0].shape == (4, 3)
    assert mod._arg_params["bn0_moving_mean"].shape == (3,)
    np.testing.assert_allclose(mod._arg_params["bn0_moving_mean"].asnumpy(),
                               0.1 * x.mean(0), rtol=1e-4, atol=1e-6)
    mod.backward([tnd.ones((4, 3), ctx=CPU), tnd.ones((4, 3), ctx=CPU)])


def _mlp_out(mod):
    S = mod.sym
    return S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=2,
                                            name="fc"), name="softmax")


def test_predict_score_pool_and_per_batch_match():
    """``predict`` through the pooled program and through the per-batch
    forward give the JAX package's rows (the padded last batch stripped);
    ``score`` and the composite metric's names match."""
    jmx = _jmx()
    rng = np.random.RandomState(0)
    X = rng.randn(10, 6).astype(np.float32)
    Y = (X[:, 0] > 0).astype(np.float32)
    jm, tm = _both(_mlp_out, [("data", (4, 6))], [("softmax_label", (4,))])
    jit = jmx.io.NDArrayIter(X, Y, batch_size=4, last_batch_handle="pad")
    with tmx.cpu():
        tit = tmx.io.NDArrayIter(X, Y, batch_size=4,
                                 last_batch_handle="pad")
    want = _np(jm.predict(jit))
    with tmx.cpu():
        got = tm.predict(tit)
        assert tm.predict_stats == {"pool": 3, "per_batch": 0}
        np.testing.assert_allclose(_np(got), want, **TOL)
        tm._pred_pool = (None, None)  # the per-batch route
        per = tm.predict(tit)
        assert tm.predict_stats["per_batch"] == 3
        np.testing.assert_allclose(_np(per), want, **TOL)
        tm._pred_pool = None
        pb = tm.predict(tit, merge_batches=False)
    assert len(pb) == 3 and pb[-1][0].shape == (2, 2)
    assert tm.data_names == ["data"] and tm.data_shapes[0].shape == (4, 6)
    assert dict(tm.output_shapes)[tm.output_names[0]] == (4, 2)
    for metric in ("accuracy", ["accuracy", "crossentropy"]):
        with tmx.cpu():
            jp, tp = jm.score(jit, metric), tm.score(tit, metric)
        assert [n for n, _ in tp] == [n for n, _ in jp]
        np.testing.assert_allclose([v for _, v in tp], [v for _, v in jp],
                                   **TOL)


def test_pooled_predict_keeps_the_graphs_dtype_on_the_device():
    """A bf16 graph's rows come out of the pool as the per-batch forward
    gives them: the same values, in bf16, where the module runs."""
    S = tmx.sym
    out = S.FullyConnected(S.Cast(S.var("data"), dtype="bfloat16"),
                           num_hidden=2, name="fc")
    tm = TModule(out, label_names=[], context=CPU)
    tm.bind([("data", (4, 3))])
    g = torch.Generator().manual_seed(0)
    tm.init_params(arg_params={
        "fc_weight": tnd.NDArray(torch.randn(2, 3, generator=g).bfloat16()),
        "fc_bias": tnd.NDArray(torch.randn(2, generator=g).bfloat16())})
    X = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, batch_size=4)
        pooled = tm.predict(it)
        assert tm.predict_stats == {"pool": 2, "per_batch": 0}
        tm._pred_pool = (None, None)  # the per-batch route
        per = tm.predict(it)
    assert pooled._data.dtype == per._data.dtype == torch.bfloat16
    assert pooled._data.device == per._data.device
    assert torch.equal(pooled._data, per._data)


def test_predict_of_a_drawing_graph_takes_the_per_batch_route():
    S = tmx.sym
    out = S.random_uniform(shape=(4, 2)) + S.FullyConnected(
        S.var("data"), num_hidden=2, name="fc")
    tm = TModule(out, label_names=[], context=CPU)
    tm.bind([("data", (4, 3))])
    tm.init_params()
    with tmx.cpu():
        it = tmx.io.NDArrayIter(np.ones((8, 3), np.float32), batch_size=4)
        assert tm.predict(it).shape == (8, 2)
    assert tm.predict_stats == {"pool": 0, "per_batch": 2}


# -------------------------------------------------------------- checkpoints

def _fc2(mod):
    S = mod.sym
    h = S.FullyConnected(S.var("data"), num_hidden=8, name="fc1")
    return S.FullyConnected(S.relu(S.BatchNorm(h, name="bn0")),
                            num_hidden=2, name="fc2")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_read_both_ways(tmp_path, writer):
    jmx = _jmx()
    jm, tm = _both(_fc2, [("data", (4, 5))], label_names=[])
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    for mod, m in ((jmx, jm), (tmx, tm)):
        m.forward(_batch(mod, [x], []), is_train=True)  # moving stats move
    ref = _np(tm.forward(_batch(tmx, [x], []), is_train=False)[0])
    prefix = str(tmp_path / "ck")
    (jm if writer == "jax" else tm).save_checkpoint(prefix, 7)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0007.params")
    _, args, aux = tmx.model.load_checkpoint(prefix, 7)
    assert "bn0_moving_mean" in aux and "fc1_weight" in args
    for loader, mod in ((TModule.load, tmx), (jmx.mod.Module.load, jmx)):
        kw = {"context": CPU} if mod is tmx else {}
        m2 = loader(prefix, 7, label_names=[], **kw)
        m2.bind(data_shapes=[("data", (4, 5))])
        m2.init_params()
        got = _np(m2.forward(_batch(mod, [x], []), is_train=False)[0])
        np.testing.assert_allclose(got, ref, **TOL)


def test_bf16_checkpoint_is_dtype_exact(tmp_path):
    import mxnet_tpu.model as jmodel

    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    prefix = str(tmp_path / "b")
    tmx.model.save_checkpoint(prefix, 1, tmx.sym.var("x") * 2.0,
                              {"w": tnd.NDArray(w)}, {"m": tnd.NDArray(w[0])})
    _, args, aux = tmx.model.load_checkpoint(prefix, 1)
    assert args["w"]._data.dtype == torch.bfloat16
    assert torch.equal(args["w"]._data, w) and torch.equal(aux["m"]._data,
                                                           w[0])
    _, jargs, _ = jmodel.load_checkpoint(prefix, 1)
    assert str(jargs["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(jargs["w"].asnumpy().astype(np.float32),
                                  w.float().numpy())


def test_set_params_rules():
    S = tmx.sym
    out = S.FullyConnected(S.var("data"), num_hidden=2, name="fc")
    m = TModule(out, label_names=[], context=CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.set_params({"fc_weight": np.ones((2, 3), np.float32)})
    assert any("before bind" in str(w.message) for w in caught)
    m = TModule(out, label_names=[], context=CPU)
    m.bind([("data", (4, 3))])
    m.init_params()
    x = tnd.array(np.ones((4, 3), np.float32), ctx=CPU)
    m.forward(TBatch([x], []), is_train=False)
    new = {"fc_weight": np.full((2, 3), 0.5, np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    m.set_params(new)
    np.testing.assert_allclose(
        m.forward(TBatch([x], []), is_train=False)[0].asnumpy(), 1.5)
    with pytest.raises(ValueError):
        m.set_params({"fc_weight": np.ones((3, 3), np.float32),
                      "fc_bias": np.zeros(2, np.float32)})
    with pytest.raises(ValueError):
        m.set_params(dict(new, typo=np.ones(1)))
    with pytest.raises(ValueError):
        m.set_params({"fc_weight": new["fc_weight"]})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.set_params({k: v * 0 for k, v in new.items()}, force_init=False)
    assert any("force_init=False" in str(w.message) for w in caught)
    np.testing.assert_allclose(m.get_params()[0]["fc_weight"].asnumpy(),
                               0.5)


def test_callback_module_checkpoint(tmp_path):
    S = tmx.sym
    m = TModule(S.FullyConnected(S.var("data"), num_hidden=2, name="fc"),
                label_names=[], context=CPU)
    m.bind([("data", (2, 3))])
    m.init_params()
    cb = tmx.callback.module_checkpoint(m, str(tmp_path / "e"), period=2)
    for epoch in range(4):
        cb(epoch)
    assert sorted(p for p in os.listdir(tmp_path) if p.endswith("params")) \
        == ["e-0002.params", "e-0004.params"]


# ---------------------------------------------------------------- bucketing

VOCAB, EMBED, NCLS = 20, 6, 4


def _sym_gen_for(mod):
    def gen(seq_len):
        S = mod.sym
        emb = S.Embedding(S.var("data"), S.var("embed_weight"),
                          input_dim=VOCAB, output_dim=EMBED)
        fc = S.FullyConnected(S.mean(emb, axis=1), S.var("fc_weight"),
                              S.var("fc_bias"), num_hidden=NCLS)
        return (S.SoftmaxOutput(fc, S.var("softmax_label")), ("data",),
                ("softmax_label",))

    return gen


def test_bucketing_matches_the_jax_module_and_a_numpy_oracle():
    """Interleaved steps over buckets 3, 5, 7 (test_bucketing's oracle
    case) in both packages: one executor a bucket, every bucket sharing
    the parameter and optimizer-state dicts; losses and weights equal."""
    jmx = _jmx()
    jb = jmx.mod.BucketingModule(_sym_gen_for(jmx), default_bucket_key=5)
    tb = TBucketing(_sym_gen_for(tmx), default_bucket_key=5, context=CPU)
    for m in (jb, tb):
        m.bind([("data", (8, 5))], [("softmax_label", (8,))])
        m.init_params()
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.5})
    _init_from(jb, tb)
    rng = np.random.RandomState(0)
    fixed = {k: (rng.randint(0, VOCAB, (8, k)).astype(np.float32),
                 rng.randint(0, NCLS, 8).astype(np.float32))
             for k in (3, 5, 7)}
    for it in range(9):
        k = (3, 5, 7)[it % 3]
        outs = []
        for mod, m in ((jmx, jb), (tmx, tb)):
            b = _batch(mod, [fixed[k][0]], [fixed[k][1]], key=k)
            outs.append(_np(m.forward(b, is_train=True)[0]))
            m.backward()
            m.update()
        np.testing.assert_allclose(outs[1], outs[0], **TOL)
    assert sorted(tb._buckets) == [3, 5, 7]
    mods = list(tb._buckets.values())
    assert all(m._arg_params is tb._arg_params for m in mods)
    assert all(m._opt_states is tb._opt_states for m in mods)
    for k, v in jb._arg_params.items():
        np.testing.assert_allclose(_np(tb._arg_params[k]), _np(v),
                                   err_msg=k, **TOL)
    # no batch key: the default bucket
    b = _batch(tmx, [fixed[5][0]], [fixed[5][1]])
    assert tb.forward(b, is_train=False)[0].shape == (8, NCLS)
    assert tb._curr_module is tb._buckets[5]


def _dropout_lstm(mod, T=5, N=3, H=8):
    """A 2-layer LSTM at dropout 0.5 traced with Symbols: only the RNN op's
    dropout between its layers draws."""
    S = mod.sym
    lstm = mod.gluon.rnn.LSTM(H, num_layers=2, dropout=0.5, input_size=4,
                              prefix="lstm_")
    out, _ = lstm(S.var("data", shape=(T, N, 4)),
                  [S.zeros((2, N, H)), S.zeros((2, N, H))])
    return out, lstm


def test_dropout_lstm_through_module_follows_is_train():
    """The LSTM layer leaves its op's training flag to the executor in a
    graph, as the JAX layer does: through ``Module`` an eval forward equals
    the JAX package's, and a training forward draws the dropout between
    the layers in both packages (again at each forward); the port's
    equals its own eager layer under ``record()`` from the same seed."""
    jmx = _jmx()
    x = np.random.RandomState(0).randn(5, 3, 4).astype(np.float32)
    jm, tm = _both(lambda mod: _dropout_lstm(mod)[0], [("data", x.shape)],
                   label_names=[])
    got = {}
    for mod, m in ((jmx, jm), (tmx, tm)):
        b = _batch(mod, [x])
        with (tmx.cpu() if mod is tmx else warnings.catch_warnings()):
            ev = _np(m.forward(b, is_train=False)[0])
            tr = [_np(m.forward(b, is_train=True)[0]) for _ in range(2)]
            ev2 = _np(m.forward(b, is_train=False)[0])
        np.testing.assert_array_equal(ev2, ev)
        assert not np.allclose(tr[0], ev) and not np.allclose(tr[1], tr[0])
        got[mod] = ev
    np.testing.assert_allclose(got[tmx], got[jmx], **TOL)
    _, lstm = _dropout_lstm(tmx)
    lstm.initialize(device="cpu")
    for p in lstm.collect_params().values():
        p.set_data(tm._arg_params[p.name]._data)
    xt = torch.from_numpy(x)
    zeros = torch.zeros(2, 3, 8)
    with tmx.cpu():
        tmx.random.seed(7)
        with tmx.autograd.record():
            ref = lstm(xt, [zeros, zeros])[0].detach().numpy()
        tmx.random.seed(7)
        tr = _np(tm.forward(_batch(tmx, [x]), is_train=True)[0])
        with tmx.autograd.record(train_mode=False):
            ev = lstm(xt, [zeros, zeros])[0].detach().numpy()
    np.testing.assert_array_equal(tr, ref)
    np.testing.assert_allclose(ev, got[tmx], **TOL)


def test_dropout_cell_graph_follows_is_train():
    """``DropoutCell`` traced with Symbols: the identity in an eval
    forward and a fresh mask in each training forward, in both
    packages."""
    x = np.ones((4, 64), np.float32)
    for mod in (_jmx(), tmx):
        cell = mod.gluon.rnn.DropoutCell(0.5)
        out, _ = cell(mod.sym.var("data"), [])
        ex = out.bind(CPU if mod is tmx else mod.cpu(),
                      {"data": _arr(mod, x)})
        with (tmx.cpu() if mod is tmx else warnings.catch_warnings()):
            ev = _np(ex.forward(is_train=False)[0])
            tr = [_np(ex.forward(is_train=True)[0]) for _ in range(2)]
        np.testing.assert_array_equal(ev, x)
        assert set(np.unique(tr[0])) == {0.0, 2.0}
        assert not np.array_equal(tr[0], tr[1])


# ----------------------------------------------------- GPT loss through fit

def _gpt_loss(S, symbol_mod, sym_file):
    logits = symbol_mod.load(sym_file)
    return S.MakeLoss(S.mean(S.softmax_xent_rows(logits, S.var("label"))))


def test_gpt_loss_symbol_through_fit_matches(tmp_path):
    """A 2-layer GPT exported at (4, 16), its loss ``MakeLoss(mean(
    softmax_xent_rows))`` through ``Module.fit`` over a PrefetchingIter of
    an NDArrayIter (three batches, SGD) in both packages: the fit's loss
    metric and every parameter after the three steps."""
    import mxnet_tpu as jmx
    import mxnet_tpu.symbol as jsymbol
    from mxnet_tpu_torch import checkpoint, symbol as tsymbol
    from mxnet_tpu_torch.util import load_npz_exact
    from torch_port_helpers import jax_gpt, port_gpt_from

    B, T = 4, 16
    port = port_gpt_from(jax_gpt())
    sym_file, params_file = checkpoint.save_for_serving(
        str(tmp_path / "gpt"), port, input_shapes=[(B, T)])
    weights = {k: v.numpy() for k, v in load_npz_exact(params_file).items()}
    rng = np.random.RandomState(0)
    seq = rng.randint(0, SMALL_GPT["vocab_size"], (3 * B, T + 1))
    X, Y = seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
    results = []
    for mod, symbol_mod in ((jmx, jsymbol), (tmx, tsymbol)):
        loss = _gpt_loss(mod.sym, symbol_mod, sym_file)
        kw = {"context": CPU} if mod is tmx else {}
        m = mod.mod.Module(loss, data_names=("data",),
                           label_names=("label",), **kw)
        with (CPU if mod is tmx else _NullCtx()):
            it = mod.io.PrefetchingIter(mod.io.NDArrayIter(
                X, Y, batch_size=B, label_name="label"))
        m.bind([("data", (B, T))], [("label", (B, T))])
        m.init_params(arg_params={k: _arr(mod, v) for k, v in
                                  weights.items()})
        seen = []
        got = m.fit(it, eval_metric="loss", optimizer="sgd",
                    optimizer_params={"learning_rate": 0.5},
                    batch_end_callback=lambda p: seen.append(p),
                    eval_data=object())
        assert seen == []  # accepted and unused, in both packages
        results.append((got, {k: _np(v) for k, v in
                              m.get_params()[0].items()}))
    (jname, jloss), jparams = results[0]
    (tname, tloss), tparams = results[1]
    assert tname == jname == "loss"
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    moved = 0
    for k, v in jparams.items():
        np.testing.assert_allclose(tparams[k], v, err_msg=k, rtol=1e-4,
                                   atol=1e-5)
        moved += not np.array_equal(v, weights[k])
    assert moved > len(jparams) // 2


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
