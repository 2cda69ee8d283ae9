"""Sparse storage of the port (``mxnet_tpu_torch/sparse.py`` and what it
wires: ``Optimizer._update_rsp``, the Trainer's row-sparse route,
``Embedding(sparse_grad=True)``, ``KVStore.row_sparse_pull``,
``NDArray.tostype``, ``nd.cast_storage``, ``io.LibSVMIter``) against the
JAX package's on the same seeded numpy inputs, on the CPU.

Tolerances: storage fields (data, indices, indptr) and the conversions
are exact; ``dot`` and its gradients are held within fp32 1e-5 relative,
1e-6 absolute (the gather-and-sum runs in another order than XLA's
segment sum); the lazy updates within 1e-6 relative and 1e-7 absolute on
the touched rows (one fp32 step's rounding), and bit for bit on every row
the gradient did not touch.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu import sparse as jsparse
from torch_port_helpers import jax_params, jax_trace_state_module  # noqa: F401

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import sparse as tsparse

pytestmark = pytest.mark.usefixtures("jax_trace_state_module")

DOT_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-6, atol=1e-7)


def _dense(rng, shape, density=0.3):
    a = rng.standard_normal(shape).astype(np.float32)
    a[rng.random(shape) > density] = 0.0
    return a


def _fields(arr):
    names = ("data", "indices", "indptr") if arr.stype == "csr" else \
        ("data", "indices")
    return {n: getattr(arr, n).asnumpy() for n in names}


def _assert_same_sparse(t, j):
    assert t.stype == j.stype and t.shape == j.shape
    tf, jf = _fields(t), _fields(j)
    for n in tf:
        np.testing.assert_array_equal(tf[n], jf[n], err_msg=n)
        assert tf[n].dtype == jf[n].dtype, n
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_constructors_and_cast_storage_match_jax():
    rng = np.random.default_rng(0)
    a = _dense(rng, (6, 5))
    a[2] = 0.0
    with tmx.cpu():
        for stype in ("csr", "row_sparse"):
            _assert_same_sparse(tnd.cast_storage(tnd.array(a), stype),
                                jnd.cast_storage(jnd.array(a), stype))
            _assert_same_sparse(tnd.array(a).tostype(stype),
                                jsparse.cast_storage(jnd.array(a), stype))
            back = tnd.cast_storage(tnd.cast_storage(tnd.array(a), stype),
                                    "default")
            np.testing.assert_array_equal(back.asnumpy(), a)
            z_t, z_j = tsparse.zeros(stype, (4, 3)), jsparse.zeros(stype,
                                                                   (4, 3))
            _assert_same_sparse(z_t, z_j)
        _assert_same_sparse(tsparse.csr_matrix(a), jsparse.csr_matrix(a))
        _assert_same_sparse(tsparse.row_sparse_array(a),
                            jsparse.row_sparse_array(a))
        # the tuple forms, and array() keeping the storage type
        csr = tsparse.csr_matrix(([1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 2, 3]),
                                 shape=(3, 4))
        jcsr = jsparse.csr_matrix(([1.0, 2.0, 3.0], [0, 2, 1], [0, 2, 2, 3]),
                                  shape=(3, 4))
        _assert_same_sparse(csr, jcsr)
        _assert_same_sparse(tsparse.array(csr), jsparse.array(jcsr))
        rsp = tsparse.row_sparse_array((a[[1, 4]], [1, 4]), shape=a.shape)
        jrsp = jsparse.row_sparse_array((a[[1, 4]], [1, 4]), shape=a.shape)
        _assert_same_sparse(rsp, jrsp)
        np.testing.assert_array_equal(rsp.astype("float16").asnumpy(),
                                      a.astype(np.float16) * (
                                          np.arange(6) % 3 == 1)[:, None])
        assert tnd.array(a).tostype("default").shape == a.shape
        with pytest.raises(ValueError):
            tsparse.zeros("csr", (2, 3, 4))


def test_csr_slicing_and_copyto_match_scipy():
    rng = np.random.default_rng(1)
    a = _dense(rng, (7, 6))
    ref = sp.csr_matrix(a)
    with tmx.cpu():
        csr = tsparse.csr_matrix(a)
        for key in (slice(1, 5), slice(0, 7), 3, -1, slice(4, 4)):
            got = csr[key]
            want = ref[key] if not isinstance(key, int) else ref[key % 7]
            np.testing.assert_array_equal(got.asnumpy(), want.toarray())
            np.testing.assert_array_equal(got.indptr.asnumpy(), want.indptr)
        with pytest.raises(ValueError):
            csr[::2]
        with pytest.raises(IndexError):
            csr[7]
        out = tnd.zeros((7, 6))
        csr.copyto(out)
        np.testing.assert_array_equal(out.asnumpy(), a)
        other = tsparse.zeros("csr", (7, 6))
        csr.copyto(other)
        np.testing.assert_array_equal(other.asnumpy(), a)


def test_retain_elemwise_and_add_n_match_jax():
    rng = np.random.default_rng(2)
    a, b = _dense(rng, (8, 3), 0.4), _dense(rng, (8, 3), 0.4)
    with tmx.cpu():
        ta, tb = tsparse.row_sparse_array(a), tsparse.row_sparse_array(b)
        ja, jb = jsparse.row_sparse_array(a), jsparse.row_sparse_array(b)
        _assert_same_sparse(tsparse.retain(ta, [0, 3, 5, 7]),
                            jsparse.retain(ja, [0, 3, 5, 7]))
        _assert_same_sparse(ta.retain(tnd.array([1, 2])),
                            ja.retain(jnd.array([1, 2])))
        for op in ("add", "subtract", "multiply"):
            _assert_same_sparse(getattr(tsparse, op)(ta, tb),
                                getattr(jsparse, op)(ja, jb))
        _assert_same_sparse(tsparse.add_n(ta, tb, ta),
                            jsparse.add_n([ja, jb, ja]))
        dense = tsparse.elemwise_add(ta, tnd.array(b))
        np.testing.assert_allclose(dense.asnumpy(), a + b, rtol=1e-6)
        with pytest.raises(TypeError):
            tsparse.retain(tnd.array(a), [0])


@pytest.mark.parametrize("transpose_a,vector", [(False, False),
                                                 (True, False),
                                                 (False, True)])
def test_csr_dot_and_its_gradients_match_jax(transpose_a, vector):
    rng = np.random.default_rng(3)
    a = _dense(rng, (6, 9), 0.35)
    k = (6 if transpose_a else 9,) + (() if vector else (4,))
    rhs = rng.standard_normal(k).astype(np.float32)
    dy = rng.standard_normal(((9 if transpose_a else 6),)
                             + (() if vector else (4,))).astype(np.float32)
    with tmx.cpu():
        tcsr = tsparse.csr_matrix(a)
        tr = tnd.array(rhs)
        tcsr.data.attach_grad()
        tr.attach_grad()
        with tautograd.record():
            out = tsparse.dot(tcsr, tr, transpose_a=transpose_a)
        out.backward(tnd.array(dy))
    jcsr = jsparse.csr_matrix(a)
    jr = jnd.array(rhs)
    jcsr.data.attach_grad()
    jr.attach_grad()
    with jautograd.record():
        jout = jsparse.dot(jcsr, jr, transpose_a=transpose_a)
    jout.backward(jnd.array(dy))
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **DOT_TOL)
    oracle = (sp.csr_matrix(a).T if transpose_a else sp.csr_matrix(a)) @ rhs
    np.testing.assert_allclose(out.asnumpy(), oracle, **DOT_TOL)
    np.testing.assert_allclose(tcsr.data.grad.asnumpy(),
                               jcsr.data.grad.asnumpy(), **DOT_TOL)
    np.testing.assert_allclose(tr.grad.asnumpy(), jr.grad.asnumpy(),
                               **DOT_TOL)


def test_dot_densifies_other_sparse_operands():
    rng = np.random.default_rng(4)
    a, b = _dense(rng, (5, 4)), rng.standard_normal((4, 3)).astype(
        np.float32)
    with tmx.cpu():
        got = tsparse.dot(tsparse.row_sparse_array(a), tnd.array(b))
        got_t = tsparse.dot(tsparse.csr_matrix(a), tnd.array(b.T),
                            transpose_b=True)
    np.testing.assert_allclose(got.asnumpy(), a @ b, **DOT_TOL)
    np.testing.assert_allclose(got_t.asnumpy(), a @ b, **DOT_TOL)


def test_dense_to_row_sparse_padded_matches_jax():
    rng = np.random.default_rng(5)
    for rows in ([1, 2, 6], [0], [], list(range(10))):
        a = np.zeros((10, 3), np.float32)
        a[rows] = rng.standard_normal((len(rows), 3))
        with tmx.cpu():
            got = tsparse.dense_to_row_sparse_padded(tnd.array(a))
            exact = tsparse.dense_to_row_sparse(tnd.array(a))
        want = jsparse.dense_to_row_sparse_padded(jnd.array(a))
        _assert_same_sparse(got, want)
        np.testing.assert_array_equal(exact.indices.asnumpy(), rows)
        np.testing.assert_array_equal(exact.asnumpy(), a)


@pytest.fixture(scope="module")
def lazy_case():
    """A weight (12, 3), two row-sparse gradients (one padded as the JAX
    Trainer carries it) and each optimizer's JAX run of two lazy
    updates."""
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((12, 3)).astype(np.float32)
    g1 = np.zeros_like(w0)
    g1[[1, 5, 7]] = rng.standard_normal((3, 3))
    g2 = np.zeros_like(w0)
    g2[[5, 9]] = rng.standard_normal((2, 3))
    runs = {}
    for name, kw in OPTS.items():
        opt = jmx.optimizer.create(name, **kw)
        w = jnd.array(w0)
        state = opt.create_state(0, w)
        for g in (g1, g2):
            state = opt.update(0, w, jsparse.dense_to_row_sparse_padded(
                jnd.array(g)), state)
        runs[name] = (w.asnumpy(), [np.asarray(s) for s in
                                    jmx_leaves(state)])
    return w0, (g1, g2), runs


def jmx_leaves(state):
    import jax

    return jax.tree_util.tree_leaves(state)


OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
        "adam": {"learning_rate": 0.01, "wd": 0.01}}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_lazy_update_matches_jax(lazy_case, name):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.util import tree_leaves

    w0, grads, runs = lazy_case
    jw, jstate = runs[name]
    opt = topt.create(name, **OPTS[name])
    with tmx.cpu():
        w = tnd.array(w0)
        state = opt.create_state(0, w._data)
        for g in grads:
            state = opt.update(0, w, tsparse.dense_to_row_sparse_padded(
                tnd.array(g)), state)
    touched = sorted({1, 5, 7, 9})
    untouched = [r for r in range(12) if r not in touched]
    got = w.asnumpy()
    np.testing.assert_array_equal(got[untouched], w0[untouched])
    np.testing.assert_array_equal(got[untouched], jw[untouched])
    np.testing.assert_allclose(got[touched], jw[touched], **STEP_TOL)
    leaves = [t.numpy() for t in tree_leaves(state)]
    assert len(leaves) == len(jstate)
    for t, j in zip(leaves, jstate):
        np.testing.assert_array_equal(t[untouched], j[untouched])
        np.testing.assert_allclose(t[touched], j[touched], **STEP_TOL)


def test_lazy_update_off_densifies():
    from mxnet_tpu_torch import optimizer as topt

    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((6, 2)).astype(np.float32)
    g = np.zeros_like(w0)
    g[2] = 1.0
    with tmx.cpu():
        for lazy in (True, False):
            opt = topt.SGD(learning_rate=0.1, momentum=0.9, wd=0.1,
                           lazy_update=lazy)
            w = tnd.array(w0)
            opt.update(0, w, tsparse.row_sparse_array(g),
                       opt.create_state(0, w._data))
            dense = w0 - 0.1 * (g + 0.1 * w0)
            rows = [2] if lazy else list(range(6))
            np.testing.assert_allclose(w.asnumpy()[rows], dense[rows],
                                       rtol=1e-6)
            if lazy:  # the decay reached only the touched row
                np.testing.assert_array_equal(w.asnumpy()[[0, 1, 3]],
                                              w0[[0, 1, 3]])


def _emb_nets(sparse_cls):
    """The JAX and port nets: an embedding (20, 4) with a row-sparse
    gradient, then Dense(3); the port's weights carried from the JAX
    net's."""
    from mxnet_tpu.gluon import nn as jnn

    from mxnet_tpu_torch.convert import carry_params
    from mxnet_tpu_torch.gluon import nn as tnn

    def build(nn, contrib):
        net = nn.HybridSequential()
        emb = (contrib.SparseEmbedding(20, 4) if sparse_cls
               else nn.Embedding(20, 4, sparse_grad=True))
        net.add(emb, nn.Dense(3, flatten=False))
        return net

    from mxnet_tpu.gluon.contrib import nn as jcontrib
    from mxnet_tpu_torch.gluon.contrib import nn as tcontrib

    jnet = build(jnn, jcontrib)
    jnet.initialize(jmx.init.Normal(0.5))
    jnet(jnd.array(np.zeros((1, 2), np.int32)))
    with tmx.cpu():
        tnet = build(tnn, tcontrib)
        tnet.initialize()
        tnet(tnd.array(np.zeros((1, 2), np.int32)))
        carry_params(tnet, jax_params(jnet))
    return jnet, tnet


@pytest.mark.parametrize("sparse_cls", [False, True],
                         ids=["Embedding_sparse_grad", "SparseEmbedding"])
def test_embedding_sparse_grad_through_trainer_matches_jax(sparse_cls):
    from mxnet_tpu import gluon as jgluon

    from mxnet_tpu_torch import gluon as tgluon

    rng = np.random.default_rng(8)
    jnet, tnet = _emb_nets(sparse_cls)
    emb_t = [p for p in tnet.collect_params().values()
             if p.name.endswith("weight") and p.shape == (20, 4)][0]
    assert emb_t._grad_stype == "row_sparse"
    w0 = emb_t._tensor().detach().clone().numpy()
    kw = {"learning_rate": 0.5, "momentum": 0.9}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(kw))
    seen = []
    with tmx.cpu():
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd", dict(kw))
        real = ttr._optimizer._update_rsp

        def spy(index, weight, grad, state):
            seen.append(grad)
            return real(index, weight, grad, state)

        ttr._optimizer._update_rsp = spy
        ids = [rng.integers(0, 8, (4, 3)) for _ in range(2)]
        for x in ids:
            lab = rng.standard_normal((4, 3, 3)).astype(np.float32)
            with jautograd.record():
                jl = ((jnet(jnd.array(x, dtype="int32"))
                       - jnd.array(lab)) ** 2).sum()
            jl.backward()
            jtr.step(4)
            with tautograd.record():
                tl = ((tnet(tnd.array(x, dtype="int32"))
                       - tnd.array(lab)) ** 2).sum()
            tl.backward()
            ttr.step(4)
            np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(),
                                       rtol=1e-5)
    assert len(seen) == 2
    for g, x in zip(seen, ids):
        assert g.stype == "row_sparse"
        np.testing.assert_array_equal(g.indices.asnumpy(), np.unique(x))
    # in collect_params() order: the two packages' automatic block names
    # count on in each process
    for p, j in zip(tnet.collect_params().values(),
                    jnet.collect_params().values()):
        np.testing.assert_allclose(p._tensor().detach().numpy(),
                                   j.data().asnumpy(), rtol=1e-5, atol=1e-6)
    untouched = sorted(set(range(20)) - set(np.unique(np.concatenate(
        [x.ravel() for x in ids]))))
    np.testing.assert_array_equal(emb_t._tensor().detach().numpy()[untouched],
                                  w0[untouched])


def test_row_sparse_under_weight_update_sharding_refuses():
    from mxnet_tpu_torch import gluon as tgluon

    _, tnet = _emb_nets(False)
    with tmx.cpu():
        ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                             {"learning_rate": 0.1})
        ttr._layout_fn = lambda: (lambda i: None)
        with tautograd.record():
            tl = tnet(tnd.array(np.ones((2, 2), np.int32))).sum()
        tl.backward()
        with pytest.raises(ValueError, match="row-sparse"):
            ttr.step(2)


def test_row_sparse_pull_matches_jax():
    rng = np.random.default_rng(9)
    v = rng.standard_normal((7, 3)).astype(np.float32)
    jkv = jmx.kvstore.create("local")
    jkv.init("w", jnd.array(v))
    jout = jnd.zeros((7, 3))
    jkv.row_sparse_pull("w", out=jout, row_ids=jnd.array([1, 4, 4, 6]))
    with tmx.cpu():
        tkv = tmx.kvstore.create("local")
        tkv.init("w", tnd.array(v))
        tout = tnd.zeros((7, 3))
        tkv.row_sparse_pull("w", out=tout, row_ids=tnd.array([1, 4, 4, 6]))
        outs = [tnd.zeros((7, 3)), tnd.zeros((7, 3))]
        tkv.init("u", tnd.array(2 * v))
        tkv.row_sparse_pull(["w", "u"], out=outs, row_ids=tnd.array([0]))
        with pytest.raises(ValueError):
            tkv.row_sparse_pull("w", out=tout)
        with pytest.raises(ValueError, match="outside"):
            tkv.row_sparse_pull("w", out=tnd.zeros((7, 3)),
                                row_ids=tnd.array([7]))
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(outs[1].asnumpy()[0], 2 * v[0])
    assert not outs[1].asnumpy()[1:].any()


def test_libsvm_iter_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    path = tmp_path / "data.libsvm"
    with open(path, "w") as f:
        for _ in range(10):
            cols = np.sort(rng.choice(50, rng.integers(1, 6), replace=False))
            f.write("%d %s\n" % (rng.integers(0, 2), " ".join(
                "%d:%.4f" % (c, rng.standard_normal()) for c in cols)))
        f.write("\n")
    jit = jmx.io.LibSVMIter(str(path), (50,), batch_size=4)
    jb = list(jit)
    with tmx.cpu():
        tit = tmx.io.LibSVMIter(str(path), (50,), batch_size=4)
        tb = list(tit)
        tit.reset()
        again = next(tit)
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        _assert_same_sparse(t.data[0], j.data[0])
        np.testing.assert_array_equal(t.label[0].asnumpy(),
                                      j.label[0].asnumpy())
    np.testing.assert_array_equal(again.data[0].asnumpy(),
                                  tb[0].data[0].asnumpy())
    bad = tmp_path / "bad.libsvm"
    bad.write_text("1 0:1.0 3:2.0\n0 50:1.0\n")
    with pytest.raises(ValueError, match="bad.libsvm:2"):
        tmx.io.LibSVMIter(str(bad), (50,), batch_size=1)


def test_storage_type_checks():
    from mxnet_tpu_torch.gluon.parameter import Parameter
    from mxnet_tpu_torch.ops.legacy_ops import cast_storage

    assert Parameter("p", grad_stype="row_sparse")._grad_stype == \
        "row_sparse"
    with pytest.raises(ValueError):
        Parameter("p", stype="dense")
    with pytest.raises(ValueError, match="dense-only"):
        cast_storage(torch.zeros(2, 2), stype="csr")
    assert cast_storage(torch.ones(2), stype="default").sum() == 2
