"""The port's fifteen optimizers against the JAX package's on the CPU: the
same seeded weights and gradients through K steps of ``fused_update`` and
of the per-index ``update``, fp32 and bf16 with fp32 masters, under weight
decay, gradient clipping, a gradient rescale and per-parameter lr/wd
multipliers. Weights (fp32 or the masters) and every state leaf agree
within 1e-5 relative (``_foreach`` ops and XLA round and associate
differently in the last bits; LAMB's and LARS's norms sum in another
order); a bf16 weight within one bf16 step (2^-7 relative) of the JAX
one, since a master a few fp32 ulps away may round the other way. SGLD is
held by its deterministic part (its noise drawn as zeros in both packages)
and by its noise's mean and standard deviation. Then ``Updater``, the
trainer's ``ignore_stale_grad``, ``lr_scheduler`` and
``tree_optimizer_step``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import tree_optimizer_step as jtree_step
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.util import tree_leaves
from mxnet_tpu_torch.parallel import tree_optimizer_step
from torch_port_helpers import (OPTIMIZER_KW, jax_trace_state,  # noqa: F401
                                sgld_without_noise)

OPTIMIZERS = OPTIMIZER_KW
SETTINGS = {
    "wd": dict(wd=0.01),
    "clip": dict(clip_gradient=0.5, wd=0.001),
    "rescale": dict(rescale_grad=0.125),
    "mult": dict(wd=0.01),  # and lr_mult/wd_mult on two parameters
}
SHAPES = ((4, 5), (5,), (3, 2))
K = 3
RTOL = 1e-5


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _make(name, setting, bf16):
    kw = dict(OPTIMIZERS[name], **SETTINGS[setting], multi_precision=bf16)
    j, t = jopt.create(name, **kw), topt.create(name, **kw)
    if setting == "mult":
        for o in (j, t):
            o.set_lr_mult({0: 0.5})
            o.set_wd_mult({2: 0.0})
    return j, t


def _close(got, want, what, rtol=RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max() + 1e-30),
                               err_msg=what)


def _compare(jws, jstates, tws, tstates, bf16):
    for i, (jw, tw) in enumerate(zip(jws, tws)):
        _close(tw, jw._data, "weight %d" % i, 2.0 ** -7 if bf16 else RTOL)
    jleaves = jax.tree_util.tree_leaves(list(jstates))
    tleaves = [x for s in tstates for x in tree_leaves(s)]
    assert len(jleaves) == len(tleaves)
    for k, (a, b) in enumerate(zip(tleaves, jleaves)):
        if b.dtype == jnp.uint32:  # SGLD's pseudo-state
            assert a.dtype == torch.uint32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, "state leaf %d" % k)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_mp"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name, bf16, setting, jax_trace_state,  # noqa: F811
                                   sgld_without_noise):
    """K steps of ``fused_update``, then K of the per-index ``update`` on
    fresh states, each against the JAX package's."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    for fused in (True, False):
        jo, to = _make(name, setting, bf16)
        w0 = _arrays(0)
        jws = [NDArray(jnp.asarray(w, jdt)) for w in w0]
        tws = [torch.tensor(w).to(tdt) for w in w0]
        # distinct buffers: FTML's fresh state is one zeros array three
        # times, and fp32 DCASGD's holds the weight itself, which the JAX
        # package's fused_update would donate twice
        jst = jax.tree_util.tree_map(
            lambda a: jnp.array(a, copy=True),
            [jo.create_state(i, w) for i, w in enumerate(jws)])
        tst = [to.create_state(i, w) for i, w in enumerate(tws)]
        for step in range(K):
            gs = _arrays(10 + step)
            jgs = [jnp.asarray(g, jdt) for g in gs]
            tgs = [torch.tensor(g).to(tdt) for g in gs]
            if fused:
                jst = jo.fused_update(jws, jgs, jst)
                tst = to.fused_update(tws, tgs, tst)
            else:
                jst = [jo.update(i, w, g, s) for i, (w, g, s)
                       in enumerate(zip(jws, jgs, jst))]
                tst = [to.update(i, w, g, s) for i, (w, g, s)
                       in enumerate(zip(tws, tgs, tst))]
        assert to.num_update == jo.num_update == K
        _compare(jws, jst, tws, tst, bf16)


def test_sgld_noise_moments_match_jax(jax_trace_state):  # noqa: F811
    """With a zero gradient an SGLD step adds N(0, lr): in both packages
    the added noise has mean 0 (within 5 standard errors) and standard
    deviation sqrt(lr) (within 3%)."""
    lr, n = 0.04, 40000
    w = np.zeros((n,), np.float32)
    jw = NDArray(jnp.asarray(w))
    jopt.SGLD(learning_rate=lr).update(0, jw, jnp.zeros(n, jnp.float32), ())
    tw = torch.tensor(w)
    to = topt.SGLD(learning_rate=lr)
    to.update(0, tw, torch.zeros(n), to.create_state(0, tw))
    for noise in (np.asarray(jw._data), tw.numpy()):
        assert abs(noise.mean()) < 5 * np.sqrt(lr / n)
        assert abs(noise.std() / np.sqrt(lr) - 1) < 0.03


def test_row_sparse_gradient_raises_naming_sparse():
    """A sparse gradient takes the lazy row update (sparse storage is
    ported): the rows it holds are stepped, the others keep their weight
    and momentum (tests/test_torch_port_sparse.py holds it to the JAX
    package's)."""
    o = topt.SGD(momentum=0.9, learning_rate=0.5)
    w = torch.ones(4, 3)
    g = torch.eye(4, 3).to_sparse()
    state = o.update(0, w, g, o.create_state(0, w))
    np.testing.assert_allclose(w[:3].numpy(), 1.0 - 0.5 * np.eye(3))
    np.testing.assert_array_equal(w[3].numpy(), [1.0, 1.0, 1.0])
    assert not state[3].any()


@pytest.mark.parametrize("name", ["sgd", "lamb", "adam"])
def test_updater_batch_call_matches_per_key_calls(name,  # noqa: F811
                                                  jax_trace_state):
    """``Updater.batch_call`` (one multi-tensor step over the keys) equals
    the per-key ``Updater`` calls, and the JAX package's batch call."""
    kw = OPTIMIZERS[name]
    keys = [3, 7, 9]
    one, batch = (topt.get_updater(topt.create(name, **kw))
                  for _ in range(2))
    jup = jopt.get_updater(jopt.create(name, **kw))
    w1 = [torch.tensor(w) for w in _arrays(0)]
    w2 = [torch.tensor(w) for w in _arrays(0)]
    jw = [NDArray(jnp.asarray(w)) for w in _arrays(0)]
    for step in range(K):
        gs = _arrays(20 + step)
        for k, w, g in zip(keys, w1, gs):
            one(k, torch.tensor(g), w)
        batch.batch_call(keys, [torch.tensor(g) for g in gs], w2)
        jup.batch_call(keys, [jnp.asarray(g) for g in gs], jw)
    for a, b, c in zip(w1, w2, jw):
        _close(b, a.numpy(), "batch against per key")
        _close(b, c._data, "batch against JAX")
    assert sorted(batch.states) == keys
    assert batch.optimizer._index_update_count == {k: K for k in keys}


# ------------------------------------------------------------ trainer


def _nets():
    """A two-layer MLP in each package with the same weights."""
    jnet = jgluon.nn.HybridSequential()
    tnet = gluon.nn.HybridSequential()
    for net, nn in ((jnet, jgluon.nn), (tnet, gluon.nn)):
        with net.name_scope():
            net.add(nn.Dense(5, in_units=4, activation="tanh"),
                    nn.Dense(3, in_units=5))
    jnet.initialize()
    tnet.initialize(device="cpu")
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        tp.set_data(torch.tensor(np.asarray(jp.data()._data)))
    return jnet, tnet


def _loss_and_grads(jnet, tnet, seed):
    x = np.random.RandomState(seed).randn(6, 4).astype(np.float32)
    with jag.record():
        jl = (jnet(mx.nd.array(x)) ** 2).sum()
    jag.backward(jl)
    with autograd.record():
        tl = (tnet(torch.from_numpy(x)) ** 2).sum()
    autograd.backward(tl)


def _assert_same_weights(jnet, tnet):
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        _close(tp._tensor(), jp.data()._data, tp.name)


@pytest.mark.parametrize("ignore", [False, True])
def test_trainer_stale_gradient_matches_jax(ignore,  # noqa: F811
                                            jax_trace_state):
    """A parameter without a gradient: ``RuntimeError`` naming it in both
    packages, or, with ``ignore_stale_grad``, the others stepped and it
    left as it was."""
    jnet, tnet = _nets()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         dict(OPTIMIZERS["sgd"]))
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        dict(OPTIMIZERS["sgd"]))
    _loss_and_grads(jnet, tnet, 0)
    jstale = list(jnet.collect_params().values())[1]
    tstale = list(tnet.collect_params().values())[1]
    jstale.data()._grad = None
    tstale._tensor().grad = None
    before = tstale._tensor().clone()
    if not ignore:
        for tr, stale in ((jtr, jstale), (ttr, tstale)):
            with pytest.raises(RuntimeError, match="gradient of %s not "
                               "attached" % stale.name):
                tr.step(6)
        return
    jtr.step(6, ignore_stale_grad=True)
    ttr.step(6, ignore_stale_grad=True)
    assert torch.equal(tstale._tensor(), before)
    _assert_same_weights(jnet, tnet)
    assert sorted(ttr._states) == sorted(jtr._states) == [0, 2, 3]


def test_trainer_lr_scheduler_matches_jax(jax_trace_state):  # noqa: F811
    """``optimizer_params`` with an ``lr_scheduler``: the trainer's rate at
    each step is the scheduler's at the update count, and K steps land on
    the JAX trainer's weights."""
    jnet, tnet = _nets()
    kw = dict(warmup_steps=2, warmup_begin_lr=0.0, base_lr=0.1)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(
        momentum=0.9, lr_scheduler=jlrs.CosineScheduler(10, **kw)))
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(
        momentum=0.9, lr_scheduler=tlrs.CosineScheduler(10, **kw)))
    sched = tlrs.CosineScheduler(10, **kw)
    for step in range(4):
        assert ttr.learning_rate == jtr.learning_rate == sched(step)
        _loss_and_grads(jnet, tnet, step)
        jtr.step(6)
        ttr.step(6)
    _assert_same_weights(jnet, tnet)


@pytest.mark.parametrize("name", ["adam", "lamb", "sgd"])
def test_tree_optimizer_step_matches_the_per_parameter_step(
        name, jax_trace_state):  # noqa: F811
    """``tree_optimizer_step`` over a dict of (list of) tensors equals
    ``fused_update`` with the same rate, decay and count, and the JAX
    package's ``apply`` on the same tree."""
    kw = dict(OPTIMIZERS[name], wd=0.01)
    a, b, c = _arrays(0)
    tree = {"b": [torch.tensor(a), torch.tensor(b)], "a": torch.tensor(c)}
    grads = {"b": [torch.tensor(g) for g in _arrays(5)[:2]],
             "a": torch.tensor(_arrays(5)[2])}
    init, apply = tree_optimizer_step(topt.create(name, **kw))
    states = init(tree)
    for t in (1, 2):
        tree, states = apply(tree, grads, states, 0.05, 0.01, t)
    # the same step per parameter (order: "a", then "b"'s items)
    ref = topt.create(name, **kw)
    ws = [torch.tensor(c), torch.tensor(a), torch.tensor(b)]
    gs = [grads["a"]] + grads["b"]
    ss = [ref.create_state(0, w) for w in ws]
    for t in (1, 2):
        ref._apply(ws, gs, ss, [0.05] * 3, [0.01] * 3, [t] * 3)
    for got, want in zip([tree["a"]] + tree["b"], ws):
        assert torch.equal(got, want)
    jinit, japply = jtree_step(jopt.create(name, **kw))
    jtree = {"b": [jnp.asarray(a), jnp.asarray(b)], "a": jnp.asarray(c)}
    jgrads = jax.tree_util.tree_map(lambda g: jnp.asarray(g.numpy()), grads)
    jstates = jinit(jtree)
    for t in (1, 2):
        jtree, jstates = japply(jtree, jgrads, jstates, jnp.float32(0.05),
                                jnp.float32(0.01), jnp.int32(t))
    for got, want in zip([tree["a"]] + tree["b"],
                         [jtree["a"]] + jtree["b"]):
        _close(got, want, "tree step against JAX")
