"""The port's data-parallel training over 4 gloo ranks on the CPU, held
against the JAX package on the first four of conftest's eight CPU devices
(``make_mesh({"dcn": 2, "dp": 2}, devices=jax.devices()[:4])`` and
``{"dp": 4}``).

One group of 4 ranks runs once a module (``tests/torch_port_dist_worker.py``
each, a file store under the module's temporary directory, so parallel test
workers cannot collide); every case runs on every rank and the ranks'
results come back as ``.npz`` files. The JAX package's stacked mode, a
``(W, n)`` input with one row a worker, is rank ``r`` holding row ``r``.

The cases mirror ``tests/test_dist.py``, ``tests/test_dist_kvstore.py``
and the dp cases of ``tests/test_parallel.py``: the hierarchical sums
(the same fp32 additions in another order: 2e-6, the JAX tests' bound),
error feedback telescoping for fp16/int8/2bit, the 2-bit threshold, the
bucket plan (equal to the JAX package's), trainer parity at ZeRO 0-3
(each rank a quarter of the batch, ``average=True``, against the JAX
package's single-device step on the whole batch: what is measured is the
losses and the final weights, within 1e-5 relative), the ZeRO-3
gather/release round trip, gradient accumulation (two backwards a step
at ``grad_req="add"``), the elastic drill, overlapped against
serialized trajectories, ``DistKVStore`` sums, compression through the
Trainer, and ``build_train_step``/``block_loss_fn``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import dist as jdist
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jparallel
from jax.sharding import NamedSharding, PartitionSpec as JP
from torch_port_helpers import jax_rng_kept, jax_trace_state_module  # noqa: F401
from torch_port_helpers import run_ranks

pytestmark = pytest.mark.usefixtures("jax_trace_state_module",
                                      "jax_rng_kept")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
WORLD = 4
BUCKET_SHAPES = [(64, 64), (64,), (32, 64), (64, 32), (16,)]


def _mesh2():
    return jparallel.make_mesh({"dcn": 2, "dp": 2},
                               devices=jax.devices()[:WORLD])


def _stacked(mesh, x):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(mesh, JP(("dcn", "dp"), None)))


def _jax_mlp(steps=4):
    mx.random.seed(0)
    net = jgluon.nn.Sequential()
    net.add(jgluon.nn.Dense(32, activation="relu", in_units=8),
            jgluon.nn.Dense(16, activation="relu", in_units=32),
            jgluon.nn.Dense(1, in_units=16))
    net.initialize()
    xs = np.random.RandomState(1).randn(steps, 16, 8).astype(np.float32)
    ys = np.random.RandomState(2).randn(steps, 16, 1).astype(np.float32)
    return net, xs, ys


def _inputs(workdir):
    rng = np.random.default_rng(0)
    inp = {"workdir": np.array(str(workdir)),
           "hier_x": rng.normal(size=(WORLD, 256)).astype(np.float32),
           "single_x": np.random.default_rng(1).normal(
               size=(WORLD, 64)).astype(np.float32),
           "rep_v": np.random.default_rng(1).normal(size=(64,)).astype(
               np.float32),
           "kv_x": np.random.default_rng(2).normal(
               size=(WORLD, 128)).astype(np.float32),
           "ef_v": np.clip(0.3 * np.random.default_rng(3).normal(size=(64,)),
                           -0.45, 0.45).astype(np.float32),
           "bucket_shapes": np.array([list(s) + [0] * (2 - len(s))
                                      for s in BUCKET_SHAPES])}
    rng4 = np.random.default_rng(4)
    for i, s in enumerate(BUCKET_SHAPES):
        inp["bucket_g%d" % i] = rng4.normal(size=(WORLD,) + s).astype(
            np.float32)
    net, xs, ys = _jax_mlp()
    for j, p in enumerate(net.collect_params().values()):
        inp["mlp_w%d" % j] = np.asarray(p.data().asnumpy())
    inp["mlp_xs"], inp["mlp_ys"] = xs, ys
    for s in range(12):
        r = np.random.RandomState(100 + s)
        inp["el_x%d" % s] = r.randn(8, 4).astype(np.float32)
        inp["el_y%d" % s] = r.randn(8, 1).astype(np.float32)
    inp["ts_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                               (16, 4)))
    inp["ts_y"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                               (16, 1)))
    bl = _jax_block_net()
    for j, p in enumerate(bl.collect_params().values()):
        inp["bl_w%d" % j] = np.asarray(p.data().asnumpy())
    inp["bl_x"] = np.random.RandomState(5).randn(16, 4).astype(np.float32)
    inp["bl_y"] = np.random.RandomState(6).randint(0, 2, 16).astype(
        np.float32)
    return inp


def _jax_block_net():
    mx.random.seed(7)
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(8, activation="relu", in_units=4),
            jgluon.nn.Dense(2, in_units=8))
    net.initialize()
    return net


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_trace_state_module):
    """{case: [rank 0's results, ..., rank 3's]} of one run of the worker
    on 4 ranks, and the inputs."""
    workdir = tmp_path_factory.mktemp("dist4")
    inp = _inputs(workdir)
    return run_ranks(WORKER, workdir, inp, WORLD), inp


def test_hierarchical_stacked_matches_numpy_and_jax(ranks):
    out, inp = ranks
    mesh = _mesh2()
    x = inp["hier_x"]
    jsum, _ = jdist.HierarchicalAllreduce(
        mesh, ici_axis="dp", dcn_axis="dcn").reduce(_stacked(mesh, x),
                                                    stacked=True)
    jmean, _ = jdist.HierarchicalAllreduce(
        mesh, ici_axis="dp", dcn_axis="dcn", average=True).reduce(
        _stacked(mesh, x), stacked=True)
    for r in range(WORLD):
        h = out["hier"][r]
        assert h["res_is_none"]
        np.testing.assert_allclose(h["sum"], x.sum(0), rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(h["sum"], np.asarray(jsum), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_allclose(h["mean"], np.asarray(jmean), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_array_equal(h["sum"], out["hier"][0]["sum"])


def test_hierarchical_single_level_and_replicated_exact(ranks):
    out, inp = ranks
    mesh1 = jparallel.make_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
    x1 = inp["single_x"]
    jout, _ = jdist.HierarchicalAllreduce(mesh1, ici_axis="dp").reduce(
        jax.device_put(jnp.asarray(x1), NamedSharding(mesh1, JP("dp", None))),
        stacked=True)
    jrep, _ = jdist.HierarchicalAllreduce(
        _mesh2(), ici_axis="dp", dcn_axis="dcn").reduce(
        jnp.asarray(inp["rep_v"]), stacked=False)
    for r in range(WORLD):
        h = out["hier"][r]
        np.testing.assert_allclose(h["single"], x1.sum(0), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_allclose(h["single"], np.asarray(jout), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_allclose(h["flat_mean"], x1.mean(0), rtol=2e-6,
                                   atol=2e-6)
        # replicated: the same data movement gives the input back exactly
        np.testing.assert_array_equal(h["replicated"], inp["rep_v"])
        np.testing.assert_array_equal(h["replicated"], np.asarray(jrep))


def test_kvstore_dcn_leg_parity(ranks):
    out, inp = ranks
    mesh = _mesh2()
    x = inp["kv_x"]
    jh = jdist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                     dcn="kvstore")
    jout, _ = jh.reduce(_stacked(mesh, x), stacked=True)
    for r in range(WORLD):
        h = out["hier"][r]
        assert h["kv_host_hop"]
        np.testing.assert_allclose(h["kv_sum"], x.sum(0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h["kv_sum"], np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("ctype,bound", [("fp16", 2e-3), ("int8", 0.1),
                                         ("2bit", 0.51)])
def test_error_feedback_cumulative_sum_telescopes(ranks, ctype, bound):
    """K compressed exchanges sum to K * truth minus the final residual,
    exactly as the JAX package's do; acc == deq(payload) + residual
    bit for bit at every step on every rank."""
    out, inp = ranks
    v = inp["ef_v"]
    mesh = _mesh2()
    h = jdist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                    compression={"type": ctype})
    res = h.residual_init(h.pad_to(64))
    jcum = np.zeros(64, np.float32)
    for _ in range(6):
        o, res = h.reduce(jnp.asarray(v), res, stacked=False)
        jcum += np.asarray(o)
    jres = np.asarray(res)[0].reshape(-1)[:64]
    # the dcn row 0's shards, in gather order: ranks 0 and 1
    res_full = np.concatenate([out["ef"][r][ctype + "_res"]
                               for r in (0, 1)])[:64]
    for r in range(WORLD):
        e = out["ef"][r]
        assert e[ctype + "_exact"]
        cum = e[ctype + "_cum"]
        np.testing.assert_allclose(cum, 6 * v - res_full, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(cum, jcum, rtol=1e-6, atol=1e-6)
        assert np.max(np.abs(cum - 6 * v)) <= bound
    np.testing.assert_allclose(res_full, jres, rtol=1e-6, atol=1e-6)
    assert np.max(np.abs(res_full)) <= bound


def test_2bit_threshold_accumulates_small_gradients(ranks):
    out, _ = ranks
    for r in range(WORLD):
        outs = out["ef"][r]["small_outs"]
        assert np.all(outs[0] == 0.0)
        np.testing.assert_allclose(outs.sum(0), np.full(32, 1.0), atol=1e-6)


def test_bucket_layout_equals_jax_and_no_replan(ranks):
    out, inp = ranks
    mesh = _mesh2()
    strat = jdist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn")
    jb = jdist.GradientBucketer(strat, bucket_mb=0.01, stacked=True)
    jplan = jb.plan(tuple(((WORLD,) + s, "float32") for s in BUCKET_SHAPES))
    want = [i for b in jplan for i in b] + [-1] + [len(b) for b in jplan]
    assert len(jplan) >= 2
    for r in range(WORLD):
        b = out["bucket"][r]
        assert b["plan"].tolist() == want
        assert b["plan_cached"]
        assert int(b["steady_plans"]) == 0
        assert int(b["steady_launches"]) == len(jplan)
        assert int(b["plans_made"]) == 1
        for i in range(len(BUCKET_SHAPES)):
            np.testing.assert_allclose(b["g%d" % i],
                                       inp["bucket_g%d" % i].sum(0),
                                       rtol=2e-5, atol=2e-5)


def _jax_train(steps=4):
    net, xs, ys = _jax_mlp(steps)
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    losses = []
    for s in range(steps):
        x, y = jnd.array(xs[s]), jnd.array(ys[s])
        with jautograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        losses.append(float(np.asarray(loss.asnumpy())))
        tr.step(16)
    weights = [np.asarray(p.data().asnumpy())
               for p in net.collect_params().values()]
    return np.array(losses), weights


@pytest.fixture(scope="module")
def jax_train(jax_trace_state_module):
    return _jax_train()


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("zero", [0, 1, 2, 3])
def test_trainer_attach_parity(ranks, jax_train, zero):
    """Each rank a quarter of the batch through attach(average=True) at
    ZeRO ``zero``: the losses and the final weights of every rank against
    the JAX package's single-device step on the whole batch."""
    out, _ = ranks
    jl, jw = jax_train
    for r in range(WORLD):
        t = out["trainer"][r]
        assert _rel(t["z%d_losses" % zero], jl) <= 1e-5
        for j, w in enumerate(jw):
            assert _rel(t["z%d_w%d" % (zero, j)], w) <= 1e-5, (zero, j)
            np.testing.assert_array_equal(t["z%d_w%d" % (zero, j)],
                                          out["trainer"][0]["z%d_w%d"
                                                            % (zero, j)])
        assert int(t["z%d_launches" % zero]) >= 2 * 4   # >1 bucket a step
        assert len(t["z%d_windows" % zero]) == 4
        assert t["z%d_stats" % zero].tolist() == [1, 1]
        assert all(t["z%d_detached" % zero])
    numel = [int(out["trainer"][0]["z%d_state_numel" % z]) for z in (0, 1)]
    per_dev, whole = out["trainer"][0]["z%d_state_bytes" % zero]
    assert whole == 4 * numel[0]   # every momentum's whole fp32 value
    if zero >= 1:  # the momentum lives as the rank's blocks
        assert int(out["trainer"][0]["z%d_state_numel" % zero]) < \
            numel[0] / 2
        assert per_dev < whole / 2
    else:
        assert per_dev == whole
    if zero == 1:
        assert all(out["trainer"][r]["z1_state_roundtrip"]
                   for r in range(WORLD))
    if zero == 3:
        per_dev, glob = out["trainer"][0]["z3_bytes"]
        assert per_dev < glob / 2


@pytest.mark.parametrize("zero", [0, 2])
def test_gradient_accumulation_under_attach(ranks, jax_train, zero):
    """grad_req="add" with two backwards a step (each half of a rank's
    quarter of the batch) before the update, through attach: the losses
    and final weights against the JAX package's single-device step on the
    whole batch (1e-5 relative); every bucket launches in both backwards
    (the second re-arms the exchanger). With fp16 error feedback, a second
    backward that adds exactly zero leaves the weights bit for bit those
    of one backward: the dropped exchanges' residuals are put back."""
    out, _ = ranks
    jl, jw = jax_train
    for r in range(WORLD):
        a = out["accumulate"][r]
        assert _rel(a["z%d_losses" % zero], jl) <= 1e-5
        for j, w in enumerate(jw):
            assert _rel(a["z%d_w%d" % (zero, j)], w) <= 1e-5, (zero, j)
        launches, buckets = a["z%d_launches" % zero].tolist()
        assert buckets >= 2 and launches == 2 * buckets * len(jl)
        assert a["fp16_second_zero_equal"]


def test_zero3_gather_release_roundtrip(ranks, jax_train):
    out, _ = ranks
    for r in range(WORLD):
        t = out["trainer"][r]
        per_sharded, glob, per_gathered, per_released = t["z3_roundtrip"]
        assert per_sharded < glob / 2
        assert per_gathered == glob
        assert per_released == per_sharded
        assert t["z3_blocks_kept"]
        for j in range(6):
            np.testing.assert_array_equal(t["z3_full%d" % j],
                                          t["z3_w%d" % j])
    assert int(out["trainer"][0]["plain_after_detach_launches"]) == 0


def test_elastic_drill_matches_uninterrupted_run(ranks, tmp_path):
    """4 ranks, a failure before step 7, ranks 0 and 1 survive, restore
    step 6 and go on: the trajectory and the weights equal the
    uninterrupted run's, and the JAX package's on 4 devices."""
    import functools
    import jax

    out, inp = ranks

    def build_step(mesh):
        def loss_fn(w, xb, yb):
            return jnp.mean((xb @ w - yb) ** 2)

        @functools.partial(jax.jit)
        def step(state, batch):
            w, n = state
            l, g = jax.value_and_grad(loss_fn)(w, *batch)
            return (w - 0.1 * g, n + 1), l

        def place(state, mesh):
            rep = NamedSharding(mesh, JP())
            return jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), rep), state)

        return step, place

    def make_batch(s):
        return (jnp.asarray(inp["el_x%d" % s]), jnp.asarray(inp["el_y%d" % s]))

    init = (jnp.zeros((4, 1), jnp.float32), jnp.int32(0))
    jrun = jdist.ElasticTrainer(build_step, init, make_batch,
                                str(tmp_path / "j"), save_every=3).run(
        12, devices=jax.devices()[:WORLD])
    jl = np.array([jrun.losses[s] for s in range(12)])
    for r in range(WORLD):
        e = out["elastic"][r]
        np.testing.assert_allclose(e["plain_losses"], jl, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(e["plain_w"], np.asarray(jrun.state[0]),
                                   rtol=1e-5, atol=1e-6)
        assert bool(e["left"]) == (r >= 2)
    for r in (0, 1):
        e = out["elastic"][r]
        assert e["event"].tolist() == [7, 2, 6, 1]
        np.testing.assert_allclose(e["drill_losses"], e["plain_losses"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(e["drill_w"], e["plain_w"], atol=1e-6)
        assert int(e["drill_n"]) == 12
        assert int(e["recorded"]) >= 1


def test_overlapped_and_serialized_loss_trajectories_identical(ranks):
    """The exchange launched under the backward (attach) and the blocking
    one after it (a dist_sync kvstore push/pull) give one trajectory."""
    out, _ = ranks
    for r in range(WORLD):
        o = out["overlap"][r]
        assert np.max(np.abs(o["overlapped"] - o["serialized"])) <= 1e-6
        assert float(o["weights_gap"]) <= 1e-6


def test_env_bucket_cap_and_runtime(ranks, monkeypatch):
    out, _ = ranks
    for r in range(WORLD):
        assert float(out["top"][r]["env_bucket_mb"]) == 2.5
        assert out["top"][r]["rank_size"].tolist() == [r, WORLD]
    from mxnet_tpu_torch import dist

    monkeypatch.setenv("MXNET_DIST_BUCKET_MB", "bogus")
    assert dist.default_bucket_mb() == 4.0


def test_dist_kvstore_push_sums_across_processes(ranks):
    """Push semantics are a SUM over the ranks: 1 + 2 = 3 over a pair, not
    1.5; 1 + 2 + 3 + 4 = 10 over the four."""
    out, _ = ranks
    for r in range(WORLD):
        k = out["kv"][r]
        np.testing.assert_array_equal(k["world_sum"], np.full(4, 10.0))
        assert k["workers"].tolist() == [r, WORLD]
        assert float(k["compression"][0]) == 0.5
        # ranks 0 and 2 push 0.7 (ternarized to 0.5), 1 and 3 push 0.2
        # (below the threshold: 0): the sum is 1.0
        np.testing.assert_array_equal(k["compressed_grad"],
                                      np.full((4, 3), 1.0))
    for r in (0, 1):
        np.testing.assert_array_equal(out["kv"][r]["pair_sum"],
                                      np.full(4, 3.0))


def test_build_train_step_and_block_loss_fn_match_jax(ranks):
    import mxnet_tpu as jmx

    out, inp = ranks
    opt = jmx.optimizer.SGD(learning_rate=0.1)

    def loss_fn(params, batch, key):
        x, y = batch
        return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)

    params = {"w": jnp.ones((4, 1)), "b": jnp.zeros((1,))}
    step = jparallel.build_train_step(loss_fn, opt, donate=False)
    p1, _, l1 = step(params, {"w": (), "b": ()}, jnp.int32(1),
                     jax.random.PRNGKey(2),
                     (jnp.asarray(inp["ts_x"]), jnp.asarray(inp["ts_y"])))
    net = _jax_block_net()
    jloss, plist = jparallel.block_loss_fn(
        net, jgluon.loss.SoftmaxCrossEntropyLoss())
    arrays = [p.data()._data for p in plist]
    adam = jmx.optimizer.Adam()
    init_states, _ = jparallel.tree_optimizer_step(adam)
    states = init_states(arrays)
    bstep = jparallel.build_train_step(jloss, adam, donate=False)
    losses = []
    for i in range(5):
        arrays, states, loss = bstep(
            arrays, states, jnp.int32(1 + i), jax.random.PRNGKey(0),
            (jnp.asarray(inp["bl_x"]), jnp.asarray(inp["bl_y"])))
        losses.append(float(loss))
    for r in range(WORLD):
        s = out["step"][r]
        np.testing.assert_allclose(s["ts_loss"], np.asarray(l1), rtol=1e-5)
        np.testing.assert_allclose(s["ts_w"], np.asarray(p1["w"]), rtol=1e-5)
        np.testing.assert_allclose(s["ts_b"], np.asarray(p1["b"]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(s["ts_sharded_w"], s["ts_w"], rtol=1e-6)
        # momentum states: the sharded step keeps the rank's blocks
        np.testing.assert_allclose(s["ts_mom_sharded_w"], s["ts_mom_whole_w"],
                                   rtol=1e-6)
        assert s["ts_mom_whole_state"].tolist() == [8, 1]
        assert s["ts_mom_sharded_state"].tolist() == [2, 1]
        np.testing.assert_allclose(s["bl_losses"], losses, rtol=1e-5)
        for j, a in enumerate(arrays):
            np.testing.assert_allclose(s["bl_p%d" % j], np.asarray(a),
                                       rtol=1e-5, atol=1e-6)
