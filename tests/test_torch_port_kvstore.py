"""The port's KVStore, Trainer kvstore wiring and sharded checkpoints
against the JAX package's, in one process: push/pull with list
aggregation, the store-side optimizer update, 2-bit compression with its
residual, priorities, the optimizer-state file both ways, the refusals
(``dist_async``, ``row_sparse_pull``), ``Trainer(compression_params=)``,
and ``save_sharded``/``restore_sharded`` files crossing both ways (the JAX
save takes its pickle branch with ``orbax.checkpoint`` hidden, the JAX
package unchanged)."""
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import kvstore as jkvstore
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import checkpoint, gluon, kvstore
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import nn
from torch_port_helpers import jax_rng_kept, jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_rng_kept")


def _np(x):
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def test_local_push_pull_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3, 4)).astype(np.float32)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    jkv, tkv = jkvstore.create("local"), kvstore.create("local")
    jkv.init(3, jnd.array(w0))
    tkv.init(3, torch.from_numpy(w0))
    jkv.push(3, [jnd.array(a), jnd.array(b)])
    tkv.push(3, [torch.from_numpy(a), torch.from_numpy(b)])
    jout, tout = jnd.zeros((3, 4)), torch.zeros(3, 4)
    jkv.pull(3, out=jout)
    got = tkv.pull(3, out=tout)
    assert got is tout
    np.testing.assert_allclose(tout.numpy(), _np(jout), rtol=1e-6)
    np.testing.assert_allclose(tout.numpy(), w0 + a + b, rtol=1e-6)
    # a pull without out= is a copy
    np.testing.assert_allclose(tkv.pull(3).asnumpy(), _np(jkv.pull(3)))
    # pushpull; list keys with per-key priorities (descending, stable)
    jkv.init(["x", "y"], [jnd.zeros((2,)), jnd.zeros((2,))])
    tkv.init(["x", "y"], [torch.zeros(2), torch.zeros(2)])
    vals = [np.full(2, 1.0, np.float32), np.full(2, 2.0, np.float32)]
    jr = jkv.pushpull(["x", "y"], [jnd.array(v) for v in vals],
                      priority=[0, 5])
    tr = tkv.pushpull(["x", "y"], [torch.from_numpy(v.copy())
                                   for v in vals], priority=[0, 5])
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t.numpy(), _np(j))
    for bad in ([1], "hi"):
        with pytest.raises((ValueError, TypeError)):
            tkv.push(["x", "y"], [torch.zeros(2)] * 2, priority=bad)


def test_optimizer_update_and_state_files_cross(tmp_path,
                                               jax_trace_state):  # noqa: F811
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(5,)).astype(np.float32)
    gs = rng.normal(size=(3, 5)).astype(np.float32)
    jkv, tkv = jkvstore.create("device"), kvstore.create("device")
    jkv.init("w", jnd.array(w0))
    tkv.init("w", torch.from_numpy(w0))
    jkv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.5, momentum=0.9))
    tkv.set_optimizer(topt.SGD(learning_rate=0.5, momentum=0.9))
    for g in gs:
        jkv.push("w", jnd.array(g))
        tkv.push("w", torch.from_numpy(g))
    np.testing.assert_allclose(tkv.pull("w").asnumpy(), _np(jkv.pull("w")),
                               rtol=1e-6, atol=1e-7)
    jpath, tpath = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jkv.save_optimizer_states(jpath)
    tkv.save_optimizer_states(tpath)
    import pickle

    ja, ta = pickle.load(open(jpath, "rb")), pickle.load(open(tpath, "rb"))
    assert len(ja) == len(ta) == 1
    np.testing.assert_allclose(ta[0], ja[0], rtol=1e-6, atol=1e-7)
    # the port reads the JAX package's file
    fresh = kvstore.create("device")
    fresh.init("w", torch.from_numpy(w0))
    fresh.set_optimizer(topt.SGD(learning_rate=0.5, momentum=0.9))
    fresh.load_optimizer_states(jpath)
    np.testing.assert_array_equal(fresh._updater.states["w"].numpy(), ja[0])


def test_two_bit_compression_matches_jax():
    jkv, tkv = jkvstore.create("local"), kvstore.create("local")
    for kv in (jkv, tkv):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    jkv.init("w", jnd.array(np.zeros(4, np.float32)))
    tkv.init("w", torch.zeros(4))
    pushes = [[0.7, -0.7, 0.2, 0.0], [0.0, 0.0, 0.2, 0.0],
              [0.0, 0.0, 0.2, 0.0]]
    for p in pushes:
        p = np.array(p, np.float32)
        jkv.push("w", jnd.array(p))
        tkv.push("w", torch.from_numpy(p))
        np.testing.assert_array_equal(tkv.pull("w").asnumpy(),
                                      _np(jkv.pull("w")))
    np.testing.assert_allclose(tkv.pull("w").asnumpy(),
                               [0.5, -0.5, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(tkv._residual["w"].numpy(),
                               np.asarray(jkv._residual["w"]), atol=1e-7)
    with pytest.raises(ValueError):
        tkv.set_gradient_compression({"type": "1bit"})


def test_refusals_and_names():
    with pytest.raises(ValueError, match="asynchronous"):
        kvstore.create("dist_async")
    with pytest.raises(ValueError, match="unknown"):
        kvstore.create("bogus")
    assert type(kvstore.create("dist_sync")) is kvstore.DistKVStore
    assert type(kvstore.create("nccl")) is kvstore.KVStore
    # row_sparse_pull is ported (tests/test_torch_port_sparse.py): it
    # refuses a call without out= or row_ids=
    local = kvstore.create("local")
    local.init("w", torch.arange(4.0).reshape(2, 2))
    with pytest.raises(ValueError, match="row_ids"):
        local.row_sparse_pull("w", out=torch.zeros(2, 2))
    out = torch.zeros(2, 2)
    local.row_sparse_pull("w", out=out, row_ids=torch.ones(1))
    np.testing.assert_array_equal(out.numpy(), [[0.0, 0.0], [2.0, 3.0]])
    # a group of one (no process group): dist_sync is the local store
    kv = kvstore.create("dist_sync")
    kv.init("w", torch.zeros(2))
    kv.push("w", torch.ones(2))
    np.testing.assert_array_equal(kv.pull("w").asnumpy(), [1.0, 1.0])
    assert (kv.rank, kv.num_workers) == (0, 1)


def test_trainer_wires_gradient_compression(jax_trace_state):  # noqa: F811
    jkv = jkvstore.create("dist_sync")
    jnet = jmx.gluon.nn.Dense(4, in_units=3)
    jnet.initialize()
    jmx.gluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1},
                      kvstore=jkv, compression_params={
                          "type": "2bit", "threshold": 0.5})
    kv = kvstore.create("dist_sync")
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                  kvstore=kv, compression_params={"type": "2bit",
                                                  "threshold": 0.5})
    assert kv._compression == jkv._compression
    with pytest.warns(UserWarning, match="compression_params ignored"):
        gluon.Trainer(net.collect_params(), "sgd",
                      compression_params={"type": "2bit"})
    # a step through a local kvstore object: the pull writes each step's
    # sum into the gradient buffers, the update sees it
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore=kvstore.create("local"))
    w0 = net.weight._tensor().detach().clone()
    for _ in range(2):
        net.weight._tensor().grad = torch.ones(4, 3)
        net.bias._tensor().grad = torch.ones(4)
        tr.step(1)
    np.testing.assert_allclose(net.weight._tensor().detach().numpy(),
                               (w0 - 0.2).numpy(), rtol=1e-6)


def _tree():
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "opt": (rng.normal(size=(3,)).astype(np.float32),
                    np.float32(2.5)),
            "layers": [rng.normal(size=(2,)).astype(np.float32)]}


def test_sharded_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    import jax.numpy as jnp

    tree = _tree()
    like_t = {"w": torch.zeros(4, 3), "opt": (torch.zeros(3),
                                              torch.zeros(())),
              "layers": [torch.zeros(2)]}
    # the port writes, the JAX package reads
    assert checkpoint.save_sharded(str(tmp_path / "t"), {
        "w": torch.from_numpy(tree["w"]),
        "opt": (torch.from_numpy(tree["opt"][0]),
                torch.tensor(tree["opt"][1])),
        "layers": [torch.from_numpy(tree["layers"][0])]}, 7) is False
    assert checkpoint.latest_step(str(tmp_path / "t")) == 7
    jlike = {"w": jnp.zeros((4, 3)), "opt": (jnp.zeros(3), jnp.float32(0)),
             "layers": [jnp.zeros(2)]}
    got = jckpt.restore_sharded(str(tmp_path / "t"), 7, like=jlike)
    np.testing.assert_array_equal(np.asarray(got["w"]), tree["w"])
    np.testing.assert_array_equal(np.asarray(got["opt"][0]), tree["opt"][0])
    assert float(got["opt"][1]) == 2.5
    # the JAX package writes its pickle form (orbax hidden), the port reads
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    jckpt.save_sharded(str(tmp_path / "j"), {
        "w": jnp.asarray(tree["w"]), "opt": (jnp.asarray(tree["opt"][0]),
                                             jnp.float32(2.5)),
        "layers": [jnp.asarray(tree["layers"][0])]}, 12)
    assert checkpoint.latest_step(str(tmp_path / "j")) == 12
    back = checkpoint.restore_sharded(str(tmp_path / "j"), 12, like=like_t)
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(back["layers"][0].numpy(),
                                  tree["layers"][0])
    assert float(back["opt"][1]) == 2.5
    # an orbax directory is refused by name; in-flight files do not count
    (tmp_path / "o" / "step_00000003").mkdir(parents=True)
    (tmp_path / "o" / "step_00000009.pkl.tmp").write_bytes(b"")
    assert checkpoint.latest_step(str(tmp_path / "o")) == 3
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.restore_sharded(str(tmp_path / "o"), 3, like=like_t)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_sharded(str(tmp_path / "j"), 12,
                                   like={"w": torch.zeros(4, 3)})


def test_run_resilient_resumes_exactly(tmp_path):
    from mxnet_tpu_torch.parallel import resilience

    def step(state, batch):
        w, n = state
        return (w - 0.1 * batch, n + 1)

    def make_batch(s):
        return torch.full((3,), float(s))

    init = (torch.zeros(3), torch.zeros((), dtype=torch.int64))
    plain, _ = resilience.run_resilient(step, init, make_batch, 10,
                                        str(tmp_path / "a"), save_every=3)
    with pytest.raises(resilience.SimulatedFailure):
        resilience.run_resilient(step, init, make_batch, 10,
                                 str(tmp_path / "b"), save_every=3,
                                 fail_at=7)
    resumed, start = resilience.run_resilient(
        step, init, make_batch, 10, str(tmp_path / "b"), save_every=3)
    assert start == 6
    assert torch.equal(resumed[0], plain[0]) and int(resumed[1]) == 10
    hb = resilience.Heartbeat(interval_s=0.01, timeout_s=100.0,
                              device="cpu").start()
    import time

    time.sleep(0.05)
    hb.stop()
    assert hb.last_ok > 0


_LAUNCHED = '''
import sys
sys.path.insert(0, sys.argv[1])
import torch
from mxnet_tpu_torch import kvstore
from mxnet_tpu_torch.parallel import distributed

distributed.init_process_group(device="cpu", timeout_s=60)
kv = kvstore.create("dist_sync")
kv.init("w", torch.zeros(2))
kv.push("w", torch.full((2,), float(distributed.rank() + 1)))
print("RANK%d_SUM%s" % (distributed.rank(), kv.pull("w").asnumpy().tolist()),
      flush=True)
distributed.shutdown()
'''


def test_launch_py_starts_a_port_script(tmp_path):
    """``tools/launch.py -n 2`` sets the DMLC variables; the port's
    ``init_process_group`` joins with them unchanged (gloo on the CPU)."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "job.py"
    script.write_text(_LAUNCHED)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC")}
    r = subprocess.run([sys.executable, os.path.join(repo, "tools",
                                                     "launch.py"),
                        "-n", "2", sys.executable, str(script), repo],
                       capture_output=True, text=True, timeout=30, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    for rank in (0, 1):
        assert "RANK%d_SUM[3.0, 3.0]" % rank in r.stdout, r.stdout
