"""The port's replica fleet (``serve.fleet``, ``serve.worker``) with CPU
workers from ``tools/torch_fleet_factory.py``: health, predict and drain;
the swap refusal matrix in process; two models behind one router with
session affinity; the routed rows against the JAX package's in-process
``ModelServer`` over ``tools/fleet_factory.py``'s same-named factory
(within 1e-5; the JAX server is built in a thread of its own, where block
names start afresh as in a worker process); ``kill -9`` of a worker
mid-wave with zero failed requests; a replica scaled out from a serving
snapshot. The subprocess workers are shared by the module."""
import importlib.util
import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import serve
from mxnet_tpu_torch.checkpoint import SwapError
from mxnet_tpu_torch.serve import (FleetRouter, ServerBusy, WorkerGone,
                                   WorkerHandle, WorkerSpec)
from mxnet_tpu_torch.serve.worker import ServeWorker
from mxnet_tpu_torch.util import load_npz_exact, save_npz_exact
from torch_port_helpers import jax_trace_state_module  # noqa: F401
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
FACTORY = os.path.join(TOOLS, "torch_fleet_factory.py")
# spawning the module's three workers takes about 10 s here: a worker
# that does not come up fails the module in about three times that
SPAWN_TIMEOUT = 45
ENV = {"PYTHONPATH": REPO}


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        "_port_fleet_" + name, os.path.join(TOOLS, "%s.py" % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ff = _tool("torch_fleet_factory")


def _spec(name):
    return WorkerSpec(factory="%s:%s" % (FACTORY, name), env=ENV)


def _xs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, ff.FEAT)).astype(np.float32)


@pytest.fixture(scope="module")
def fleet():
    """A router over two CPU model workers and one CPU generative worker,
    spawned at once."""
    router = FleetRouter()
    router.register("mlp", _spec("model_server_cpu"))
    router.register("gen", _spec("generative_server_cpu"))
    with ThreadPoolExecutor(3) as pool:
        futs = [(m, pool.submit(WorkerHandle.spawn, _spec(f)))
                for m, f in (("mlp", "model_server_cpu"),
                             ("mlp", "model_server_cpu"),
                             ("gen", "generative_server_cpu"))]
        for m, f in futs:
            router.adopt(f.result(timeout=SPAWN_TIMEOUT), model=m)
    yield router
    router.close()


@pytest.fixture(scope="module")
def jax_rows(jax_trace_state_module):
    """The JAX package's in-process ModelServer over the JAX factory's
    ``model_server``, built in a thread of its own (fresh block names, as
    in a worker process): its rows of ``_xs(8)``."""
    jff = _tool("fleet_factory")
    got = {}

    def build():
        got["srv"] = jff.model_server()

    t = threading.Thread(target=build)
    t.start()
    t.join(timeout=SPAWN_TIMEOUT)
    assert not t.is_alive(), "the JAX model server was not built in time"
    srv = got["srv"]
    try:
        return np.stack([np.asarray(srv.predict(x)) for x in _xs(8)])
    finally:
        srv.stop()


def test_health_predict_and_drain():
    """One port carries the fleet's surface: /health has the warm flag,
    the load gauges and draining; /predict round-trips npz in the served
    dtype; a drained replica answers 503 and scores None."""
    worker = ServeWorker(ff.model_server_cpu(), port=0)
    try:
        h = WorkerHandle("127.0.0.1", worker.port)
        health = h.health()
        assert health["warm"] is True and health["kind"] == "model"
        assert health["draining"] is False and health["swap_epoch"] == 0
        assert health["queue_depth"] == health["tokens_in_flight"] == 0
        assert h.load_score() == 0
        x = _xs(1)[0]
        y = h.predict([x])
        assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(),
                                      worker.server.predict(x))
        assert h.server_stats()["requests"] >= 2
        gauges = h.drain()
        assert gauges["draining"] is True and h.health()["draining"]
        with pytest.raises(ServerBusy):
            h.predict([x])
        assert h.load_score() is None
    finally:
        worker.close()


def test_swap_refusal_matrix_in_process():
    """Every divergence (missing, extra, reshaped, another dtype, fp32 at
    an int8 replica) is refused with 409 before any weight moves; the
    matching checkpoint flips the weights."""
    x = _xs(1)[0]
    with tempfile.TemporaryDirectory() as td:
        good = os.path.join(td, "v2.params")
        v2 = ff.model_server_v2_cpu()
        v2.model.save_parameters(good)
        want_v2 = v2.predict(x)
        v2.stop()
        arrays = load_npz_exact(good)
        wkey = next(k for k in sorted(arrays) if arrays[k].dim() == 2)

        def ckpt(name, arrs):
            path = os.path.join(td, name)
            save_npz_exact(path, arrs)
            with open(path, "rb") as f:
                return f.read()

        bad = {"missing": {k: v for k, v in arrays.items() if k != wkey},
               "extra": dict(arrays, not_a_param=torch.zeros(3)),
               "reshaped": dict(arrays, **{wkey: torch.zeros(
                   arrays[wkey].shape[0] + 1, arrays[wkey].shape[1])}),
               "dtype": dict(arrays, **{wkey: arrays[wkey].half()})}
        for srv_make, cases in ((ff.model_server_cpu, bad),
                                (ff.model_server_int8_cpu,
                                 {"fp32": arrays})):
            worker = ServeWorker(srv_make(), port=0)
            try:
                h = WorkerHandle("127.0.0.1", worker.port)
                ref = h.predict([x])
                for name, arrs in cases.items():
                    with pytest.raises(SwapError):
                        h.swap(ckpt(name + ".params", arrs))
                    assert h.health()["swap_epoch"] == 0, name
                    assert torch.equal(h.predict([x]), ref), name
                if srv_make is ff.model_server_cpu:
                    with open(good, "rb") as f:
                        assert h.swap(f.read()) == 1
                    np.testing.assert_allclose(h.predict([x]).numpy(),
                                               want_v2, rtol=1e-6)
            finally:
                worker.close()


def test_routed_rows_equal_jax(fleet, jax_rows):
    rows = np.stack([fleet.predict([x], model="mlp").numpy()
                     for x in _xs(8)])
    np.testing.assert_allclose(rows, jax_rows, rtol=1e-5, atol=1e-5)


def test_two_models_one_router_and_session_affinity(fleet):
    assert fleet.models() == ["gen", "mlp"]
    y = fleet.predict([_xs(1)[0]], model="mlp")
    assert tuple(y.shape) == (ff.CLASSES,)
    prompt = np.arange(1, 7, dtype=np.int32)
    first = fleet.generate(prompt, model="gen", session="chat",
                           max_new_tokens=4, temperature=0.0)
    (gw,) = fleet.workers("gen")
    hits0 = gw.server_stats()["prefix_hits"] or 0
    again = fleet.generate(prompt, model="gen", session="chat",
                           max_new_tokens=4, temperature=0.0)
    assert again == first and len(first) == 4
    assert gw.server_stats()["prefix_hits"] == hits0 + 1
    stats = fleet.stats()
    assert len(stats["models"]["mlp"]) == 2
    assert all(r["ok"] for r in stats["models"]["mlp"])


def test_snapshot_scale_out_and_hot_swap(fleet, tmp_path):
    """A replica scaled out from a serving snapshot (its device in the
    kwargs) serves the snapshot's rows; ``hot_swap`` reaches it."""
    srv = ff.model_server_cpu()
    prefix = str(tmp_path / "mlp")
    srv.snapshot(prefix)
    x = _xs(1, seed=3)[0]
    want = srv.predict(x)
    srv.stop()
    router = FleetRouter()
    router.register("snap", WorkerSpec(snapshot=prefix,
                                       kwargs={"device": "cpu"}, env=ENV))
    try:
        h = router.scale_out("snap")
        assert h.health()["warm"]
        np.testing.assert_allclose(router.predict([x], model="snap"),
                                   want, rtol=1e-6)
        # a new checkpoint in the export's names, and its rows from the
        # same snapshot loaded here
        g = torch.Generator().manual_seed(9)
        new = {k: v + 0.1 * torch.randn(v.shape, generator=g)
               for k, v in load_npz_exact(prefix + "-0000.params").items()}
        good = str(tmp_path / "new.params")
        save_npz_exact(good, new)
        here = serve.load(prefix, snapshot=True, device="cpu")
        here.swap_parameters(good)
        want2 = here.predict(x)
        here.stop()
        assert not np.allclose(want2, want)
        assert set(router.hot_swap(good, model="snap").values()) == {1}
        np.testing.assert_allclose(router.predict([x], model="snap"),
                                   want2, rtol=1e-6)
    finally:
        router.close()


def test_kill9_mid_wave_zero_failed_requests(fleet):
    """SIGKILL one of the two model replicas a quarter into a wave: the
    router retries its requests on the sibling; no request fails and one
    worker is lost."""
    victim = fleet.workers("mlp")[0]
    xs = _xs(40, seed=5)
    done, lock = [0], threading.Lock()

    def one(i):
        y = fleet.predict([xs[i]], model="mlp", timeout=60.0)
        with lock:
            done[0] += 1
            if done[0] == 10:
                victim.kill9()
        return y

    with ThreadPoolExecutor(8) as pool:
        futs = [pool.submit(one, i) for i in range(len(xs))]
        fails = []
        for f in futs:
            try:
                f.result(timeout=SPAWN_TIMEOUT)
            except (WorkerGone, Exception) as e:  # counted, must be none
                fails.append(repr(e))
    assert fails == []
    assert fleet.workers_lost == 1 and len(fleet.workers("mlp")) == 1


def test_autoscaler_decisions():
    """The SLO loop, stepped by hand over stub workers: sustained breach
    (p95 over target, or shedding) scales out once at ``sustain`` points,
    a clean sample decays the pressure, and sustained idle retires down to
    ``min_workers``."""
    from mxnet_tpu_torch.serve import Autoscaler

    class Stub:
        def __init__(self, name):
            self.name = name
            self.stats = {"p95_ms": 10.0, "requests": 0, "shed": 0,
                          "queue_depth": 0, "tokens_in_flight": 0}

        def server_stats(self):
            return dict(self.stats)

    class Router:
        def __init__(self):
            self.pool = [Stub("w0")]
            self.calls = []

        def workers(self, model):
            return list(self.pool)

        def scale_out(self, model):
            self.calls.append("out")
            self.pool.append(Stub("w%d" % len(self.pool)))

        def retire(self, w, model):
            self.calls.append("retire")
            self.pool.remove(w)

        def _event(self, event, **kw):
            pass

    r = Router()
    a = Autoscaler(r, min_workers=1, max_workers=3, slo_p95_ms=50.0,
                   sustain=2, idle=2)
    r.pool[0].stats.update(p95_ms=80.0, requests=10)
    assert a.step() == "breach" and r.calls == []
    r.pool[0].stats.update(requests=20)
    assert a.step() == "breach" and r.calls == ["out"]
    for w in r.pool:
        w.stats.update(p95_ms=5.0)
    r.pool[0].stats.update(requests=30, shed=5)  # 5 of 15 admitted shed
    assert a.step() == "breach"
    assert a.step() == "idle" and a.step() == "idle"
    assert r.calls == ["out", "retire"] and len(r.pool) == 1
    assert a.step() == "idle" and a.step() == "idle"
    assert r.calls == ["out", "retire"]  # at min_workers: kept
