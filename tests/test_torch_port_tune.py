"""The port's tuner (``mxnet_tpu_torch.ir.tune``) against the JAX
package's (``mxnet_tpu.ir.tune``), in process. The CPU asserts no speed
(host timings move run to run): it pins the candidate space (the JAX
package's less ``donation``), the cost ranking, the parity gate over the
whole default space, the store's round trip (a malformed file, a stale
record), a fresh port process reloading an installed winner with no
search, ``fit_buckets``/``tune_buckets`` as the JAX package's, the fp32
flash split's candidates and its store read, and that the flash search
refuses without a card."""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from mxnet_tpu.ir import tune as jtune

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import base, engine, ir, nd
from mxnet_tpu_torch.base import OP_REGISTRY as REG
from mxnet_tpu_torch.ir import graph as g
from mxnet_tpu_torch.ir import lower, passes, tune
from mxnet_tpu_torch.ops.cuda import flash_attention as fa
from torch_port_helpers import keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def tmp_store(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("MXNET_TUNE_STORE", path)
    tune.reset_store()
    tune.reset_stats()
    yield path
    monkeypatch.delenv("MXNET_TUNE_STORE", raising=False)
    tune.reset_store()


def _graph(dot=False, shape=(8, 16)):
    """x * a + tanh(x * a) (a duplicate subexpression), or a dot."""
    b = ir.GraphBuilder()
    sig = g.tensor_sig(torch.empty(shape))
    x = b.leaf("x", sig=sig)
    if dot:
        w = b.leaf("w", sig=g.tensor_sig(torch.empty(shape[::-1])))
        return b.build((b.add("dot", REG["dot"], {}, (), (x, w)),))
    a = b.leaf("a", sig=sig)
    m1 = b.add("multiply", REG["multiply"], {}, (), (x, a))
    m2 = b.add("multiply", REG["multiply"], {}, (), (x, a))
    t = b.add("tanh", REG["tanh"], {}, (), (m2,))
    return b.build((b.add("add", REG["add"], {}, (), (m1, t)),))


def _strip(cfg):
    out = dict(cfg, passes=[p for p in cfg["passes"] if p != "donation"])
    return out


def test_candidate_space_is_the_jax_packages_less_donation():
    for q in (False, True):
        want = []
        for c in map(_strip, jtune.candidate_configs(include_quant=q)):
            if c not in want:
                want.append(c)
        assert tune.candidate_configs(include_quant=q) == want
    assert all("quant" not in c["passes"]
               for c in tune.candidate_configs())
    assert tune.config_key({"b": 1, "a": [2]}) == \
        jtune.config_key({"b": 1, "a": [2]})


def test_rank_candidates_orders_as_the_jax_packages():
    rng = np.random.default_rng(0)
    rows = []
    for i, cfg in enumerate(tune.candidate_configs(include_quant=True)):
        cost = {"bytes_accessed": float(rng.integers(0, 4)),
                "flops": float(rng.integers(0, 3)),
                "peak_hbm_bytes": float(rng.integers(0, 2))}
        rows.append({"config": cfg, "config_key": tune.config_key(cfg),
                     "cost": cost})
    got = [r["config_key"] for r in tune.rank_candidates(rows)]
    want = [r["config_key"] for r in jtune.rank_candidates(rows)]
    assert got == want
    assert got == [r["config_key"] for r in tune.rank_candidates(
        list(reversed(rows)))]


def test_parity_gate_holds_over_the_whole_default_space(tmp_store):
    rep = tune.search(_graph(), pairs=1, device=CPU)
    assert rep["candidates"] == len(tune.candidate_configs())
    assert rep["parity_rejects"] == 0
    assert rep["pruned"] + len(rep["timed"]) == rep["candidates"]
    st = tune.stats()
    assert st["searches"] == 1 and st["last_search"]["key"] == \
        rep["key"][:16]
    # quant fires on a dot and changes its numbers: the gate rejects it
    rep = tune.search(_graph(dot=True), pairs=1, include_quant=True,
                      device=CPU, install_winner=False)
    assert rep["parity_rejects"] == 3  # one quant arm a fold cap


def test_store_round_trip_malformed_and_stale(tmp_store):
    key = g.canonical_key(g.canonicalize(_graph()).graph)
    rec = tune.install(key, {"passes": ["cse", "dce"]},
                       objective={"delta_ms": 1.0})
    assert rec["tuned_by"] == tune.TUNED_BY + ".search"
    with open(tmp_store) as f:
        on_disk = json.load(f)
    assert on_disk["entries"]["graph:" + key]["config"] == {
        "passes": ["cse", "dce"]}
    assert not os.path.exists(tmp_store + ".tmp")
    tune.reset_store()
    pm = tune.pass_manager_for(key)
    assert pm.passes == ("cse", "dce")
    # the lowering takes it: one tuned build
    lower.reset_stats()
    _, ent = lower.prepare(_graph())
    assert ent.config == {"passes": ["cse", "dce"]}
    assert lower.stats()["builds"]["tuned_builds"] == 1
    # a stale record (the JAX package's donation) warns, lowers by default
    tune.get_store().put("graph:" + key, {"config": {
        "passes": ["cse", "donation"]}})
    with pytest.warns(RuntimeWarning, match="does not rebuild"):
        assert tune.pass_manager_for(key) is None
    assert tune.stats()["stale_records"] == 1
    # a malformed file reads as empty
    with open(tmp_store, "w") as f:
        f.write("{not json")
    tune.reset_store()
    with pytest.warns(RuntimeWarning, match="malformed"):
        assert len(tune.get_store()) == 0
    base._IR_CACHE.pop(key, None)


_CHILD = r"""
import json, numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine, nd
from mxnet_tpu_torch.ir import lower, tune
from mxnet_tpu_torch.observability import watchdog
x = nd.array(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
             ctx=mx.cpu())
def chain():
    with engine.bulk(16):
        y = (x * 2.0 + 1.0).tanh() * x
        return y.asnumpy()
chain()
watchdog.arm()
chain()
print(json.dumps({"searches": tune.stats()["searches"],
                  "hits": tune.stats()["store_hits"],
                  "tuned_builds": lower.stats()["builds"]["tuned_builds"],
                  "events": watchdog.snapshot()["events"]}))
"""


def test_fresh_process_reloads_the_winner_with_no_search(tmp_store):
    x = nd.array(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
                 ctx=mx.cpu())
    base._IR_CACHE.clear()
    with engine.bulk(16):
        ((x * 2.0 + 1.0).tanh() * x).asnumpy()
    (key,) = list(base._IR_CACHE)
    tune.install(key, {"passes": ["cse", "fold", "dce"]})
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TUNE_STORE=tmp_store)
    r = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"searches": 0, "hits": 1, "tuned_builds": 1,
                   "events": 0}


@pytest.mark.parametrize("hist", [{1: 40, 3: 5, 8: 2, 30: 1},
                                  {2: 7, 4: 7, 5: 1, 16: 3, 17: 2},
                                  {64: 1}])
def test_fit_buckets_and_tune_buckets_as_the_jax_packages(hist, tmp_store):
    for k in (1, 2, 3, 6):
        assert tune.fit_buckets(hist, k) == jtune.fit_buckets(hist, k)
        assert tune.fit_buckets(hist, k, max_size=64) == \
            jtune.fit_buckets(hist, k, max_size=64)

    class Server:
        name = "srv"
        buckets = (1, 8, 64)

        class metrics:
            @staticmethod
            def request_rows():
                return dict(hist)

        def __init__(self):
            self.applied = []

        def retune_buckets(self, b):
            self.applied.append(tuple(b))

    ps, js = Server(), Server()
    got = tune.tune_buckets(ps, max_buckets=3)
    want = jtune.tune_buckets(js, max_buckets=3, install_record=False)
    assert got == want and ps.applied == js.applied
    rec = tune.get_store().get("serve:buckets:srv")
    assert rec["config"]["buckets"] == list(got["buckets"])


def test_flash_candidates_and_the_installed_split(tmp_store):
    shapes = [(12, 256, 256, True), (12, 1024, 1024, True),
              (96, 512, 512, False), (1, 2048, 2048, True)]
    for bh, tq, tk, causal in shapes:
        a = tune.flash_block_candidates(bh, tq, tk, causal)
        assert a == tune.flash_block_candidates(bh, tq, tk, causal)
        tiles = fa.f32_key_tiles(tq, tk, causal, fa.F32_TILES[64])
        most = max(tiles)
        assert a[0] == (1, most)
        assert all(-(-most // c) == s for s, c in a)
        assert len({s for s, _ in a}) == len(a)
        # nothing installed: the cost model's choice
        model = fa._f32_splits(bh, tq, tk, causal, 132, fa.F32_TILES[64])
        assert fa.flash_f32_splits(bh, tq, tk, causal, 132) == model
        assert model in a or model[0] == 1
    tight = tune.flash_block_candidates(96, 512, 512, False,
                                        workspace_budget=1 << 20)
    assert tight == [(1, 8)]
    # an installed split is read first; one that no longer fits is not
    tune.get_store().put("flash:f32:12:1024:1024:1:64",
                         {"config": {"split": [4, 4]}})
    assert fa.flash_f32_splits(12, 1024, 1024, True, 132) == (4, 4)
    tune.get_store().put("flash:f32:12:1024:1024:1:64",
                         {"config": {"split": [3, 4]}})
    assert fa.flash_f32_splits(12, 1024, 1024, True, 132) == \
        fa._f32_splits(12, 1024, 1024, True, 132, fa.F32_TILES[64])


def test_tune_flash_blocks_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tune.tune_flash_blocks()


def test_bulk_watermark_is_a_reading(tmp_store):
    prev = engine.bulk_size()
    got = tune.tune_bulk_watermark(rounds=2, chain=6, shape=(4, 4),
                                   device=CPU)
    assert set(got["medians_ms"]) == {0, 5, 15, 30, 60}
    assert got["winner"] in got["medians_ms"]
    assert engine.bulk_size() == prev  # the default stays
    rec = tune.get_store().get("engine:bulk_size")
    assert rec["config"]["bulk_size"] == got["winner"]


def test_paired_step_ms_interleaves_the_arms():
    seen = []
    got = tune.paired_step_ms(lambda: seen.append("a"),
                              lambda: seen.append("b"), pairs=3)
    assert seen == ["a", "b"] * 3
    assert set(got) == {"a_ms", "b_ms", "delta_ms"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune.stats()["store"]["entries"] >= 0
