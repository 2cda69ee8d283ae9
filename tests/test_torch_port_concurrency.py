"""racecheck, the port's copy (``analysis.concurrency``): the static rules
GL011-GL015 give the JAX package's findings on its planted fixtures, and
the blocking rule's torch hazards (``torch.cuda.synchronize``,
``Event.synchronize``, ``.item()`` under a lock) give GL013; over the
port's threading layers every finding is on the allowlist. The run-time
stage is off by default (``MXNET_LOCK_CHECK``, the JAX package's switch);
armed, it reports a lock-order cycle and an overlapping write, stays quiet
over serialized writers and over a ModelServer and a GenerativeServer
burst; a server registered under the check is armed at registration; and
arming that fails raises."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.analysis import graphlint as jgl
from mxnet_tpu_torch.analysis import concurrency as conc
from mxnet_tpu_torch.analysis import graphlint as gl
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "graphlint")
ALLOW = os.path.join(REPO, "tools", "torch_graphlint_allow.json")
RULES = ("GL011", "GL012", "GL013", "GL014", "GL015")
LAYERS = ("mxnet_tpu_torch/serve/batcher.py", "mxnet_tpu_torch/serve/"
          "decoder.py", "mxnet_tpu_torch/serve/server.py",
          "mxnet_tpu_torch/serve/fleet.py", "mxnet_tpu_torch/serve/"
          "worker.py", "mxnet_tpu_torch/observability",
          "mxnet_tpu_torch/engine.py", "mxnet_tpu_torch/profiler.py",
          "mxnet_tpu_torch/gluon/data")


def _markers(src):
    return {(i, line.split("# expect:")[1].strip())
            for i, line in enumerate(src.splitlines(), 1)
            if "# expect:" in line}


@pytest.mark.parametrize("rule", RULES)
def test_planted_fixtures_give_the_jax_ids(rule):
    path = os.path.join(FIXDIR, "%s_pos.py" % rule.lower())
    src = open(path).read()
    rel = os.path.relpath(path, REPO)
    mine = {(f.line, f.rule) for f in gl.lint_source(src, rel)
            if f.rule == rule}
    theirs = {(f.line, f.rule) for f in jgl.lint_source(src, rel)
              if f.rule == rule}
    # the JAX fixture's block_until_ready is JAX's name for a sync: the
    # port flags the rest of the fixture's lines, and torch's syncs below
    if rule == "GL013":
        jax_only = {(i, r) for i, r in theirs
                    if "block_until_ready" in src.splitlines()[i - 1]}
        theirs -= jax_only
    assert mine == theirs and mine, (mine, theirs)
    neg = path.replace("_pos", "_neg")
    assert [f for f in gl.lint_source(open(neg).read(), neg)
            if f.rule == rule] == []


def test_torch_syncs_under_a_lock_are_gl013():
    src = ("import threading\n"
           "import torch\n"
           "_LOCK = threading.Lock()\n"
           "def f(x, ev):\n"
           "    with _LOCK:\n"
           "        torch.cuda.synchronize()\n"
           "        ev.synchronize()\n"
           "        n = x.item()\n"
           "        m = torch.compile(f)\n"
           "    return n, m, x.item()\n")
    got = [(f.line, f.rule) for f in gl.lint_source(src, "p.py")
           if f.rule == "GL013"]
    assert got == [(6, "GL013"), (7, "GL013"), (8, "GL013"), (9, "GL013")]


def test_threading_layers_are_clean_against_the_allowlist():
    allow = gl.load_allowlist(ALLOW)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        found = [f for f in gl.lint_paths(list(LAYERS)) if f.rule in RULES]
    finally:
        os.chdir(cwd)
    kept, _, _ = gl.split_allowed(found, allow)
    assert kept == [], gl.format_findings(kept)


def _run_seeded(body):
    code = ("import json, threading, time\n"
            "from mxnet_tpu_torch.analysis import concurrency as conc\n"
            "conc.enable_lock_check(True)\n" + body)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_off_by_default():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MXNET_LOCK_CHECK", None)
    # the module is stdlib only: loaded alone, without the package
    code = ("import importlib.util as u; s = u.spec_from_file_location("
            "'c', %r); c = u.module_from_spec(s); s.loader.exec_module(c); "
            "print(c.lock_check_enabled())" % os.path.join(
                REPO, "mxnet_tpu_torch", "analysis", "concurrency.py"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=30)
    assert r.stdout.strip() == "False"
    env["MXNET_LOCK_CHECK"] = "1"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=30)
    assert r.stdout.strip() == "True"


def test_seeded_cycle_race_and_serialized_writers():
    stats = _run_seeded('''
A = conc.InstrumentedLock("fixture.A")
B = conc.InstrumentedLock("fixture.B")
def one():
    with A:
        with B:
            pass
def two():
    with B:
        with A:
            pass
for fn in (one, two):   # one after the other: no deadlock, still a cycle
    t = threading.Thread(target=fn)
    t.start()
    t.join()
conc.register_shared("fixture.table", sample=1)
bar = threading.Barrier(2)
def writer():
    bar.wait()
    with conc.shared_write("fixture.table"):
        time.sleep(0.2)
ts = [threading.Thread(target=writer) for i in range(2)]
for t in ts:
    t.start()
for t in ts:
    t.join()
conc.register_shared("fixture.safe", sample=1)
lk = threading.Lock()
def safe():
    for _ in range(200):
        with lk:
            with conc.shared_write("fixture.safe"):
                pass
ts = [threading.Thread(target=safe) for _ in range(2)]
for t in ts:
    t.start()
for t in ts:
    t.join()
print(json.dumps(conc.runtime_stats(verbose=True)))
''')
    (cyc,) = stats["cycles"]
    assert set(cyc["cycle"]) >= {"fixture.A", "fixture.B"}
    assert len(cyc["edges"]) == 2 and all(e["stack"] for e in
                                          cyc["edges"].values())
    assert [r["shared"] for r in stats["races"]] == ["fixture.table"]
    assert "fixture.safe" not in stats["race_hits"]


def test_armed_servers_burst_clean_and_armed_at_registration():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.gpt import gpt_nano
    from mxnet_tpu_torch.serve import GenerativeServer, ModelServer

    prev = conc.enable_lock_check(True)
    conc.reset_runtime()
    try:
        conc.instrument_locks()
        with mx.cpu():
            net = mx.gluon.nn.Dense(3, in_units=4)
            net.initialize()
            srv = ModelServer(net, [((4,), "float32")], buckets=(1, 4))
            assert isinstance(srv._batcher._cond,
                              conc.InstrumentedCondition)
            assert isinstance(srv._batch_lock, conc.InstrumentedLock)
            with srv:
                hs = [srv.submit(np.ones(4, np.float32)) for _ in range(12)]
                for h in hs:
                    h.result(timeout_s=30)
            gpt = gpt_nano()
            gpt.initialize()
            gen = GenerativeServer(gpt, slots=2)
            assert isinstance(gen._join_cond, conc.InstrumentedCondition)
            with gen:
                ss = [gen.submit(np.arange(3 + i, dtype=np.int32),
                                 max_new_tokens=3) for i in range(4)]
                for s in ss:
                    s.result(timeout_s=60)
        stats = conc.runtime_stats()
        assert stats["cycles"] == [] and stats["races"] == []
        assert stats["graph_nodes"] > 0
        assert {"serve.batcher_queue", "serve.kv_slots",
                "serve.metrics_rings"} <= set(stats["watched"])
        snap = __import__("mxnet_tpu_torch").observability.snapshot()
        assert snap["concurrency"]["enabled"] is True
    finally:
        conc.reset_runtime()
        conc.enable_lock_check(prev)


def test_arming_error_raises():
    class Broken:
        name = "broken"
        _batcher = None  # no batcher: arming cannot proceed

    with pytest.raises(AttributeError):
        conc.instrument_server(Broken())
