"""The port's compile store (``mxnet_tpu_torch.cache``: ``CompCacheStore``,
``AotFn``) against the JAX package's store discipline: atomic entries, two
writer processes racing on one key, the mtime GC evicting what the JAX
``CompCacheStore.gc`` evicts, a corrupt or foreign entry giving one
warning and a compile, ``AotFn`` keeping one program a signature, and one
cold/warm pair of processes compiling through Inductor on the CPU: the
warm one, with an empty local Inductor cache, reads the store and misses
nothing."""
import json
import os
import subprocess
import sys
import time
import warnings

import pytest
import torch

from mxnet_tpu.cache.store import CompCacheStore as JaxStore

from mxnet_tpu_torch import cache, engine
from mxnet_tpu_torch.cache import store as st
from torch_port_helpers import keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP = st.fingerprint("cpu")


@pytest.fixture
def store(tmp_path):
    s = cache.configure(str(tmp_path / "cc"))
    yield s
    cache.disable()


def test_store_is_off_by_default_and_configurable(tmp_path, monkeypatch):
    cache.disable()
    assert not cache.enabled() and cache.persistent_backed(abs) is None
    monkeypatch.setenv("MXNET_COMP_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cache, "_ENV_CHECKED", False)
    assert cache.active_store().directory == str(tmp_path / "env")
    fn = cache.persistent_backed(abs)
    assert isinstance(fn, cache.AotFn) and cache.traceable(fn) is abs
    cache.disable()
    assert cache.stats()["enabled"] is False


def test_atomic_entries_and_lookup_counters(store):
    h0, m0 = (engine.comp_cache_hit_counter.count,
              engine.comp_cache_miss_counter.count)
    assert store.lookup("aot", "k", FP) is None
    path = store.save("aot", "k", b"payload", FP)
    assert os.path.basename(path) == store.digest("k", FP) + ".mxc"
    assert [n for n in os.listdir(os.path.dirname(path))
            if n.endswith(".tmp")] == []
    assert store.lookup("aot", "k", FP) == b"payload"
    assert (engine.comp_cache_hit_counter.count - h0,
            engine.comp_cache_miss_counter.count - m0) == (1, 1)
    sc = store.scan()
    assert sc["entries"] == 1 and sc["tiers"]["aot"]["entries"] == 1
    assert cache.stats()["entries"] == 1
    with pytest.raises(ValueError, match="unknown compile-store tier"):
        store.entry_path("xla", "d")


_WRITER = r"""
import sys
from mxnet_tpu_torch.cache import store as st
s = st.CompCacheStore(sys.argv[1])
fp = st.fingerprint("cpu")
for i in range(200):
    s.save("aot", "same-key", b"x" * 4096 + sys.argv[2].encode(), fp)
"""


def test_two_writer_processes_racing_on_one_key(tmp_path):
    d = str(tmp_path / "race")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, d, w],
                              env=env, cwd=REPO) for w in ("a", "b")]
    assert [p.wait(timeout=30) for p in procs] == [0, 0]
    s = st.CompCacheStore(d)
    got = s.lookup("aot", "same-key", FP)
    assert got in (b"x" * 4096 + b"a", b"x" * 4096 + b"b")
    names = os.listdir(os.path.join(d, "aot"))
    assert len(names) == 1 and names[0].endswith(".mxc")


def _fill(d, layout):
    for tier, name, size, mtime in layout:
        os.makedirs(os.path.join(d, tier), exist_ok=True)
        p = os.path.join(d, tier, name + ".mxc")
        with open(p, "wb") as fh:
            fh.write(b"\0" * size)
        os.utime(p, (mtime, mtime))


def _left(d):
    return sorted("%s/%s" % (t, n) for t in ("jit", "tape")
                  if os.path.isdir(os.path.join(d, t))
                  for n in os.listdir(os.path.join(d, t)))


def test_gc_evicts_what_the_jax_store_evicts(tmp_path):
    t = time.time() - 1000
    layout = [("jit", "a", 100, t), ("jit", "b", 100, t),
              ("tape", "c", 100, t), ("jit", "d", 300, t + 5),
              ("tape", "e", 100, t + 1), ("tape", "f", 100, t),
              ("jit", "g", 50, t + 9)]
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    _fill(dj, layout)
    _fill(dp, layout)
    ej = JaxStore(dj, cap_bytes=400).gc()
    ep = st.CompCacheStore(dp, cap_bytes=400).gc()
    assert ep == ej and _left(dp) == _left(dj)
    assert sum(os.path.getsize(os.path.join(dp, x)) for x in _left(dp)) \
        <= 400


def test_corrupt_and_foreign_entries_warn_once_and_miss(store):
    path = store.save("aot", "k", b"good", FP)
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 2])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert store.lookup("aot", "k", FP) is None
    assert len(w) == 1 and "corrupt" in str(w[0].message)
    assert not os.path.exists(path) and store.corrupt == 1
    # another build's entry under this digest: one warning, removed
    with open(path, "wb") as fh:
        fh.write(st.pack_entry(store.digest("k", FP), b"x", FP + "|other"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert store.lookup("aot", "k", FP) is None
    assert len(w) == 1 and "was built by" in str(w[0].message)
    assert store.stale == 1


def test_aot_fn_keeps_one_program_a_signature(store):
    def f(x):
        return torch.tanh(x) * 2

    fn = cache.AotFn(f, backend="aot_eager", hint="tanh2")
    c0 = engine.aot_compile_counter.count
    a, b = torch.ones(3), torch.ones(4)
    for _ in range(3):
        assert torch.equal(fn(a), f(a)) and torch.equal(fn(b), f(b))
    assert fn.num_compiled() == 2 and len(fn.signatures()) == 2
    assert engine.aot_compile_counter.count - c0 == 2
    assert fn.compiled_for(fn.sig_of(a)) is not None
    fn.adopt(f, fn.sig_of(torch.ones(5)))
    assert fn.num_compiled() == 3
    c1 = engine.aot_compile_counter.count
    fn(torch.ones(5))
    assert engine.aot_compile_counter.count == c1  # adopted: no compile


def test_a_rejected_payload_warns_once_and_compiles(store):
    def f(x):
        return x + 1

    fn = cache.AotFn(f, backend="aot_eager", hint="plus1")
    key = fn.program_key(fn.sig_of(torch.ones(2)))
    store.save("aot", key, b"not an artifact bundle", FP)
    c0 = engine.aot_compile_counter.count
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert torch.equal(fn(torch.ones(2)), torch.full((2,), 2.0))
        fn(torch.ones(2))
    msgs = [str(x.message) for x in w if "compile store" in str(x.message)]
    assert len(msgs) == 1, msgs
    assert engine.aot_compile_counter.count - c0 == 1


_PAIR = r"""
import json, sys, time, torch
from torch._dynamo.utils import counters
import torch._inductor.config as inductor_config
from mxnet_tpu_torch import cache, engine
inductor_config.cpp.simdlen = 1  # no vector-ISA probe builds to wait on
cache.configure(sys.argv[1])
def f(x):
    return torch.sin(x) * 0.5 + 1.0
fn = cache.AotFn(f, backend="inductor", hint="pair")
x = torch.linspace(-1, 1, 64).reshape(8, 8)
t0 = time.perf_counter()
out = fn(x)
wall = time.perf_counter() - t0
saved = fn.persist()
print(json.dumps({"out": out.tolist(), "wall_s": wall,
                  "hits": engine.comp_cache_hit_counter.count,
                  "loaded": engine.comp_cache_deserialize_counter.count,
                  "saved": saved is not None,
                  "fx_hit": counters["inductor"]["fxgraph_cache_hit"],
                  "fx_miss": counters["inductor"]["fxgraph_cache_miss"]}))
"""


def test_cold_and_warm_inductor_processes(tmp_path):
    """The one Inductor pair (about 20 s cold and 15 s warm here): the
    warm process's local Inductor cache is empty, so its hit comes from
    the store."""
    d = str(tmp_path / "cc")
    runs = []
    for tag in ("cold", "warm"):
        env = dict(os.environ, PYTHONPATH=REPO,
                   TORCHINDUCTOR_CACHE_DIR=str(tmp_path / ("ind_" + tag)))
        r = subprocess.run([sys.executable, "-c", _PAIR, d], env=env,
                           cwd=REPO, capture_output=True, text=True,
                           timeout=250)
        assert r.returncode == 0, r.stderr[-3000:]
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert cold["saved"] and cold["hits"] == 0 and cold["fx_miss"] >= 1
    assert warm["hits"] == 1 and warm["loaded"] == 1
    assert warm["fx_miss"] == 0 and not warm["saved"]
    assert warm["out"] == cold["out"]
