"""The port's graph IR (``mxnet_tpu_torch.ir``) against the JAX package's
(``mxnet_tpu.ir``), in process: the JAX tests' hand-built graphs (the MLP,
a duplicate subexpression, a constant island, a dead branch, a bf16 round
trip) go through both packages' pass pipelines with the same per-pass
node and edge deltas and outputs within 1e-6 (fp32) or 0.05 (bf16); the
bulk window and a ``Symbol.eval`` of the same math share one build and
one program ("2 captures, 1 build": the port's tape runs recorded ops one
by one, so it has no forward region to share); stochastic and
control-flow graphs keep their own paths; the tape's compiled backward is
keyed by ``from_fx``; canonical keys are equal across two processes; the
watchdog sees nothing in steady state; a 2-layer BERT exported and
evaluated through each package's lowering agrees within 1e-4."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.ir as jir
from mxnet_tpu.base import OP_REGISTRY as JREG
from mxnet_tpu.base import _freeze as jfreeze
from mxnet_tpu.ir import graph as jgraph
from mxnet_tpu.ir import passes as jpasses

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, base, engine, ir, nd
from mxnet_tpu_torch import symbol as S
from mxnet_tpu_torch.base import OP_REGISTRY as PREG
from mxnet_tpu_torch.ir import graph as pgraph
from mxnet_tpu_torch.ir import lower, passes
from mxnet_tpu_torch.observability import costs, watchdog
from torch_port_helpers import (jax_params, jax_trace_state,  # noqa: F401
                                keep_block_names)

pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mx.cpu()
PASSES = ("cse", "fold", "cast_sink", "dce")


def _reset():
    base._IR_CACHE.clear()
    lower.reset_stats()
    for c in (engine.bulk_compile_counter, engine.symbol_compile_counter,
              engine.tape_compile_counter):
        c.reset()


# ------------------------------------------------- the hand-built graphs
class _Side:
    """One package's builder pieces: registry functions, signatures and
    the frozen attrs, so one recipe builds the same graph in both."""

    def __init__(self, which):
        self.which = which
        self.ir = jir if which == "jax" else ir

    def fn(self, op):
        return JREG[op].fn if self.which == "jax" else PREG[op]

    def sig(self, shape, dt):
        if self.which == "jax":
            return jgraph._sig_id((np.dtype(dt), tuple(shape)))
        t = torch.empty(shape, dtype=getattr(torch, dt))
        return pgraph._sig_id(pgraph.tensor_sig(t))

    def freeze(self, attrs):
        return jfreeze(attrs) if self.which == "jax" else \
            pgraph.freeze_attrs(attrs)

    def node(self, b, op, specs, **attrs):
        return b.add(op, self.fn(op), attrs, self.freeze(attrs), specs)


def _mlp(sd):
    b = sd.ir.GraphBuilder()
    x = b.leaf("x", sig_id=sd.sig((4, 8), "float32"))
    w1 = b.leaf("w1", sig_id=sd.sig((8, 16), "float32"))
    b1 = b.leaf("b1", sig_id=sd.sig((16,), "float32"))
    w2 = b.leaf("w2", sig_id=sd.sig((16, 3), "float32"))
    b2 = b.leaf("b2", sig_id=sd.sig((3,), "float32"))
    a = sd.node(b, "matmul", (x, w1))
    c = sd.node(b, "add", (a, b1))
    r = sd.node(b, "relu", (c,))
    d = sd.node(b, "matmul", (r, w2))
    e = sd.node(b, "add", (d, b2))
    return b.build((a, c, r, d, e)), [(4, 8), (8, 16), (16,), (16, 3), (3,)]


def _duplicate(sd):
    b = sd.ir.GraphBuilder()
    x = b.leaf("x", sig_id=sd.sig((4,), "float32"))
    a = b.leaf("a", sig_id=sd.sig((4,), "float32"))
    n1 = sd.node(b, "multiply", (x, a))
    n2 = sd.node(b, "tanh", (n1,))
    n3 = sd.node(b, "multiply", (x, a))
    n4 = sd.node(b, "tanh", (n3,))
    return b.build((sd.node(b, "add", (n2, n4)),)), [(4,), (4,)]


def _constant_island(sd):
    b = sd.ir.GraphBuilder()
    x = b.leaf("x", sig_id=sd.sig((4,), "float32"))
    c2 = sd.node(b, "_const", (), value=2.0)
    c3 = sd.node(b, "_const", (), value=3.0)
    s = sd.node(b, "add", (c2, c3))
    return b.build((sd.node(b, "multiply", (x, s)),)), [(4,)]


def _dead_branch(sd):
    b = sd.ir.GraphBuilder()
    x = b.leaf("x", sig_id=sd.sig((4,), "float32"))
    a = b.leaf("a", sig_id=sd.sig((4,), "float32"))
    live = sd.node(b, "tanh", (x,))
    dead = sd.node(b, "multiply", (x, a))
    sd.node(b, "tanh", (dead,))
    return b.build((live,)), [(4,), (4,)]


def _bf16_round_trip(sd):
    b = sd.ir.GraphBuilder()
    x = b.leaf("x", sig_id=sd.sig((8, 8), "bfloat16"))
    up = sd.node(b, "cast", (x,), dtype="float32")
    down = sd.node(b, "cast", (up,), dtype="bfloat16")
    return b.build((sd.node(b, "tanh", (down,)),)), [(8, 8)]


GRAPHS = {"mlp": _mlp, "duplicate": _duplicate,
          "constant_island": _constant_island, "dead_branch": _dead_branch,
          "bf16_round_trip": _bf16_round_trip}


def _run_pipeline(sd, graph):
    mod = jpasses if sd.which == "jax" else passes
    before = {k: dict(v) for k, v in mod.PASS_STATS.items()}
    final = sd.ir.PassManager(PASSES).run(graph)
    deltas = {p: tuple(mod.PASS_STATS[p][f] - before[p][f]
                       for f in ("nodes_removed", "edges_removed",
                                 "rewrites")) for p in PASSES}
    return final, deltas


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pass_deltas_and_outputs_equal_the_jax_packages(name):
    import jax.numpy as jnp

    jg, shapes = GRAPHS[name](_Side("jax"))
    pg, _ = GRAPHS[name](_Side("port"))
    jfinal, jd = _run_pipeline(_Side("jax"), jg)
    pfinal, pd = _run_pipeline(_Side("port"), pg)
    assert pd == jd, (pd, jd)
    assert (pfinal.n_nodes, pfinal.n_edges, len(pfinal.leaf_sigs)) == \
        (jfinal.n_nodes, jfinal.n_edges, len(jfinal.leaf_sigs))
    rng = np.random.default_rng(3)
    bf16 = name == "bf16_round_trip"
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    # the pipelines keep the same leaves (DCE drops the same ones)
    jl = [jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32)
          for v in leaves][:len(jfinal.leaf_sigs)]
    pl = [torch.from_numpy(v).to(torch.bfloat16 if bf16 else torch.float32)
          for v in leaves][:len(pfinal.leaf_sigs)]
    jout = jir.build_runner(jfinal)(jl)
    pout = ir.build_runner(pfinal)(pl)
    for a, b in zip(jout, pout):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   b.float().numpy(),
                                   atol=0.05 if bf16 else 1e-6,
                                   rtol=0 if bf16 else 1e-6)


def test_donation_is_not_applicable_and_names_match_the_jax_ir():
    assert passes.DEFAULT_PASSES == tuple(
        p for p in jpasses.DEFAULT_PASSES if p != "donation")
    with pytest.raises(ValueError, match="not applicable, because torch "
                                         "has no buffer donation"):
        ir.PassManager(("cse", "donation"))
    assert set(jir.__all__) <= set(ir.__all__)
    for n in jir.__all__:
        assert hasattr(ir, n), n


def test_to_fx_runs_as_the_runner():
    g, shapes = _mlp(_Side("port"))
    rng = np.random.default_rng(4)
    vals = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in shapes]
    gm = ir.to_fx(g)
    for a, b in zip(gm(*vals), ir.build_runner(g)(vals)):
        assert torch.equal(a, b)
    assert "matmul" in gm.code


# ------------------------------------------------------- the captures
def _mlp_arrays(rng):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((4, 8), (8, 16), (16,), (16, 3), (3,))]


def _mlp_nd(x, w1, b1, w2, b2):
    a = x @ w1
    b = a + b1
    c = b.relu()
    d = c @ w2
    e = d + b2
    return [a, b, c, d, e]


def _mlp_sym():
    vs = {n: S.var(n) for n in ("x", "w1", "b1", "w2", "b2")}
    sa = S.Symbol("matmul", [vs["x"], vs["w1"]], {})
    sb = S.Symbol("add", [sa, vs["b1"]], {})
    sc = S.Symbol("relu", [sb], {})
    sd = S.Symbol("matmul", [sc, vs["w2"]], {})
    se = S.Symbol("add", [sd, vs["b2"]], {})
    return S.Group([sa, sb, sc, sd, se])


def test_two_captures_one_build():
    _reset()
    rng = np.random.default_rng(0)
    arrs = _mlp_arrays(rng)
    nds = [nd.array(a, ctx=CPU) for a in arrs]
    with engine.bulk(32):
        keep = _mlp_nd(*nds)
        r_bulk = keep[-1].asnumpy()
    outs = _mlp_sym().eval(**dict(zip(("x", "w1", "b1", "w2", "b2"),
                                      arrs)))
    np.testing.assert_array_equal(outs[-1].asnumpy(), r_bulk)
    with engine.bulk(0):
        ref = _mlp_nd(*nds)[-1].asnumpy()
    np.testing.assert_array_equal(r_bulk, ref)
    assert engine.bulk_compile_counter.count + \
        engine.symbol_compile_counter.count == 1
    assert lower.program_count() == 1
    assert len(base._IR_CACHE) == 1


def test_executor_inference_forward_lowers_and_shares_the_program():
    _reset()
    rng = np.random.default_rng(1)
    arrs = dict(zip(("x", "w1", "b1", "w2", "b2"), _mlp_arrays(rng)))
    g = _mlp_sym()
    want = [o.asnumpy() for o in g.eval(**arrs)]
    ex = g.bind(ctx=CPU, args={k: nd.array(v, ctx=CPU)
                               for k, v in arrs.items()})
    got = [o.asnumpy() for o in ex.forward(is_train=False)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert engine.symbol_compile_counter.count == 1
    assert lower.program_count() == 1
    assert ex.stats["forward_captures"] == 1


def test_stochastic_and_control_flow_symbols_keep_their_paths():
    X = np.random.default_rng(2).normal(size=(64, 64)).astype(np.float32)
    y = S.Symbol("Dropout", [S.var("x")], {"p": 0.5, "training": True})
    out = y.eval(x=X)[0].asnumpy()
    assert y.__dict__["_ir_skel"] is False
    assert out.shape == X.shape and (out == 0).any()
    with pytest.raises(ir.UnsupportedGraph):
        ir.symbol_skeleton([y])
    x = S.var("x")
    v = X[0, :4]
    c = S.cond(S.Symbol("sum", [x], {}) > 0, x * 2.0, x * 3.0)
    got = c.eval(x=v)[0].asnumpy()
    np.testing.assert_allclose(got, v * (2.0 if v.sum() > 0 else 3.0),
                               rtol=1e-6)
    assert c.__dict__["_ir_skel"] is False
    # CSE never merges two draws
    b = ir.GraphBuilder()
    lx = b.leaf("x", sig=pgraph.tensor_sig(torch.ones(4)))
    d1 = b.add("Dropout", PREG["Dropout"], {"p": 0.5, "training": True},
               (), (lx,))
    d2 = b.add("Dropout", PREG["Dropout"], {"p": 0.5, "training": True},
               (), (lx,))
    g = b.build((b.add("add", PREG["add"], {}, (), (d1, d2)),))
    assert ir.PassManager(("cse", "dce")).run(g).n_nodes == 3


def test_tape_program_is_keyed_by_from_fx():
    costs.reset()
    prev = autograd.set_tape_compile(True, cpu_backend="aot_eager")
    try:
        x = nd.array(np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
                     ctx=CPU)
        x.attach_grad()
        counts = []
        for _ in range(2):
            engine.tape_compile_counter.reset()
            with autograd.record():
                loss = ((x * x).tanh() * 2.0).sum()
            loss.backward()
            counts.append(engine.tape_compile_counter.count)
        key = autograd._st.tape_ir_key
    finally:
        autograd.set_tape_compile(prev, cpu_backend="")
    np.testing.assert_allclose(
        x.grad.asnumpy(), 2 * (1 - np.tanh(x.asnumpy() ** 2) ** 2) * 2 *
        x.asnumpy(), rtol=1e-5, atol=1e-6)
    assert counts == [1, 0]
    ent = base._IR_CACHE[key]
    assert isinstance(ent, lower.IREntry)
    assert ("tape", "aot_eager") in ent.programs
    assert ent.nodes_final == ent.nodes_canonical  # no pass ran
    prof = costs.profiles()["tape_compile:%s" % key[:16]]
    assert not prof["counted"] and prof["reason"]


_KEY_SCRIPT = r"""
import numpy as np, torch
from mxnet_tpu_torch import engine, nd, symbol as S, base, ir
from mxnet_tpu_torch.ir import graph as g
import mxnet_tpu_torch as mx
rng = np.random.default_rng(0)
arrs = [rng.normal(size=s).astype(np.float32)
        for s in ((4, 8), (8, 16), (16,), (16, 3), (3,))]
vs = {n: S.var(n) for n in ("x", "w1", "b1", "w2", "b2")}
sa = S.Symbol("matmul", [vs["x"], vs["w1"]], {})
sb = S.Symbol("add", [sa, vs["b1"]], {})
sc = S.Symbol("relu", [sb], {})
sd = S.Symbol("matmul", [sc, vs["w2"]], {})
se = S.Symbol("add", [sd, vs["b2"]], {})
grp = S.Group([sa, sb, sc, sd, se])
grp.eval(**dict(zip(("x", "w1", "b1", "w2", "b2"), arrs)))
print(sorted(base._IR_CACHE)[0])
"""


def test_canonical_keys_are_equal_across_processes():
    _reset()
    rng = np.random.default_rng(0)
    arrs = _mlp_arrays(rng)
    _mlp_sym().eval(**dict(zip(("x", "w1", "b1", "w2", "b2"), arrs)))
    (here,) = list(base._IR_CACHE)
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="123")
    r = subprocess.run([sys.executable, "-c", _KEY_SCRIPT], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=40)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == here


def test_zero_retrace_in_steady_state_with_the_watchdog_armed():
    rng = np.random.default_rng(5)
    arrs = _mlp_arrays(rng)
    nds = [nd.array(a, ctx=CPU) for a in arrs]
    grp = _mlp_sym()
    feed = dict(zip(("x", "w1", "b1", "w2", "b2"), arrs))
    xg = nd.array(arrs[0], ctx=CPU)
    xg.attach_grad()

    def step():
        with engine.bulk(32):
            keep = _mlp_nd(*nds)
            keep[-1].asnumpy()
        grp.eval(**feed)
        with autograd.record():
            loss = (xg * xg).sum()
        loss.backward()

    step()
    watchdog.reset_events()
    watchdog.arm()
    try:
        for _ in range(3):
            step()
        assert len(watchdog.events) == 0, watchdog.events
    finally:
        watchdog.disarm()
        watchdog.reset_events()


def test_bert_export_through_each_packages_lowering(tmp_path,
                                                    jax_trace_state):
    from mxnet_tpu.models.bert import BERTModel as JaxBERT
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.bert import BERTModel
    from mxnet_tpu_torch.util import load_npz_exact

    cfg = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
               num_heads=2, max_length=16, dropout=0.0)
    names = ["data", "tt", "vl"]
    shapes = [(2, 16), (2, 16), (2,)]
    jnet = JaxBERT(**cfg)
    jnet.initialize()
    rng = np.random.RandomState(7)
    tok = rng.randint(0, 100, (2, 16)).astype(np.int32)
    tt = rng.randint(0, 2, (2, 16)).astype(np.int32)
    vl = np.array([16, 9], np.int32)
    jnet(*(jmx.nd.array(a, dtype="int32") for a in (tok, tt, vl)))
    pnet = from_jax_params(BERTModel(**cfg), jax_params(jnet))
    jnet.export(str(tmp_path / "jax"), 0, input_names=names,
                input_shapes=shapes)
    pnet.export(str(tmp_path / "port"), 0, input_names=names,
                input_shapes=shapes)
    feed = dict(zip(names, (tok, tt, vl)))
    jsym = jmx.symbol.load(str(tmp_path / "jax-symbol.json"))
    jfeed = dict(feed, **{k: v.numpy() for k, v in load_npz_exact(
        str(tmp_path / "jax-0000.params")).items()})
    jout = [np.asarray(o.asnumpy()) for o in jsym.eval(**{
        k: v for k, v in jfeed.items() if k in jsym.list_arguments()})]
    from mxnet_tpu import symbol as jS

    assert jS._ir_skeleton_of(jsym) is not False  # the JAX IR's lowering
    _reset()
    psym = S.load(str(tmp_path / "port-symbol.json"))
    pfeed = dict({k: torch.from_numpy(v) for k, v in feed.items()},
                 **load_npz_exact(str(tmp_path / "port-0000.params")))
    pout = [o.asnumpy() for o in psym.eval(**{
        k: v for k, v in pfeed.items() if k in psym.list_arguments()})]
    assert psym.__dict__["_ir_skel"] is not False
    assert engine.symbol_compile_counter.count == 1
    assert len(jout) == len(pout)
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
