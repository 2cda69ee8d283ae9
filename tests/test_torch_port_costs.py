"""``observability.costs``: each program the port builds counted once on
its first run (on the CPU, the eager run under the same key), against the
JAX package's ``cost_analysis``. Rules of the port (C.2), pinned here:
``FlopCounterMode`` counts products only (mm, bmm, addmm, convolution,
attention), so flops equal XLA's exactly on a program of products and
fall short of them by the elementwise share elsewhere; ``bytes`` is the
per-op sum over the unfused program; ``peak_bytes`` is None on the CPU;
the flash ops count torch's SDPA flops; ``MXNET_COST_ATTRIBUTION=0``
turns counting off."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.observability import costs as jcosts
from mxnet_tpu_torch import observability
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.observability import costs
from torch_port_helpers import (SMALL_BERT, bert_inputs,  # noqa: F401
                                jax_bert, jax_params, jax_trace_state,
                                port_bert_from)
from torch_port_helpers import keep_block_names  # noqa: F401

# block names made here do not shift the names later tests compare
pytestmark = pytest.mark.usefixtures("keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh():
    costs.reset()
    prev = costs.set_enabled(True)
    yield
    costs.set_enabled(prev)
    costs.reset()


def _jax_new(run):
    jcosts.materialize()
    before = set(jcosts.profiles())
    run()
    jcosts.materialize()
    return [p for k, p in jcosts.profiles().items() if k not in before]


def _chain(pkg):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, in_units=16, use_bias=False))
        net.add(pkg.gluon.nn.Dense(24, in_units=32, use_bias=False))
        net.add(pkg.gluon.nn.Dense(8, in_units=24, use_bias=False))
    return net


def _conv(pkg):
    return pkg.gluon.nn.Conv2D(8, 3, in_channels=4, use_bias=False)


@pytest.mark.parametrize("make,shape", [(_chain, (4, 16)),
                                        (_conv, (2, 4, 10, 10))],
                         ids=["dense_chain", "conv"])
def test_products_equal_xla_flops(jax_trace_state, make, shape):
    jnet = make(jmx)
    jnet.initialize()
    jnet.hybridize()
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    (jp,) = _jax_new(lambda: jnet(jmx.nd.array(x)).asnumpy())
    tnet = from_jax_params(make(mx), jax_params(jnet))
    tnet.hybridize()
    got = tnet(torch.from_numpy(x))
    (tp,) = costs.profiles().values()
    assert tp["tier"] == "hybrid_capture" and tp["counted"]
    assert tp["flops"] == jp["flops"] > 0
    np.testing.assert_allclose(got.detach().numpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_bert_small_within_the_elementwise_share(jax_trace_state):
    """BERT-small (2 layers, 128 units, 2 heads, FFN 256) at batch 4, seq
    64: the port counts the products exactly (the analytic count); XLA
    also counts the elementwise ops (GELU, LayerNorm, softmax, the
    residual adds, the masks): 12,406,560 flops, 7.6% of its count. The
    stated bound of that share is 10%."""
    jm = jax_bert(False)
    jm.hybridize()
    tok, tt, vl = bert_inputs(0, 4)
    (jp,) = _jax_new(lambda: jm(*[jmx.nd.array(a, dtype="int32")
                                  for a in (tok, tt, vl)])[0].asnumpy())
    tm = port_bert_from(jm)
    tm.hybridize()
    tm(*[torch.from_numpy(a) for a in (tok, tt, vl)])
    (tp,) = costs.profiles().values()
    U, H, L, T, B = 128, 256, 2, 64, 4
    per_token = L * 2 * (4 * U * U + 2 * U * H) + L * 2 * 2 * T * U
    analytic = B * T * per_token + B * 2 * U * U + B * 2 * U * 2
    assert tp["flops"] == analytic
    share = (jp["flops"] - tp["flops"]) / jp["flops"]
    assert 0 < share <= 0.10, share


def test_op_record_key_bytes_and_histogram():
    """The key is over the op record; bytes are the per-op sum (views
    excluded); an elementwise program counts zero flops; peak_bytes is None
    on the CPU; a second run of the key counts nothing new."""
    a = torch.ones(8, 8)
    m = costs.meter("bulk_compile", "probe", "cpu")
    out = costs.run_counted(m, lambda: (a * 2.0 + 1.0).view(64))
    assert out.shape == (64,)
    (p,) = costs.profiles().values()
    assert p["flops"] == 0 and p["peak_bytes"] is None
    assert p["ops"] == {"aten.add.Tensor": 1, "aten.mul.Tensor": 1,
                        "aten.view.default": 1}
    # mul: in 256 + out 256; add: in 256 + out 256 (scalars are no tensor)
    assert p["bytes"] == 4 * 256
    costs.run_counted(m, lambda: a * 3.0)  # done: not counted again
    assert len(costs.profiles()) == 1
    m2 = costs.meter("bulk_compile", "probe again", "cpu")
    costs.run_counted(m2, lambda: (a * 2.0 + 1.0).view(64))
    assert list(costs.profiles().values())[0]["builds"] == 2
    with pytest.raises(ValueError):
        costs.meter("jit", "no such tier", "cpu")


def test_flash_op_counts_sdpa_flops():
    """The flash forward counts torch's SDPA formula, 4 B H Tq Tk D, the
    backward 2.5 times that. (On the CPU torch's own SDPA takes a route
    ``FlopCounterMode`` has no formula for; the card's phase_costs holds
    the op against SDPA there.)"""
    from torch.utils.flop_counter import (FlopCounterMode, sdpa_flop_count,
                                          sdpa_backward_flop_count)

    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_bwd)

    q, k, v = (torch.randn(2, 3, 16, 8) for _ in range(3))
    costs.register_kernel_flops()
    with FlopCounterMode(display=False) as fc:
        o, lse = flash_attention(q, k, v, return_lse=True)
    shape = tuple(q.shape)
    assert fc.get_total_flops() == sdpa_flop_count(shape, shape, shape) \
        == 4 * 2 * 3 * 16 * 16 * 8
    # without grad mode the backward is the kernel's op, as on the card
    with torch.no_grad(), FlopCounterMode(display=False) as fb:
        flash_attention_bwd(q, k, v, torch.ones_like(o), lse,
                            (o * torch.ones_like(o)).sum(-1))
    assert fb.get_total_flops() == sdpa_backward_flop_count(
        shape, shape, shape, shape) == 10 * 2 * 3 * 16 * 16 * 8
    # a planted fault: without the formula the kernel op counts nothing
    assert costs.unregister_kernel_flops() == 3
    try:
        with FlopCounterMode(display=False) as f0:
            flash_attention(q, k, v)
        assert f0.get_total_flops() == 0
    finally:
        assert costs.register_kernel_flops() == 3


def test_tiers_record_profiles():
    """A served bucket, a decode step, a bulk window, a tape backward, a
    Symbol executor, a hybrid forward and the optimizer's step program
    each land a profile under its tier."""
    from mxnet_tpu_torch import autograd, engine, nd, sym
    from mxnet_tpu_torch.models.gpt import gpt_nano
    from mxnet_tpu_torch.serve import GenerativeServer, ModelServer

    with mx.cpu():
        net = _chain(mx)
        net.initialize()
        net.hybridize()
        srv = ModelServer(net, [((16,), "float32")], buckets=(2,))
        srv.stop()
        gpt = gpt_nano()
        gpt.initialize()
        gen = GenerativeServer(gpt, slots=1)
        with gen:
            gen.submit(np.arange(4, dtype=np.int32),
                       max_new_tokens=2).result(timeout_s=60)
        with engine.bulk(8):
            a = nd.array(np.ones((4, 4), np.float32))
            ((a * 2.0 + 1.0) * a).asnumpy()
        x = nd.array(np.ones((3, 16), np.float32))
        tr = mx.gluon.Trainer(net.collect_params(), "sgd")
        with autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(1)  # the hybridized block's parameters: a step program
        prev = autograd.set_tape_compile(True)
        try:  # the tape replay's counted route (the CPU's)
            w = nd.array(np.ones((4, 4), np.float32))
            w.attach_grad()
            with autograd.record():
                loss = ((w * 2.0) ** 2).sum()
            loss.backward()
        finally:
            autograd.set_tape_compile(prev)
        s = sym.FullyConnected(sym.var("data"), num_hidden=3,
                               no_bias=True, name="fc")
        ex = s.simple_bind(mx.cpu(), data=(2, 4))
        ex.forward(is_train=False, data=np.ones((2, 4), np.float32))
    tiers = {p["tier"] for p in costs.profiles().values()}
    assert {"serve_capture", "decode_capture", "bulk_compile",
            "tape_compile", "symbol_compile", "hybrid_capture",
            "step_program"} <= tiers, tiers
    for key, p in costs.profiles().items():
        assert key == "%s:%s" % (p["tier"], p["key"]) and len(p["key"]) == 16
        assert p["counted"] and p["bytes"] > 0 and p["peak_bytes"] is None


def test_ledgers_snapshot_and_prometheus():
    from mxnet_tpu_torch.models.gpt import gpt_nano
    from mxnet_tpu_torch.serve import GenerativeServer

    with mx.cpu():
        rows = {}
        for q in (None, "int8"):
            gpt = gpt_nano()
            gpt.initialize()
            gpt.cast("bfloat16")
            gen = GenerativeServer(gpt, slots=2, quantize=q,
                                   name="gen:ledger-%s" % q)
            with gen:
                gen.submit(np.arange(5, dtype=np.int32),
                           max_new_tokens=2).result(timeout_s=60)
            rows[q] = costs.hbm_ledger()["servers"][gen.name]
            gen.stop()
        net = _chain(mx)
        net.initialize()
        tr = mx.gluon.Trainer(net.collect_params(), "adam")
        with mx.autograd.record():
            loss = (net(mx.nd.array(np.ones((2, 16), np.float32)))
                    ** 2).sum()
        loss.backward()
        tr.step(1)
        trow = costs.trainer_ledger(tr)
    assert rows["int8"]["kv_cache_bytes"] < rows[None]["kv_cache_bytes"]
    assert rows[None]["params_bytes"] > 0
    assert rows[None]["program_peak_bytes"] is None  # the CPU
    n = sum(p._data.numel() for p in net.collect_params().values())
    assert trow["params_bytes"] == trow["grads_bytes"] == 4 * n
    assert trow["optimizer_state_bytes"] == 2 * 4 * n  # Adam's m and v
    snap = observability.snapshot()
    assert snap["costs"]["enabled"] and snap["costs"]["profiles"]
    assert snap["not_ported"] == {}
    assert {"costs", "concurrency", "hlolint", "ir", "comp_cache"} <= \
        set(snap)
    text = observability.prometheus()
    key = next(iter(snap["costs"]["profiles"]))
    assert 'program="%s"' % key in text


def test_kill_switch_and_keys_across_processes():
    """``MXNET_COST_ATTRIBUTION=0`` counts nothing; the same program gets
    the same key in another process."""
    code = ("import json, numpy as np, torch\n"
            "import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.observability import costs\n"
            "net = mx.gluon.nn.HybridSequential()\n"
            "with net.name_scope():\n"
            "    net.add(mx.gluon.nn.Dense(32, in_units=16))\n"
            "    net.add(mx.gluon.nn.Dense(8, in_units=32))\n"
            "net.initialize(ctx=mx.cpu())\n"
            "net.hybridize()\n"
            "net(torch.ones(4, 16))\n"
            "print('KEYS=' + json.dumps(sorted(costs.profiles())))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = {}
    for flag in ("1", "0"):
        env["MXNET_COST_ATTRIBUTION"] = flag
        r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=45)
        assert r.returncode == 0, r.stderr[-2000:]
        runs[flag] = json.loads([l for l in r.stdout.splitlines()
                                 if l.startswith("KEYS=")][-1][5:])
    assert runs["0"] == []
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, in_units=16))
        net.add(mx.gluon.nn.Dense(8, in_units=32))
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(torch.ones(4, 16))
    assert sorted(costs.profiles()) == runs["1"] and len(runs["1"]) == 1
    costs.set_enabled(False)
    costs.reset()
    net.hybridize()  # drops the programs: a new key, not counted
    net(torch.ones(4, 16))
    assert costs.profiles() == {}


def test_uncounted_program_says_why():
    p = costs.note_uncounted("tape_compile", "tape[compiled]", ("k", 1),
                             "built by torch.compile")
    d = costs.profiles()["tape_compile:%s" % p.key]
    assert d["counted"] is False and d["reason"]
    assert d["flops"] is None and d["bytes"] is None
    sec = costs.snapshot_section()
    assert sec["totals"]["tape_compile"]["uncounted"] == 1
