"""The decode step's programs (``serve/step_graph.py``) on the CPU, where
the same program object runs the step eagerly: one program per
("decode", capacity, sampling) key, quantized or not, and none made in steady state, one
replay a decode tick, every program dropped and made again when a
capacity migration moves the pages, a weight swap that writes into the
live parameter tensors (their addresses kept, the next step on the new
weights), the eager step equal to the program's, and greedy streams still
the JAX server's. A CUDA graph itself is captured and checked against the
eager step on the card, by ``chip_smoke.py``."""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch.serve import GenerativeServer
from mxnet_tpu_torch.serve.step_graph import StepPrograms
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_trace_state_module, port_gpt_from)

NEW = 6
LENGTHS = (3, 17, 9)


@pytest.fixture(scope="module")
def shared(jax_trace_state_module):  # noqa: F811
    jm = jax_gpt(False)
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, SMALL_GPT["vocab_size"], n).astype(np.int32)
               for n in LENGTHS]
    with mx.serve.GenerativeServer(jm, slots=2, timeout_ms=600000.0) as jsrv:
        want = [h.result(600) for h in [jsrv.submit(p, max_new_tokens=NEW)
                                        for p in prompts]]
    return {"prompts": prompts, "want": want, "port_model": port_gpt_from(jm),
            "jax_model": jm}


def _server(model, **kw):
    kw.setdefault("timeout_ms", 600000.0)
    return GenerativeServer(model, device="cpu", **kw)


def _pump(srv, streams, ticks=200):
    for _ in range(ticks):
        srv.step()
        if all(s.done() for s in streams):
            return
        time.sleep(0.002)
    raise AssertionError("streams did not finish in %d ticks" % ticks)


def _join(srv, prompt, **kw):
    s = srv.submit(prompt, max_new_tokens=kw.pop("n", NEW), **kw)
    for _ in range(100):
        if srv._join_q:
            break
        time.sleep(0.002)
    return s


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_one_program_per_key_and_none_made_in_steady_state(shared, quantize):
    srv = _server(shared["port_model"], slots=2, quantize=quantize)
    srv.warmup(max_tokens=16)
    steps = srv._steps
    # warmup makes the greedy and the sampled program at capacity 16
    assert sorted(steps.keys()) == [("decode", 16, False),
                                    ("decode", 16, True)]
    assert steps.captures == 2 and steps.replays == 2
    s = _join(srv, shared["prompts"][0])
    _pump(srv, [s])
    ticks = srv.stats()["decode_steps"] - 2
    assert steps.captures == 2, "a steady-state tick made a program"
    assert steps.replays == 2 + ticks and ticks == NEW - 1
    # a sampled request takes the sampled program, made already
    s = _join(srv, shared["prompts"][2], temperature=0.7, seed=3)
    _pump(srv, [s])
    assert steps.captures == 2 and steps.drops == 0
    stats = srv.stats()
    assert (stats["step_programs"], stats["step_captures"]) == (2, 2)
    assert stats["step_replays"] == stats["decode_steps"]
    srv.stop()


def test_a_migration_drops_and_remakes_the_programs(shared):
    """A 17-token prompt needs bucket 32: the pages move, the programs of
    bucket 16 go, and the next tick makes the program of bucket 32; the
    short stream in flight is undisturbed."""
    srv = _server(shared["port_model"], slots=2)
    s1 = _join(srv, shared["prompts"][0])
    srv.step()
    steps = srv._steps
    assert steps.keys() == [("decode", 16, False)] and steps.captures == 1
    s2 = _join(srv, shared["prompts"][1])
    _pump(srv, [s1, s2])
    assert srv.cache.migrations == 1 and steps.drops == 1
    assert steps.keys() == [("decode", 32, False)] and steps.captures == 2
    assert s1.result(1) == shared["want"][0]
    assert s2.result(1) == shared["want"][1]
    srv.stop()


def test_swap_writes_into_the_live_parameters(shared, tmp_path):
    """swap_parameters keeps every parameter's storage (a captured graph
    holds it), drops no program, and the next step runs the new weights:
    the stream becomes the second model's."""
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.gpt import GPTModel
    from torch_port_helpers import jax_params

    model = from_jax_params(GPTModel(**SMALL_GPT),
                            jax_params(shared["jax_model"]))
    other = GPTModel(**SMALL_GPT)
    other.initialize(device="cpu",
                     generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "other.params")
    other.save_parameters(path)
    srv = _server(model, slots=2)
    p = shared["prompts"][2]
    s = _join(srv, p)
    _pump(srv, [s])
    assert s.result(1) == shared["want"][2]
    ptrs = {n: q._tensor().data_ptr()
            for n, q in model._collect_params_with_prefix().items()}
    captures = srv._steps.captures
    assert srv.swap_parameters(path) == 1
    assert ptrs == {n: q._tensor().data_ptr()
                    for n, q in model._collect_params_with_prefix().items()}
    for n, q in model._collect_params_with_prefix().items():
        assert torch.equal(q._tensor(),
                           other._collect_params_with_prefix()[n]._tensor())
    s = _join(srv, p)
    _pump(srv, [s])
    with torch.no_grad():
        ref = other.generate(torch.from_numpy(p[None].astype(np.int64)),
                             NEW, device="cpu")[0, len(p):].tolist()
    assert s.result(1) == ref != shared["want"][2]
    assert srv._steps.captures == captures and srv._steps.drops == 0
    srv.stop()


def test_eager_step_equals_the_program_step(shared):
    """From one saved state, a step through the program and the eager step
    give the same logits, tokens, valid lengths and pages."""
    srv = _server(shared["port_model"], slots=2, quantize="int8")
    for p in shared["prompts"][:2]:
        _join(srv, p, n=20)
        srv._admit_pending()
    c = srv.cache
    saved = [t.clone() for t in [srv._tok, c.valid] + c.k + c.v
             + c.k_scale + c.v_scale]

    def restore():
        for dst, src in zip([srv._tok, c.valid] + c.k + c.v + c.k_scale
                            + c.v_scale, saved):
            dst.copy_(src)

    runs = []
    for eager in (False, True):
        restore()
        out = []
        for _ in range(3):
            logits = srv._run_step(eager=eager).clone()
            out.append((logits, srv._tok.clone(), c.valid.clone(),
                        [t.clone() for t in c.k + c.k_scale]))
        runs.append(out)
    for (l1, t1, v1, p1), (l2, t2, v2, p2) in zip(*runs):
        assert torch.equal(l1, l2) and torch.equal(t1, t2)
        assert torch.equal(v1, v2)
        assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert srv._steps.replays == 3
    srv.stop()


def test_greedy_streams_with_programs_match_the_jax_server(shared):
    with _server(shared["port_model"], slots=2) as srv:
        got = [h.result(600) for h in [srv.submit(p, max_new_tokens=NEW)
                                       for p in shared["prompts"]]]
        stats = srv.stats()
    assert got == shared["want"]
    assert stats["step_replays"] == stats["decode_steps"]


def test_programs_compare_the_buffers_they_were_made_on():
    """Any moved buffer or parameter drops every program; the same
    buffers keep them."""
    progs = StepPrograms("cpu")
    state = {"tok": torch.zeros(2, dtype=torch.int32),
             "k": [torch.zeros(2, 4)]}
    w = torch.ones(3)
    calls = []

    def body(st):
        calls.append(1)
        st["tok"] += 1
        return st["tok"]

    for _ in range(3):
        progs.run("a", body, state, params=[w])
    assert (progs.captures, progs.replays, progs.drops) == (1, 3, 0)
    progs.run("b", body, state, params=[w])
    assert progs.captures == 2 and sorted(progs.keys()) == ["a", "b"]
    state["k"] = [torch.zeros(2, 8)]  # a migration's new page
    progs.run("a", body, state, params=[w])
    assert progs.drops == 1 and progs.keys() == ["a"]
    progs.run("a", body, state, params=[torch.ones(3)])  # a new weight
    assert progs.drops == 2 and progs.captures == 4
    assert progs.run("a", body, state, params=(), eager=True) is state["tok"]
    assert progs.replays == 6 and len(calls) == 7
    assert state["tok"].tolist() == [7, 7]
