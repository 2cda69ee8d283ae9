"""The port's GenerativeServer on the CPU against the JAX package's on the
same weights (a small GPT: 2 layers, 128 units, 2 heads of 64, vocab 256,
max_length 512, fp32): greedy streams identical for mixed prompt lengths,
one of them 300 tokens; then the port's own contract: prefix hits, capacity
growth mid-flight, refusal of a request longer than max_length, sampling
that depends only on (seed, position), priority preemption in the admission
queue, a queue timeout on the stream, stats, and the options the port does
not carry (quantized serving, which it does carry, is held in
tests/test_torch_port_quant_generate.py; speculative decode and chunked
prefill in tests/test_torch_port_speculative.py and
_chunked_prefill.py). One JAX server run is shared by the module."""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch.base import DeviceError
from mxnet_tpu_torch.serve import (CacheError, GenerativeServer,
                                   PagedKVCache, ServeError, ServerBusy,
                                   ServeTimeout, sample_tokens)
from mxnet_tpu_torch.serve.batcher import DynamicBatcher
from torch_port_helpers import (SMALL_GPT, jax_gpt,  # noqa: F401
                                jax_trace_state_module, port_gpt_from)

NEW = 10
LENGTHS = (3, 17, 300, 40, 9)


@pytest.fixture(scope="module")
def shared(jax_trace_state_module):  # noqa: F811
    """The JAX model and its server's greedy streams for LENGTHS, and the
    port's model on the same weights."""
    jm = jax_gpt(False)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, SMALL_GPT["vocab_size"], n).astype(np.int32)
               for n in LENGTHS]
    with mx.serve.GenerativeServer(jm, slots=2, timeout_ms=600000.0) as jsrv:
        handles = [jsrv.submit(p, max_new_tokens=NEW) for p in prompts]
        want = [h.result(600) for h in handles]
    return {"jax_model": jm, "prompts": prompts, "want": want,
            "port_model": port_gpt_from(jm)}


def _server(model, **kw):
    kw.setdefault("timeout_ms", 600000.0)
    return GenerativeServer(model, device="cpu", **kw)


def _pump(srv, streams, ticks=400):
    """Drive the scheduler synchronously until every stream finishes."""
    for _ in range(ticks):
        srv.step()
        if all(s.done() for s in streams):
            return
        time.sleep(0.002)
    raise AssertionError("streams did not finish in %d ticks" % ticks)


def test_greedy_streams_match_jax_server(shared):
    """Two slots, five requests (3 to 300 tokens): requests wait for a
    slot, join between steps and leave; every stream equals the JAX
    server's."""
    with _server(shared["port_model"], slots=2) as srv:
        got = [srv.submit(p, max_new_tokens=NEW) for p in shared["prompts"]]
        got = [s.result(600) for s in got]
        stats = srv.stats()
    assert got == shared["want"]
    assert stats["completed"] == len(LENGTHS) and stats["errors"] == 0
    assert stats["prefills"] == len(LENGTHS)
    assert stats["tokens"] == NEW * len(LENGTHS)


def test_prefix_hit_equals_miss_and_counts(shared):
    srv = _server(shared["port_model"], slots=2)
    p = shared["prompts"][1]
    s1 = srv.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s1])
    assert (srv.prefix.misses, srv.prefix.hits) == (1, 0)
    prefills = srv.metrics.prefills
    s2 = srv.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s2])
    assert (srv.prefix.misses, srv.prefix.hits) == (1, 1)
    assert srv.metrics.prefills == prefills, "a hit must skip the forward"
    assert s1.result(1) == s2.result(1) == shared["want"][1]
    stats = srv.stats()
    assert stats["prefix_hits"] == 1 and stats["prefix_entries"] == 1
    # the entries move to another server through host copies
    entries = srv.export_prefixes()
    assert entries[0][1].device.type == "cpu"
    other = _server(shared["port_model"], slots=1)
    assert other.import_prefixes(entries) == 1
    s3 = other.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(other, [s3])
    assert other.prefix.hits == 1 and s3.result(1) == shared["want"][1]
    srv.stop()
    other.stop()


def test_capacity_grows_mid_flight(shared):
    """A 300-token request joining a 3-token one grows the cache from
    bucket 16 to 512 (one migration) without touching the short one's
    stream."""
    srv = _server(shared["port_model"], slots=2)
    short, long_ = shared["prompts"][0], shared["prompts"][2]
    s1 = srv.submit(short, max_new_tokens=NEW)
    time.sleep(0.05)
    srv.step()
    assert srv.cache.capacity == 16
    s2 = srv.submit(long_, max_new_tokens=NEW)
    time.sleep(0.05)
    _pump(srv, [s1, s2])
    assert srv.cache.capacity == 512 and srv.cache.migrations == 1
    assert s1.result(1) == shared["want"][0]
    assert s2.result(1) == shared["want"][2]
    srv.stop()


def test_request_longer_than_max_length_refused_at_submit(shared):
    srv = _server(shared["port_model"], slots=1)
    with pytest.raises(CacheError):
        srv.submit(list(range(500)), max_new_tokens=20)  # 520 > 512
    srv.stop()


def test_paged_cache_defaults_to_the_card():
    """Like every entry point, the cache runs on the card unless asked
    for the CPU: without a card its default device raises."""
    if torch.cuda.is_available():
        assert PagedKVCache(1, 1, 4, 1, 8).device.type == "cuda"
    else:
        with pytest.raises(DeviceError):
            PagedKVCache(1, 1, 4, 1, 8)


def test_paged_cache_slots_and_buckets():
    c = PagedKVCache(layers=2, heads=2, head_dim=4, slots=3,
                     max_capacity=64, device="cpu")
    assert (c.capacity_bucket(5), c.capacity_bucket(33)) == (8, 64)
    with pytest.raises(CacheError):
        c.capacity_bucket(65)
    assert c.ensure_capacity(5) and c.capacity == 8
    c.k[0][1, 0, 7] = 3.0
    assert not c.ensure_capacity(3)
    assert c.ensure_capacity(9) and c.capacity == 16 and c.migrations == 1
    assert tuple(c.k[0].shape) == (3, 2, 16, 4) and float(c.k[0][1, 0, 7,
                                                                 0]) == 3.0
    slots = [c.acquire(x) for x in "abc"]
    assert c.acquire("d") is None and c.num_active == 3
    c.release(slots[1])
    assert c.acquire("d") == slots[1]
    assert c.nbytes() == 2 * 2 * 3 * 2 * 16 * 4 * 4


def test_sampling_depends_on_seed_and_position_only(shared):
    """A sampled stream is the same whatever shares the batch, and with
    top_k=1 it is the greedy stream."""
    p = shared["prompts"][3]
    runs = []
    for companions in ([], shared["prompts"][:2], shared["prompts"][4:]):
        with _server(shared["port_model"], slots=3, top_k=8) as srv:
            others = [srv.submit(c, max_new_tokens=NEW) for c in companions]
            s = srv.submit(p, max_new_tokens=NEW, temperature=1.0, seed=5)
            other_seed = srv.submit(p, max_new_tokens=NEW, temperature=1.0,
                                    seed=6)
            runs.append((s.result(600), other_seed.result(600)))
            [o.result(600) for o in others]
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][0] != runs[0][1], "another seed, another stream"
    with _server(shared["port_model"], slots=2, top_k=1) as srv:
        assert srv.generate(p, max_new_tokens=NEW, temperature=0.9,
                            seed=3) == shared["want"][3]


def test_sample_tokens_rules():
    """Greedy takes the first index on ties; the draw follows top-k and
    the temperature, and its noise is a function of (seed, position)."""
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [5.0, 1.0, 5.0, 0.0]])
    seeds = torch.tensor([1, 2])
    pos = torch.tensor([7, 7])
    greedy = sample_tokens(logits, seeds, pos, torch.zeros(2), 0,
                           sampling=False)
    assert greedy.tolist() == [1, 0]
    mixed = sample_tokens(logits, seeds, pos, torch.tensor([0.0, 1.0]), 2)
    assert mixed[0] == 1 and mixed[1] in (0, 2)
    draws = [int(sample_tokens(torch.zeros(1, 16), torch.tensor([s]),
                               torch.tensor([q]), torch.ones(1), 0)[0])
             for s in range(8) for q in range(8)]
    assert len(set(draws)) > 8, "the noise should spread over the vocab"
    again = [int(sample_tokens(torch.zeros(1, 16), torch.tensor([s]),
                               torch.tensor([q]), torch.ones(1), 0)[0])
             for s in range(8) for q in range(8)]
    assert draws == again


def test_priority_preemptive_shedding_in_admission_queue():
    held = []
    b = DynamicBatcher(lambda reqs, rows: held.extend(reqs), max_batch=1,
                       max_queue=2)
    # an unstarted batcher: requests wait in the admission queue
    low1 = b.submit(["l1"], 1, timeout_ms=10000.0, priority=0)
    low2 = b.submit(["l2"], 1, timeout_ms=500.0, priority=0)
    hi = b.submit(["hi"], 1, timeout_ms=10000.0, priority=5)
    # the victim is the lowest class with the least deadline slack: low2
    with pytest.raises(ServerBusy):
        low2.result(0.5)
    assert not low1.done() and not hi.done()
    # an equal priority cannot preempt: the new request sheds
    with pytest.raises(ServerBusy):
        b.submit(["l3"], 1, priority=0)
    with b._cond:
        order = [r.inputs[0] for r in b._queue]
    assert order == ["hi", "l1"]
    assert b.queue_depth() == 2


def test_generative_submit_takes_priority(shared):
    # two slots and a long batching window: the first request stays in
    # the admission queue, where the second, of a higher class, sheds it
    srv = _server(shared["port_model"], slots=2, max_queue=1,
                  max_wait_ms=60000.0)
    low = srv.submit(shared["prompts"][0], max_new_tokens=2)
    high = srv.submit(shared["prompts"][0], max_new_tokens=2, priority=3)
    with pytest.raises(ServerBusy):
        low.result(5)
    assert high._admission.priority == 3
    srv.stop()


def test_queue_timeout_surfaces_on_the_stream(shared):
    """A request that times out waiting for a slot fails its stream with
    ServeTimeout; the request holding the slot finishes unharmed."""
    srv = _server(shared["port_model"], slots=1)
    p = shared["prompts"][4]
    s1 = srv.submit(p, max_new_tokens=NEW)
    time.sleep(0.05)
    srv.step()
    doomed = srv.submit(p, max_new_tokens=4, timeout_ms=30.0)
    time.sleep(0.1)
    for _ in range(30):
        srv.step()
        if doomed.done():
            break
        time.sleep(0.01)
    with pytest.raises(ServeTimeout):
        doomed.result(1)
    _pump(srv, [s1])
    assert s1.result(1) == shared["want"][4]
    assert srv.stats()["timeouts"] >= 1
    srv.stop()


def test_stats_carry_the_jax_keys_the_slice_covers(shared):
    srv = _server(shared["port_model"], slots=2)
    srv.warmup(prompt_buckets=(4,), max_tokens=16)
    with srv:
        srv.generate(shared["prompts"][0], max_new_tokens=NEW)
        snap = srv.stats()
        health = srv.health()
    for key in ("tokens", "tokens_per_s", "ttft_p50_ms", "itl_p50_ms",
                "itl_p99_ms", "inflight_fill", "decode_steps", "prefills",
                "prefix_hits", "prefix_misses", "prefix_entries", "slots",
                "capacity", "in_flight", "tokens_in_flight", "swap_epoch",
                "cache_migrations", "kv_cache_bytes", "ttft_by_bucket",
                "completed", "shed", "timeouts", "errors", "p50_ms",
                "spec_rounds", "drafted_tokens", "accepted_tokens",
                "accept_rate", "prefill_chunks", "prefill_chunk",
                "itl_prefill_p50_ms", "spec_k", "draft"):
        assert key in snap, key
    assert snap["tokens_per_s"] > 0 and 0 < snap["inflight_fill"] <= 1
    # no draft and no chunking: the speculative and chunk keys read empty
    assert (snap["spec_rounds"], snap["prefill_chunks"]) == (0, 0)
    assert snap["accept_rate"] is None and snap["prefill_chunk"] is None
    assert health["warm"] and health["kind"] == "generative"


@pytest.mark.parametrize("option,value,item", [("metrics_port", 0, "A.16")])
def test_options_the_slice_does_not_carry_raise(shared, option, value, item):
    """The options a slice left out raised, naming their ROADMAP item; the
    last of them, ``metrics_port`` (A.16), is carried now: the server
    serves ``/metrics`` while it runs and closes it at ``stop()``."""
    import urllib.request

    srv = _server(shared["port_model"], **{option: value})
    srv.start()
    try:
        assert srv.metrics_http is not None, item
        with urllib.request.urlopen(srv.metrics_http.url(), timeout=30) as r:
            body = r.read().decode()
        assert "mxtpu_serve_server_" in body
    finally:
        srv.stop()
    assert srv.metrics_http is None


def test_without_a_device_it_needs_cuda(shared, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        GenerativeServer(shared["port_model"])
