"""``mxnet_tpu_torch.observability`` against ``mxnet_tpu.observability``:
the Prometheus text of one snapshot dict equal to the JAX package's, the
registry's metrics, a scrape of a CPU ``ModelServer`` (``/metrics``,
``/snapshot``, ``/health``) against its ``stats()``, a request's trace
stages in order and within its latency, the retrace watchdog's events
(one naming each bucket a retune captures, one for a hybridized block's
new key, none unarmed), and the snapshot's sections."""
import importlib
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import engine, gluon, observability
from mxnet_tpu_torch.serve import ModelServer

# the modules (each package's ``registry`` attribute is its registry)
jreg = importlib.import_module("mxnet_tpu.observability.registry")
jtr = importlib.import_module("mxnet_tpu.observability.tracing")
treg = importlib.import_module("mxnet_tpu_torch.observability.registry")
ttr = importlib.import_module("mxnet_tpu_torch.observability.tracing")

SNAP = {
    "schema": 1,
    "metrics": {"counters": {"compiles_total": 3, "x.y": 2},
                "gauges": {"g": 1.5, "none": None},
                "histograms": {"h": {"count": 4, "sum": 10.0, "p50": 2.0,
                                     "p95": None, "p99": 3.25}}},
    "engine": {"dispatch": 12, "bulk_compile": 0},
    "serve": {"step_capture_counter": 2, "servers": {
        'serve:"a"': {"requests": 5, "p50_ms": 1.25, "running": True,
                      "bucket_hist": {"8": {"4": 2}}, "name": "x",
                      "ttft_by_bucket": {"64": {"p50_ms": 3.5},
                                         "128": {"p50_ms": None}},
                      "replicas": [{"device": "cpu"}]}}},
    "costs": {"profiles": {"tier:key": {"flops": 1e12}}},
    "9lives": {"ok": False, "big": 123456789012, "tiny": 1.5e-9},
}


def test_prometheus_text_equals_the_jax_packages():
    assert treg.render_prometheus(SNAP) == jreg.render_prometheus(SNAP)
    assert treg.render_prometheus(SNAP, prefix="p") == \
        jreg.render_prometheus(SNAP, prefix="p")


def test_registry_metrics_equal_the_jax_packages():
    regs = (treg.MetricsRegistry(), jreg.MetricsRegistry())
    for r in regs:
        r.counter("c", "help").inc(3)
        r.gauge("g").set(2.5)
        r.gauge("lazy").set_fn(lambda: 7)
        r.gauge("broken").set_fn(lambda: 1 / 0)
        h = r.histogram("h", window=4)
        for v in (5.0, 1.0, 3.0, 2.0, 9.0, 4.0):
            h.observe(v)
        r.register_collector("sec", lambda: {"a": 1})
        r.register_collector("bad", lambda: 1 / 0)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].counter("c") is regs[0].counter("c")


def test_trace_timing_layout():
    t = ttr.RequestTrace("x")
    j = jtr.RequestTrace("x")
    for tr in (t, j):
        tr.add_span("queue", 1.0, 1.5)
        tr.add_span("pad", 1.5, 1.75)
        tr.note_decode_step(0.01, 2.0)
        tr.note_decode_step(0.01, 2.01)
        tr.close_decode(2.02)
    a, b = t.timing(), j.timing()
    assert set(a) == set(b) | {"coalesce_ms"}
    for k in ("queue_ms", "pad_ms", "dispatch_ms", "tokens"):
        assert a[k] == b[k]
    assert [s[0] for s in t.spans] == [s[0] for s in j.spans]
    prev = ttr.set_tracing(False)
    try:
        assert ttr.new_trace() is None
    finally:
        ttr.set_tracing(prev)


class _Net(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = gluon.nn.Dense(4, in_units=8)

    def hybrid_forward(self, F, x):
        return self.dense(x)


@pytest.fixture
def server():
    net = _Net()
    net.initialize(device="cpu")
    srv = ModelServer(net, [((8,), "float32")], buckets=(1, 2, 4),
                      device="cpu", metrics_port=0, max_wait_ms=20.0,
                      name="serve:obs-test")
    yield srv
    observability.disarm_watchdog()
    srv.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def test_scrape_of_a_cpu_server(server):
    rng = np.random.RandomState(0)
    observability.watchdog.reset_events()
    observability.arm_watchdog()
    with server:
        hs = [server.submit(rng.normal(size=8).astype(np.float32))
              for _ in range(6)]
        done = []
        for h in hs:
            h.result(timeout_s=60)
            done.append((h, time.perf_counter() - h.t_submit))
        stats = server.stats()
        text = _get(server.metrics_http.url())
        snap = json.loads(_get(server.metrics_http.url("/snapshot")))
        health = json.loads(_get(server.metrics_http.url("/health")))
    label = '{server="serve:obs-test"}'
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line and not line.startswith("#"))
    for k in ("requests", "completed", "batches", "captures", "replays"):
        assert float(samples["mxtpu_serve_server_%s%s" % (k, label)]) == \
            stats[k], k
    assert "# TYPE mxtpu_engine_dispatch counter" in text
    assert snap["serve"]["servers"]["serve:obs-test"]["requests"] == 6
    assert health["ok"] and health["kind"] == "model" and health["warm"]
    for h, lat in done:
        spans = h.trace.spans
        assert [s[0] for s in spans] == ["queue", "coalesce", "pad",
                                         "dispatch"]
        assert all(b[1] >= a[2] for a, b in zip(spans, spans[1:]))
        assert sum(s[2] - s[1] for s in spans) <= lat
        assert set(h.timing()) >= {"queue_ms", "coalesce_ms", "pad_ms",
                                   "dispatch_ms"}
    assert observability.watchdog.snapshot()["events"] == 0
    assert server.metrics_http is None  # closed at stop()


def test_watchdog_names_each_bucket_a_retune_captures(server):
    observability.watchdog.reset_events()
    server.retune_buckets((2, 3))  # not armed: no event
    assert observability.watchdog.snapshot()["events"] == 0
    observability.arm_watchdog()
    server.retune_buckets((1, 4))
    keys = [e["key"] for e in observability.watchdog.events]
    assert sorted(keys) == ["serve[serve:obs-test bucket=1]",
                            "serve[serve:obs-test bucket=4]"]
    assert all(e["counter"] == "serve_capture"
               for e in observability.watchdog.events)
    last = observability.snapshot()["watchdog"]["last_event"]
    assert last["event"] == "retrace_after_warmup"


def test_watchdog_sees_a_hybridized_blocks_new_key():
    net = _Net()
    net.initialize(device="cpu")
    net.hybridize()
    net(torch.zeros(2, 8))
    observability.watchdog.reset_events()
    observability.arm_watchdog()
    try:
        net(torch.zeros(2, 8))  # the same key: a replay
        assert observability.watchdog.snapshot()["events"] == 0
        net(torch.zeros(3, 8))  # a new shape: a capture
        ev = observability.watchdog.events
        assert len(ev) == 1 and ev[0]["counter"] == "hybrid_capture"
        assert "_Net" in ev[0]["key"]
    finally:
        observability.disarm_watchdog()
    n = engine.hybrid_capture_counter.count
    net(torch.zeros(5, 8))
    assert engine.hybrid_capture_counter.count == n + 1
    assert observability.watchdog.snapshot()["events"] == 1


def test_snapshot_sections_and_op_telemetry():
    from mxnet_tpu_torch import nd
    import mxnet_tpu_torch as mt

    snap = observability.snapshot()
    for k in ("schema", "metrics", "engine", "caches", "serve", "profiler",
              "ops", "watchdog", "tracing", "dist", "quant", "tune"):
        assert k in snap, k
    assert set(snap["not_ported"]) == {"costs", "hlolint", "concurrency",
                                       "comp_cache", "ir"}
    assert all(v.startswith("A.16") for v in snap["not_ported"].values())
    assert "device" not in snap
    assert observability.snapshot(device=True)["device"][
        "hbm_bytes_in_use"] is None  # no card here
    prev = observability.enable_op_telemetry(True)
    try:
        with mt.cpu():
            nd.relu(nd.ones((2, 2)))
        assert observability.snapshot()["ops"]["dispatches"]["relu"] >= 1
    finally:
        observability.enable_op_telemetry(prev)
    observability.registry.counter("scrapes_total").inc()
    text = observability.prometheus()
    assert "mxtpu_metrics_counters_scrapes_total 1" in text
