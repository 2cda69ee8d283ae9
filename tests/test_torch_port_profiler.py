"""``mxnet_tpu_torch.profiler`` against ``mxnet_tpu.profiler``: the same
records give the same ``dumps()`` aggregate table and the same Chrome
trace events; the scopes (host, fused, serve, decode, backward), ``Domain``,
``Task``, ``Counter`` and ``Marker`` record as the JAX package's do; the
record cap counts what it drops; ``start``/``stop`` run a
``torch.profiler`` session (no kernel records without a card) around a CPU
server's batches, whose serve scopes and request spans join the trace;
the memory dumps read nothing without a card."""
import json

import numpy as np
import pytest

from mxnet_tpu import profiler as jp
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch import profiler as tp
from mxnet_tpu_torch.serve import ModelServer

RECORDS = [("conv", 10.0, 1.5), ("relu", 12.0, 0.25), ("conv", 20.0, 2.5),
           ("serve[b8 fill=0.50]", 30.0, 4.0), ("relu", 40.0, 0.125)]


@pytest.fixture
def both(monkeypatch, tmp_path):
    for i, mod in enumerate((tp, jp)):
        monkeypatch.setattr(mod, "_records", [])
        monkeypatch.setattr(mod, "_dropped", 0)
        monkeypatch.setattr(mod, "_config", dict(
            mod._config, filename=str(tmp_path / ("p%d.json" % i)),
            aggregate_stats=True))
    yield
    tp.stop()


def test_aggregate_table_and_chrome_trace_equal_the_jax_packages(both):
    for mod in (tp, jp):
        for name, ts, dur in RECORDS:
            mod._record(name, ts, dur, cat="operator", args={"k": 1})
        mod._record("ctr", 50.0, cat="host", ph="C", value=3)
        mod._record("mark", 60.0, cat="host", ph="i", s="p")
    assert tp.aggregate() == jp.aggregate()
    assert tp.dumps() == jp.dumps()
    a, b = (json.load(open(m.dump())) for m in (tp, jp))
    assert a == b
    tp._config["aggregate_stats"] = jp._config["aggregate_stats"] = False
    assert json.loads(tp.dumps(reset=True)) == json.loads(jp.dumps())
    assert tp.num_records() == 0


def test_scopes_and_objects_record_as_the_jax_packages_do(both):
    for mod in (tp, jp):
        mod._running = True
        try:
            with mod.scope("step"):
                pass
            with mod.bulk_scope(["mul", "mul", "add"]):
                pass
            with mod.backward_scope(["tanh"]):
                pass
            with mod.serve_scope(8, 6):
                pass
            with mod.decode_scope("step", 8, 2):
                pass
            d = mod.Domain("dom")
            t = d.new_task("task")
            t.start()
            t.stop()
            c = d.new_counter("ctr", 1)
            c += 2
            c -= 1
            d.new_marker("mk").mark("thread")
        finally:
            mod._running = False
    strip = [({k: v for k, v in r.items() if k not in ("ts_us", "dur_ms")})
             for r in tp._records]
    want = [({k: v for k, v in r.items() if k not in ("ts_us", "dur_ms")})
            for r in jp._records]
    assert strip == want
    assert [r["name"] for r in tp._records][:5] == [
        "step", "bulk[mul x2,add]", "backward[tanh]", "serve[b8 fill=0.75]",
        "decode[step fill=0.25 b8]"]


def test_record_cap_counts_the_dropped(both, monkeypatch):
    monkeypatch.setattr(tp, "_RECORD_CAP", 3)
    for i in range(5):
        tp._record("r%d" % i, float(i), 1.0)
    assert tp.num_records() == 3 and tp.records_dropped() == 2
    assert json.load(open(tp.dump()))["otherData"]["droppedRecords"] == 2
    tp.dumps(reset=True)
    assert tp.records_dropped() == 0 and tp.record_cap() == 3


class _Net(gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = gluon.nn.Dense(4, in_units=8)

    def hybrid_forward(self, F, x):
        return self.dense(x)


def test_start_stop_around_served_batches(both):
    net = _Net()
    net.initialize(device="cpu")
    srv = ModelServer(net, [((8,), "float32")], buckets=(2, 4),
                      device="cpu", max_wait_ms=20.0)
    tp.set_config(filename=tp._config["filename"], aggregate_stats=True)
    rng = np.random.RandomState(1)
    with srv:
        tp.start()
        assert tp.is_running()
        hs = [srv.submit(rng.normal(size=8).astype(np.float32))
              for _ in range(4)]
        for h in hs:
            h.result(timeout_s=60)
        tp.stop()
    assert not tp.is_running()
    events = json.load(open(tp.dump()))["traceEvents"]
    cats = {e["cat"] for e in events}
    assert any(e["name"].startswith("serve[b") for e in events)
    assert "request" in cats and "kernel" not in cats
    table = tp.dumps().splitlines()
    assert table[0].split() == ["Name", "Calls", "Total(ms)", "Min(ms)",
                                "Max(ms)", "Avg(ms)"]
    tp.set_state("run")
    tp.pause()
    tp.resume()
    tp.set_state("stop")
    assert not tp.is_running()


def test_memory_dumps_without_a_card(tmp_path):
    assert tp.device_memory_summary() == {}
    path = str(tmp_path / "mem.json")
    assert tp.dump_memory(path) == {}
    assert json.load(open(path)) == {}


def test_a_flushed_bulk_window_is_a_bulk_scope(both):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import engine, nd

    tp._running = True
    try:
        with mt.cpu(), engine.bulk(8):
            x = nd.ones((2, 3))
            y = nd.relu(x * 2 + 1)
            y.asnumpy()
    finally:
        tp._running = False
    names = [r["name"] for r in tp._records]
    assert any(n.startswith("bulk[") for n in names), names
