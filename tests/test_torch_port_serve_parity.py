"""The port's ModelServer against the JAX package's on the CPU, on the same
weights (a small BERT, fp32): ``health``, ``swap_parameters`` (a good file
and a refused one), the request-size and per-bucket histograms,
``fit_buckets`` and ``retune_buckets``, ``stop(reason=)``; the executor
pool's program counters; and a request with token ids outside the table
(C.5), in ``ModelServer`` and ``GenerativeServer``, against the JAX
servers. Served rows are held to the JAX server's within 1e-4 (fp32),
NaN where it gives NaN; tokens and counters exactly."""
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import mxnet_tpu as mx
from mxnet_tpu import serve as jserve
from mxnet_tpu.ir import tune as jtune
from mxnet_tpu_torch.checkpoint import SwapError
from mxnet_tpu_torch.ir.tune import fit_buckets
from mxnet_tpu_torch.serve import GenerativeServer, ModelServer, ServeError
from torch_port_helpers import (SEQ, SMALL_BERT, bert_inputs,  # noqa: F401
                                jax_bert, jax_gpt, jax_trace_state,
                                port_bert_from, port_gpt_from)

SPECS = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
BUCKETS = (1, 2, 4, 8)
ROWS = (1, 3, 2, 1, 4, 3, 1, 7)  # one request each, served one at a time


def _pair(jm, **kw):
    """(the JAX server, the port's) on the same weights, not started."""
    kw = dict(dict(buckets=BUCKETS, max_wait_ms=1.0), **kw)
    return (jserve.ModelServer(jm, SPECS, **kw),
            ModelServer(port_bert_from(jm), SPECS, device="cpu", **kw))


def _requests(seed=5):
    tok, tt, vl = bert_inputs(seed, sum(ROWS))
    out, off = [], 0
    for n in ROWS:
        out.append((tok[off:off + n], tt[off:off + n], vl[off:off + n]))
        off += n
    return out


def _serve(srv, reqs):
    """Each request alone (one batch each, so both servers batch alike)."""
    with srv:
        return [srv.predict(*r) for r in reqs]


def _close(got, want, vl):
    for g, w in zip(got, want):
        w = [np.asarray(a) for a in w]
        for i, n in enumerate(vl):
            np.testing.assert_allclose(g[0][i, :n], w[0][i, :n], atol=1e-4,
                                       rtol=0)
        np.testing.assert_allclose(g[1], w[1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g[2], w[2], atol=1e-4, rtol=0)


def test_health_histograms_and_counters_match_jax(jax_trace_state):  # noqa: F811
    jm = jax_bert(False)
    jsrv, srv = _pair(jm)
    assert srv.health() == jsrv.health()
    st0 = srv.stats()
    assert (st0["captures"], st0["replays"], st0["drops"]) == (4, 4, 0)
    reqs = _requests()
    want = _serve(jsrv, reqs)
    got = _serve(srv, reqs)
    for g, w, r in zip(got, want, reqs):
        _close([g], [w], r[2])
    js, ts = jsrv.stats(), srv.stats()
    for key in ("requests", "completed", "batches", "pad_rows_total",
                "pad_waste_bytes", "request_rows", "bucket_hist", "errors"):
        assert ts[key] == js[key], key
    assert srv.metrics.request_rows() == jsrv.metrics.request_rows() == {
        1: 3, 2: 1, 3: 2, 4: 1, 7: 1}
    assert ts["bucket_hist"]["8"] == {"batches": 1, "rows": 7, "pad_rows": 1}
    # traffic captures nothing: one replay a batch
    assert (ts["captures"], ts["replays"], ts["drops"]) == (4, 4 + len(ROWS),
                                                            0)
    assert srv.health() == jsrv.health()
    assert srv.health()["warm"] and not srv.health()["running"]
    assert srv.metrics.load_gauges() == jsrv.metrics.load_gauges() == {
        "queue_depth": 0, "tokens_in_flight": 0}


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.integers(1, 64), st.integers(0, 50), min_size=1,
                       max_size=12),
       st.integers(1, 6), st.one_of(st.none(), st.integers(1, 64)))
def test_fit_buckets_matches_jax(hist, max_buckets, max_size):
    if not any(hist.values()) and max_size is None:
        with pytest.raises(ValueError):
            fit_buckets(hist, max_buckets=max_buckets)
        return
    assert fit_buckets(hist, max_buckets=max_buckets, max_size=max_size) \
        == jtune.fit_buckets(hist, max_buckets=max_buckets,
                             max_size=max_size)


def test_retune_buckets_matches_jax(jax_trace_state):  # noqa: F811
    jm = jax_bert(False)
    jsrv, srv = _pair(jm)
    with pytest.raises(ServeError, match="history"):
        srv.retune_buckets()
    reqs = _requests()
    _serve(jsrv, reqs)
    _serve(srv, reqs)
    srv.retune_buckets(buckets=BUCKETS)  # the same set: nothing rebuilt
    assert srv.stats()["captures"] == 4
    jsrv.retune_buckets(max_buckets=3)
    srv.retune_buckets(max_buckets=3)
    assert srv.buckets == jsrv.buckets == (1, 4, 8)
    ts = srv.stats()
    # a new pool: exactly the new buckets captured, metrics carried over
    assert (ts["captures"], ts["replays"], ts["programs"]) == (3, 3,
                                                              [1, 4, 8])
    assert ts["requests"] == len(ROWS)
    got = _serve(srv, reqs[:3])
    want = _serve(jsrv, reqs[:3])
    for g, w, r in zip(got, want, reqs):
        _close([g], [w], r[2])
    assert srv.stats()["captures"] == 3


def test_swap_parameters_matches_jax(jax_trace_state, tmp_path):  # noqa: F811
    jm = jax_bert(False)
    jsrv, srv = _pair(jm)
    good = str(tmp_path / "new.params")
    jax_bert(False).save_parameters(good)
    bad = str(tmp_path / "bad.params")
    np.savez(bad, **{"nonexistent": np.zeros(3, np.float32)})
    os.replace(bad + ".npz", bad)
    reqs = _requests()[:3]
    old = _serve(srv, reqs)
    for s in (jsrv, srv):
        with pytest.raises(Exception, match="rejected") as e:
            s.swap_parameters(bad)
    assert isinstance(e.value, SwapError)
    assert srv.health()["swap_epoch"] == 0
    for g, w, r in zip(_serve(srv, reqs), old, reqs):
        _close([g], [w], r[2])
    assert jsrv.swap_parameters(good) == srv.swap_parameters(good) == 1
    got, want = _serve(srv, reqs), _serve(jsrv, reqs)
    for g, w, r in zip(got, want, reqs):
        _close([g], [w], r[2])
    assert not np.allclose(got[0][1], old[0][1])
    ts = srv.stats()
    # the copy kept every tensor where it was: no program dropped or made
    assert (ts["captures"], ts["drops"]) == (4, 0)
    assert srv.health() == jsrv.health()


def test_rebinding_a_parameter_drops_the_programs():
    """A parameter given a new tensor (where a swap must copy) moves an
    address the bucket programs hold: every program is dropped and the
    next dispatch makes its bucket's again."""
    from mxnet_tpu_torch.models.bert import BERTModel

    tm = BERTModel(**SMALL_BERT)
    tm.initialize(device="cpu")
    srv = ModelServer(tm, SPECS, buckets=(1, 4), device="cpu")
    p = next(iter(tm.collect_params().values()))
    p.set_data(p._tensor().clone())
    with srv:
        srv.predict(*_requests()[0])
    st_ = srv.stats()
    assert (st_["captures"], st_["drops"]) == (3, 1)


def test_stop_reason_and_fault_hook_match_jax(jax_trace_state):  # noqa: F811
    jm = jax_bert(False)
    jsrv, srv = _pair(jm)
    tok, tt, vl = bert_inputs(3, 1)
    texts = []
    for s in (jsrv, srv):
        h = s._batcher.submit([tok, tt, vl], 1)  # not started: stays queued
        s.stop(drain=False, reason="rolling restart")
        with pytest.raises(Exception) as e:
            h.result(timeout_s=5)
        texts.append((type(e.value).__name__, str(e.value)))
    assert texts == [("ServeError", "rolling restart")] * 2
    assert isinstance(e.value, ServeError)
    jsrv, srv = _pair(jm)
    errs = []
    for s in (jsrv, srv):
        def fault(i):
            if i == 1:
                raise RuntimeError("planted fault at batch %d" % i)

        s.inject_fault = fault
        with s:
            s.predict(tok, tt, vl)
            with pytest.raises(RuntimeError, match="planted") as e:
                s.predict(tok, tt, vl)
            errs.append(str(e.value))
            s.predict(tok, tt, vl)
        errs.append(s.stats()["errors"])
    assert errs[:2] == errs[2:] == ["planted fault at batch 1", 1]


def test_model_server_ids_outside_the_table_match_jax(
        jax_trace_state):  # noqa: F811
    """C.5: a request whose tokens hold vocab + 43 and -1 beside a good
    one, in one batch: the JAX server's rows (NaN where it gives NaN), the
    good request's rows equal to its solo run, no error."""
    jm = jax_bert(False)
    jsrv, srv = _pair(jm, max_wait_ms=200.0)
    tok, tt, vl = bert_inputs(9, 2)
    tok[1, 3] = SMALL_BERT["vocab_size"] + 43
    tok[1, 5] = -1
    got, want = [], []
    for s, out in ((srv, got), (jsrv, want)):
        with s:
            hs = [s.submit(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
                  for i in range(2)]
            out.extend(h.result(timeout_s=60) for h in hs)
            out.append(s.predict(tok[:1], tt[:1], vl[:1]))
            assert s.stats()["errors"] == 0
    for g, w, i in zip(got, want, (0, 1, 0)):
        _close([g], [w], vl[i:i + 1])
    assert np.isnan(got[1][1]).all() and np.isfinite(got[0][1]).all()
    # bucket 2 against bucket 1: other GEMM shapes, so 1e-6, not bitwise
    np.testing.assert_allclose(got[0][1], got[2][1], atol=1e-6, rtol=0)


def test_generative_server_ids_outside_the_table_match_jax(
        jax_trace_state):  # noqa: F811
    """C.5, the ROADMAP probe (small GPT, vocab 256, greedy, 4 new tokens):
    [1, 2, 300] gives [0, 0, 0, 0] and [1, -1, 3] gives [3, 3, 3, 3] (-1
    is row 255) in both packages, beside a good stream equal to its solo
    run. In int8 one activation scale spans the step's rows, so the NaN
    row reaches the others in both packages alike (ROADMAP C.2)."""
    jm = jax_gpt(False)
    tm = port_gpt_from(jm)
    good = np.array([5, 6, 7, 8], np.int32)
    bad = [np.array([1, 2, 300], np.int32), np.array([1, -1, 3], np.int32)]
    for quant in (None, "int8"):
        runs = []
        for srv in (mx.serve.GenerativeServer(jm, slots=3, quantize=quant,
                                              timeout_ms=600000.0),
                    GenerativeServer(tm, slots=3, quantize=quant,
                                     device="cpu", timeout_ms=600000.0)):
            with srv:
                solo = srv.submit(good, max_new_tokens=4).result(600)
                hs = [srv.submit(p, max_new_tokens=4) for p in [good] + bad]
                runs.append(([h.result(600) for h in hs], solo,
                             srv.stats()["errors"]))
        assert runs[0] == runs[1], quant
        streams, solo, errors = runs[1]
        assert errors == 0
        if quant is None:
            assert streams == [solo, [0, 0, 0, 0], [3, 3, 3, 3]]
