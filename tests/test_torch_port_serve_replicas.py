"""``ModelServer(devices=[...])``: one replica a listed device, batches
round-robin over them, a weight swap reaching every replica, per-replica
counters; against the same server with one replica and against the JAX
package's ``ModelServer(devices=)`` on two of conftest's CPU devices (a
small BERT, fp32: rows within 1e-4 of the JAX server's, and the two
replicas' rows equal to the one-replica server's bit for bit)."""
import jax
import numpy as np
import pytest

from mxnet_tpu import serve as jserve
from mxnet_tpu_torch.serve import ModelServer
from torch_port_helpers import (SEQ, bert_inputs, jax_bert,  # noqa: F401
                                jax_rng_kept, jax_trace_state,
                                port_bert_from)

pytestmark = pytest.mark.usefixtures("jax_rng_kept")

SPECS = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
BUCKETS = (1, 2, 4)
ROWS = (1, 3, 2, 4, 1, 2)


def _requests(seed=11):
    tok, tt, vl = bert_inputs(seed, sum(ROWS))
    out, off = [], 0
    for n in ROWS:
        out.append((tok[off:off + n], tt[off:off + n], vl[off:off + n]))
        off += n
    return out


def _serve(srv, reqs):
    with srv:
        return [srv.predict(*r) for r in reqs]


def test_replicas_rows_alternation_and_swap(jax_trace_state,  # noqa: F811
                                            tmp_path):
    jm = jax_bert(False)
    reqs = _requests()
    one = ModelServer(port_bert_from(jm), SPECS, buckets=BUCKETS,
                      max_wait_ms=1.0, device="cpu")
    two = ModelServer(port_bert_from(jm), SPECS, buckets=BUCKETS,
                      max_wait_ms=1.0, devices=["cpu", "cpu"])
    jsrv = jserve.ModelServer(jm, SPECS, buckets=BUCKETS, max_wait_ms=1.0,
                              devices=jax.devices()[:2])
    st = two.stats()
    assert len(st["replicas"]) == 2
    # each replica made its own bucket programs at warmup
    assert [r["captures"] for r in st["replicas"]] == [3, 3]
    assert st["captures"] == 6
    want = _serve(one, reqs)
    got = _serve(two, reqs)
    jwant = _serve(jsrv, reqs)
    for g, w, j, r in zip(got, want, jwant, reqs):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        vl = r[2]
        for i, n in enumerate(vl):
            np.testing.assert_allclose(g[0][i, :n], np.asarray(j[0])[i, :n],
                                       atol=1e-4, rtol=0)
        np.testing.assert_allclose(g[1], np.asarray(j[1]), atol=1e-4, rtol=0)
    st = two.stats()
    # one request a batch, alternating: 3 batches each, no new program
    assert [r["batches"] for r in st["replicas"]] == [3, 3]
    assert [r["captures"] for r in st["replicas"]] == [3, 3]
    assert st["replicas"][0]["device"] == st["replicas"][1]["device"] == "cpu"
    assert jsrv.stats()["replicas"] == 2
    # a swap reaches both replicas: every batch after it serves the new
    # weights, whichever replica takes it
    jm2 = jax_bert(False)
    path = str(tmp_path / "new.params")
    port_bert_from(jm2).save_parameters(path)
    new_one = ModelServer(port_bert_from(jm2), SPECS, buckets=BUCKETS,
                          max_wait_ms=1.0, device="cpu")
    assert two.swap_parameters(path) == 1
    after = _serve(two, reqs[:2])
    fresh = _serve(new_one, reqs[:2])
    for g, w in zip(after, fresh):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert [r["batches"] for r in two.stats()["replicas"]] == [4, 4]
    assert not np.array_equal(after[0][1], want[0][1])
