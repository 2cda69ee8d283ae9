"""The port's ModelServer on the CPU: each request gets the rows a direct
forward of the same model gives (<= 1e-6), and the JAX package's
ModelServer's rows for the same weights (1e-4, fp32)."""
import numpy as np
import pytest
import torch

from mxnet_tpu import serve as jserve
from mxnet_tpu_torch.serve import ModelServer, ServeError, ServerBusy
from torch_port_helpers import (SEQ, bert_inputs, jax_bert,  # noqa: F401
                                jax_trace_state, port_bert_from)

SPECS = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]


def test_model_server_matches_direct_forward_and_jax_server(
        jax_trace_state):  # noqa: F811
    jm = jax_bert(False)
    tm = port_bert_from(jm)
    tok, tt, vl = bert_inputs(5, 6)
    with torch.inference_mode():
        direct = [o.numpy() for o in tm(torch.from_numpy(tok),
                                        torch.from_numpy(tt),
                                        torch.from_numpy(vl))]
    jsrv = jserve.ModelServer(jm, SPECS, buckets=(1, 4), max_wait_ms=1.0)
    with ModelServer(tm, SPECS, buckets=(1, 4), max_wait_ms=1.0,
                     device="cpu") as srv:
        handles = [srv.submit(tok[i], tt[i], vl[i]) for i in range(6)]
        got = [h.result(timeout_s=60) for h in handles]
        one = srv.predict(tok[0], tt[0], vl[0])
        stats = srv.stats()
    with jsrv:
        want = [jsrv.predict(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
                for i in range(6)]
    for i, (outs, jouts) in enumerate(zip(got, want)):
        n = vl[i]
        assert len(outs) == 3 and outs[0].shape == (1, SEQ, 128)
        np.testing.assert_allclose(outs[0][0, :n], direct[0][i, :n], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(outs[1][0], direct[1][i], atol=1e-6, rtol=0)
        np.testing.assert_allclose(outs[2][0], direct[2][i], atol=1e-6, rtol=0)
        np.testing.assert_allclose(outs[0][0, :n], np.asarray(jouts[0])[0, :n],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(outs[1], np.asarray(jouts[1]), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(outs[2], np.asarray(jouts[2]), atol=1e-4,
                                   rtol=0)
    assert one[0].shape == (SEQ, 128)  # a bare sample drops the batch dim
    assert stats["completed"] == 7 and stats["errors"] == 0
    assert stats["p50_ms"] is not None and stats["batches"] >= 2
    assert 0 < stats["batch_fill_ratio"] <= 1


def test_model_server_sheds_when_queue_is_full():
    from mxnet_tpu_torch.models.bert import BERTModel
    from torch_port_helpers import SMALL_BERT

    tm = BERTModel(**SMALL_BERT)
    tm.initialize(device="cpu")
    tok, tt, vl = bert_inputs(6, 2)
    srv = ModelServer(tm, SPECS, buckets=(1,), max_queue=1, device="cpu")
    # the batcher is not started, so the first request stays queued
    first = srv._batcher.submit([tok[:1], tt[:1], vl[:1]], 1)
    with pytest.raises(ServerBusy):
        srv._batcher.submit([tok[1:], tt[1:], vl[1:]], 1)
    assert srv.stats()["shed"] == 1
    srv.stop()
    with pytest.raises(ServeError, match="stopped"):
        first.result(timeout_s=5)
