"""The port's BERT against the JAX package's, weights carried across by
``mxnet_tpu_torch.convert.from_jax_params``; and the checkpoint format the
two packages share (``util.save_npz_exact`` / ``load_npz_exact``)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import util as jutil
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import util as tutil
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.models.bert import BERTModel as PortBERT
from torch_port_helpers import (SMALL_BERT, assert_rows_close, bert_inputs,
                                jax_bert, jax_params, jax_trace_state,  # noqa: F401
                                port_bert_from)


def _jax_forward(model, tok, tt, vl):
    outs = model(mx.nd.array(tok, dtype="int32"), mx.nd.array(tt, dtype="int32"),
                 mx.nd.array(vl, dtype="int32"))
    return [np.asarray(o.asnumpy(), np.float32) for o in outs]


def _port_forward(model, tok, tt, vl):
    with torch.inference_mode():
        outs = model(torch.from_numpy(tok), torch.from_numpy(tt),
                     torch.from_numpy(vl))
    return [o.float().numpy() for o in outs]


@pytest.mark.parametrize("bf16", [False, True])
def test_bert_forward_matches_jax(jax_trace_state, bf16):  # noqa: F811
    """(seq, pooled, nsp_logits) on real rows: fp32 within 1e-4; bf16
    within 0.05 absolute plus 1e-2 relative — past 2 one bf16 step is
    already 0.0156, and the two frameworks round the elementwise chain
    (embedding sums, GELU) at different places."""
    jm = jax_bert(bf16)
    tm = port_bert_from(jm)
    if bf16:
        assert tm.encoder.ln.gamma.dtype == torch.float32
        assert tm.word_embed.weight.dtype == torch.bfloat16
    tok, tt, vl = bert_inputs(0, 3)
    want = _jax_forward(jm, tok, tt, vl)
    got = _port_forward(tm, tok, tt, vl)
    atol, rtol = (0.05, 1e-2) if bf16 else (1e-4, 0.0)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert_rows_close(want[0], got[0], vl, atol, rtol)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def test_parameter_names_match_jax(jax_trace_state):  # noqa: F811
    """Same names under each model's root prefix, same shapes, and amp
    keeps the same parameters in fp32."""
    jm = jax_bert(True)
    tm = PortBERT(**SMALL_BERT)
    tm.initialize(device="cpu")
    tamp.convert_hybrid_block(tm)
    jp = {n[len(jm.prefix):]: p for n, p in jm.collect_params().items()}
    tp = {n[len(tm.prefix):]: p for n, p in tm.collect_params().items()}
    assert set(jp) == set(tp)
    for n in jp:
        assert tuple(jp[n].shape) == tuple(tp[n].shape), n
        assert (np.dtype(jp[n].dtype).name == "float32") == \
            (tp[n].dtype == torch.float32), n


def test_from_jax_params_rejects_missing_extra_and_reshaped(jax_trace_state):  # noqa: F811
    params = jax_params(jax_bert(False))
    name = next(n for n in params if n.endswith("pooler_weight"))
    missing = {n: a for n, a in params.items() if n != name}
    with pytest.raises(KeyError, match="missing"):
        from_jax_params(PortBERT(**SMALL_BERT), missing)
    extra = dict(params, **{name.replace("pooler", "bogus"): params[name]})
    with pytest.raises(KeyError, match="extra"):
        from_jax_params(PortBERT(**SMALL_BERT), extra)
    reshaped = dict(params, **{name: params[name][:, :-1]})
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(PortBERT(**SMALL_BERT), reshaped)


def test_npz_checkpoints_cross_both_ways(tmp_path, jax_trace_state):  # noqa: F811
    """bf16 (sidecar) and fp32 entries keep their bits from either side."""
    params = jax_params(jax_bert(True))
    path = str(tmp_path / "jax.npz")
    jutil.save_npz_exact(path, params)
    loaded = tutil.load_npz_exact(path)
    assert set(loaded) == set(params)
    for n, a in params.items():
        assert loaded[n].dtype == (torch.bfloat16 if a.dtype.name == "bfloat16"
                                   else torch.float32)
        np.testing.assert_array_equal(loaded[n].float().numpy(),
                                      a.astype(np.float32))
    back = str(tmp_path / "port.npz")
    tutil.save_npz_exact(back, loaded)
    again = jutil.load_npz_exact(back)
    for n, a in params.items():
        assert again[n].dtype == a.dtype
        np.testing.assert_array_equal(again[n].view(np.uint8),
                                      a.view(np.uint8))
