"""The port's quantization (``mxnet_tpu_torch.quantization``,
``ops/lowbit.py``) against the JAX package's on the CPU, on seeded numpy
inputs: the primitives bit for bit (int8, e4m3, e5m2, fp32 and bf16
inputs), the quantized fully-connected product within 1e-6 of the sum of
its absolute terms (the integer part is exact; an fp8 product's fp32 sums
may run in another order), ``quantize_model``'s parameter names, dtypes
and grad_req, the calibration thresholds, parameter files both ways, and
``ModelServer(quantize=...)`` on a small BERT.

The JAX functions run op by op here, as their source reads. Under
``jax.jit`` XLA keeps a bf16 quotient in fp32 (excess precision) and turns
a division by a constant into a multiply by its reciprocal, so a jitted
JAX program can differ from its own source in the last bit; the port
follows the source."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import quantization as jq
from mxnet_tpu import serve as jserve
from mxnet_tpu_torch import quantization as tq
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import functional as F
from mxnet_tpu_torch.serve import ModelServer
from mxnet_tpu_torch.util import to_tensor
from torch_port_helpers import (SEQ, SMALL_BERT, bert_inputs,  # noqa: F401
                                jax_bert, jax_gpt, jax_params,
                                jax_trace_state, port_bert_from,
                                port_gpt_from)

MODES = ("int8", "e4m3", "e5m2")
SPECS = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]


def _bits(a):
    """A numpy (ml_dtypes fp8/bf16 included) or torch array as raw bytes."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _inputs(seed, shape, bf16):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3.0
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if bf16:
        jx = jx.astype(jnp.bfloat16)
        tx = to_tensor(np.asarray(jx))
    return jx, tx


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_quantize_dequantize_bit_equal(bf16):
    """contrib_quantize per tensor and per slice, and dequantize: values
    and scales bit for bit."""
    jx, tx = _inputs(1, (6, 40), bf16)
    for axis in (None, 0, 1):
        jqv, js = jq.quantize(jx, axis=axis)
        tqv, ts = F.contrib_quantize(tx, axis=axis)
        assert tqv.dtype == torch.int8
        np.testing.assert_array_equal(_bits(tqv), _bits(jqv))
        np.testing.assert_array_equal(_bits(ts), _bits(js))
        np.testing.assert_array_equal(
            F.contrib_dequantize(tqv, ts).numpy(),
            np.asarray(jq.dequantize(jqv, js)))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_weight_bit_equal(mode):
    """Per-channel weights, with a row of zeros (the 1e-8 floor) and a
    row of one huge value: q and scale bit for bit."""
    w = np.random.RandomState(2).randn(24, 40).astype(np.float32)
    w[3] = 0.0
    w[5, 7] = 1e4
    for axis in (0, 1):
        jqw, jws = jq.quantize_weight(jnp.asarray(w), axis, mode)
        tqw, tws = tq.quantize_weight(torch.from_numpy(w), axis, mode)
        assert tqw.dtype == tq.quant_dtype(mode)
        np.testing.assert_array_equal(_bits(tqw), _bits(jqw))
        np.testing.assert_array_equal(_bits(tws), _bits(jws))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
def test_quantized_fully_connected_matches_jax(mode, bf16, calibrated):
    """(4, 7, 64) activations against (40, 64) weights (40 outputs: the
    fp8 routes pad to 48), with a bias, dynamic or with a calibrated
    scale: within 1e-6 of the sum of the product's absolute terms; int8
    bit for bit."""
    jx, tx = _inputs(3, (4, 7, 64), bf16)
    w = np.random.RandomState(4).randn(40, 64).astype(np.float32)
    b = np.random.RandomState(5).randn(40).astype(np.float32)
    jqw, jws = jq.quantize_weight(jnp.asarray(w), 0, mode)
    tqw, tws = tq.quantize_weight(torch.from_numpy(w), 0, mode)
    xs = 0.021 if calibrated else None
    want = np.asarray(jq.quantized_fully_connected(
        jx, jqw, jws, jnp.asarray(b), x_scale=xs))
    got = F.quantized_fully_connected(
        tx, tqw, tws, torch.from_numpy(b),
        x_scale=None if xs is None else torch.tensor(xs)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 7, 40)
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
        return
    # the size of the fp32 sums: |q_x| |q_w|^T, rescaled
    qmax = tq._QMAX[mode]
    xf = np.asarray(jx.astype(jnp.float32)).reshape(-1, 64)
    x_scale = xs if xs is not None else max(np.abs(xf).max(), 1e-8) / qmax
    terms = (np.abs(np.clip(xf / x_scale, -qmax, qmax))
             @ np.abs(np.asarray(jqw.astype(jnp.float32))).T)
    terms = terms.reshape(4, 7, 40) * x_scale * np.asarray(jws).reshape(-1)
    assert np.all(np.abs(got - want) <= 1e-6 * terms + 1e-7)


def test_lowbit_routes_pad_and_keep_the_shape():
    """Rows below 17 and widths off 16 are padded with zeros inside the
    product and cut away after it: the result equals the exact integer
    product."""
    rng = np.random.RandomState(6)
    a = rng.randint(-127, 128, (3, 24)).astype(np.int8)
    w = rng.randint(-127, 128, (5, 24)).astype(np.int8)
    got = tq.lowbit_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)
    assert tq.fp8_supported("e4m3", "cpu") and tq.fp8_supported("e5m2", "cpu")
    assert not tq.fp8_supported("e3m4", "cpu")
    with pytest.raises(ValueError):
        tq.quant_dtype("int4")


@pytest.mark.parametrize("mode", MODES)
def test_quantize_model_keeps_the_jax_names_dtypes_and_grad_req(
        jax_trace_state, mode):  # noqa: F811
    jm = jax_gpt(True)
    jq.quantize_model(jm, mode=mode)
    tm = port_gpt_from(jax_gpt(True))
    tq.quantize_model(tm, mode=mode)
    jnames = {n: str(np.asarray(p.data()._data).dtype)
              for n, p in jm._collect_params_with_prefix().items()}
    tnames = {n: str(p._tensor().dtype).replace("torch.", "")
              for n, p in tm._collect_params_with_prefix().items()}
    assert tnames == jnames
    layers = tq._quantized_layers(tm, [])
    assert len(layers) == 4 * 2
    for layer in layers:
        for p in layer.collect_params().values():
            assert p.grad_req == "null" and not p._tensor().requires_grad
    st = tq.stats()
    assert st["mode"] == mode and st["quantized_layers"] == 8
    assert st["weight_bytes_quantized"] < st["weight_bytes_fp32"]
    # idempotent: a second call keeps the quantized layers
    tq.quantize_model(tm, mode=mode)
    assert tq._quantized_layers(tm, []) == layers


def _mlp(pkg_nn):
    """Dense 32 -> 24 -> 16 -> 8, no activation."""
    net = pkg_nn.HybridSequential()
    with net.name_scope():
        for n_in, n_out in ((32, 24), (24, 16), (16, 8)):
            net.add(pkg_nn.Dense(n_out, flatten=False, in_units=n_in))
    return net


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calibration_thresholds_equal_jax(jax_trace_state, mode):  # noqa
    """Three stacked Dense (no activation, so each layer's input is the
    previous layer's quantized output, equal in both packages): every
    frozen activation scale equals JAX's."""
    jnet = _mlp(mx.gluon.nn)
    jnet.initialize()
    tnet = from_jax_params(_mlp(tnn), jax_params(jnet))
    rng = np.random.RandomState(7)
    batches = [rng.randn(5, 32).astype(np.float32) * (i + 1)
               for i in range(3)]
    jq.quantize_model(jnet)
    jq.calibrate_model(jnet, [mx.nd.array(b) for b in batches], mode=mode,
                       num_bins=2001)
    tq.quantize_model(tnet)
    tq.calibrate_model(tnet, batches, mode=mode, num_bins=2001)
    jl, tl = jq._quantized_layers(jnet, []), tq._quantized_layers(tnet, [])
    assert [float(np.float32(j._x_scale)) for j in jl] == \
        [float(t._x_scale) for t in tl]
    assert tq.stats()["calib_mode"] == mode
    x = rng.randn(5, 32).astype(np.float32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jnet(mx.nd.array(x)).asnumpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tq.calibrate_model(tnet, [], mode=mode)


@pytest.mark.parametrize("mode", ["int8", "e4m3"])
def test_quantized_parameter_files_cross_both_ways(jax_trace_state, mode,
                                                   tmp_path):  # noqa: F811
    jm = jax_gpt(True)
    jq.quantize_model(jm, mode=mode)
    jpath = str(tmp_path / "jax.params")
    jm.save_parameters(jpath)
    tm = port_gpt_from(jax_gpt(True))
    tq.quantize_model(tm, mode=mode)  # another model's quantized weights
    tm.load_parameters(jpath, ctx="cpu")
    jp = jm._collect_params_with_prefix()
    tp = tm._collect_params_with_prefix()
    for name, p in tp.items():
        np.testing.assert_array_equal(_bits(p._tensor()),
                                      _bits(jp[name].data()._data))
    # and back: the port's file into a fresh quantized JAX model
    tpath = str(tmp_path / "port.params")
    tm.save_parameters(tpath)
    jm2 = jax_gpt(True)
    jq.quantize_model(jm2, mode=mode)
    jm2.load_parameters(tpath)
    for name, p in jm2._collect_params_with_prefix().items():
        np.testing.assert_array_equal(_bits(p.data()._data),
                                      _bits(tp[name]._tensor()))
    # from_jax_params carries them too
    tm3 = port_gpt_from(jax_gpt(True))
    tq.quantize_model(tm3, mode=mode)
    from_jax_params(tm3, jax_params(jm))
    for name, p in tm3._collect_params_with_prefix().items():
        np.testing.assert_array_equal(_bits(p._tensor()),
                                      _bits(jp[name].data()._data))


# the served rows against the JAX server's: both quantize the same fp32
# weights bit-equally, then differ only in the fp32 parts (LayerNorm,
# GELU, softmax: a few ulps, 7e-7 on most rows), except where such an ulp
# flips an activation's rounding at .5, which moves a quantized layer's
# output by one step x_scale * w_scale * |w| <= x_scale * max|w| (about
# 2e-3 here: x_scale near 4/127, max|w| 0.07); the limit is ten such steps
# (the worst row, with flips, reads 9.1e-3)
SERVE_TOL = 2e-2


def test_model_server_int8_equals_direct_and_jax_server(
        jax_trace_state):  # noqa: F811
    jm = jax_bert(False)
    tm = port_bert_from(jm)
    direct_m = port_bert_from(jm)
    tq.quantize_model(direct_m)
    tok, tt, vl = bert_inputs(8, 5)
    with torch.no_grad():
        direct = [o.numpy() for o in direct_m(torch.from_numpy(tok),
                                              torch.from_numpy(tt),
                                              torch.from_numpy(vl))]
    jsrv = jserve.ModelServer(jm, SPECS, buckets=(1, 4), max_wait_ms=1.0,
                              quantize="int8")
    with ModelServer(tm, SPECS, buckets=(1, 4), max_wait_ms=1.0,
                     device="cpu", quantize="int8") as srv:
        got = [srv.predict(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
               for i in range(5)]
        stats = srv.stats()
    with jsrv:
        want = [jsrv.predict(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
                for i in range(5)]
    assert stats["quantize"] == "int8" and stats["errors"] == 0
    assert tq._quantized_layers(tm, [])
    for i, (outs, jouts) in enumerate(zip(got, want)):
        n = vl[i]
        # a row is computed alone (bucket 1), as the direct forward's
        # batch of 5 quantizes its activations per tensor over all rows:
        # compare each with its own batch-1 direct forward
        with torch.no_grad():
            one = [o.numpy() for o in direct_m(
                torch.from_numpy(tok[i:i + 1]), torch.from_numpy(tt[i:i + 1]),
                torch.from_numpy(vl[i:i + 1]))]
        for o, d in zip(outs, one):
            np.testing.assert_array_equal(o, d)
        np.testing.assert_allclose(outs[0][0, :n],
                                   np.asarray(jouts[0])[0, :n],
                                   atol=SERVE_TOL, rtol=0)
        for k in (1, 2):
            np.testing.assert_allclose(outs[k], np.asarray(jouts[k]),
                                       atol=SERVE_TOL, rtol=0)
    assert direct[0].shape == (5, SEQ, SMALL_BERT["units"])


def test_model_server_calibrates_before_serving():
    """calib_mode freezes a static scale in every quantized layer before
    the pool is built; the served rows equal the calibrated model's own
    forward."""
    from mxnet_tpu_torch.models.bert import BERTModel

    tm = BERTModel(**SMALL_BERT)
    tm.initialize(device="cpu")
    tok, tt, vl = bert_inputs(9, 4)
    calib = [(tok, tt, vl)]
    with ModelServer(tm, SPECS, buckets=(4,), device="cpu", quantize="int8",
                     calib_mode="naive", calib_data=calib) as srv:
        got = srv.predict(tok, tt, vl)
    layers = tq._quantized_layers(tm, [])
    assert layers and all(l._x_scale is not None for l in layers)
    with torch.no_grad():
        want = tm(torch.from_numpy(tok), torch.from_numpy(tt),
                  torch.from_numpy(vl))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_fp8_modes_gate_on_the_probe(monkeypatch):
    from mxnet_tpu_torch.models.bert import BERTModel

    monkeypatch.setitem(tq._FP8_SUPPORT, ("e5m2", "cpu"), False)
    tm = BERTModel(**SMALL_BERT)
    tm.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="e5m2"):
        tq.quantize_model(tm, mode="e5m2")
    with pytest.raises(ValueError):
        tq.quantize_model(tm, mode="int4")
    assert jax.devices()[0].platform == "cpu"
