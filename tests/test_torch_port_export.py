"""``HybridBlock.export``, ``SymbolBlock`` and serving from the export
layout, against the JAX package on the same weights and numpy inputs: a
2-layer BERT and ``gpt_nano`` export the same op multiset in both packages
(the port's ``.contiguous()`` calls add no node); each package loads the
other's files and the outputs agree within fp32 1e-5; a bf16 export
reloads as bf16; ``save_for_serving`` -> ``serve.load`` -> ``ModelServer``
rows agree with the JAX server's; a ModelServer snapshot is read both
ways; and the batch an export bakes into its reshapes fails the same way
in both packages (ROADMAP.md C.2)."""
import collections
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon.block import SymbolBlock as JaxSymbolBlock
from mxnet_tpu.models.bert import BERTModel as JaxBERT
from mxnet_tpu.models.gpt import gpt_nano as jax_gpt_nano
from mxnet_tpu_torch import checkpoint, serve
from mxnet_tpu_torch.convert import from_jax_params
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.models.bert import BERTModel
from mxnet_tpu_torch.models.gpt import gpt_nano
from mxnet_tpu_torch.serve import ModelServer
from torch_port_helpers import (jax_params, jax_trace_state,  # noqa: F401
                                jax_trace_state_module)

BERT = dict(vocab_size=100, units=32, hidden_size=64, num_layers=2,
            num_heads=2, max_length=16, dropout=0.0)
NAMES = ["data", "tt", "vl"]
SHAPES = [(2, 16), (2, 16), (2,)]


def _bert_inputs(batch=2, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, 100, (batch, 16)).astype(np.int32)
    tt = rng.randint(0, 2, (batch, 16)).astype(np.int32)
    vl = rng.randint(1, 17, (batch,)).astype(np.int32)
    return tok, tt, vl


def _ops(sym_file):
    with open(sym_file) as f:
        return collections.Counter(n["op"] for n in json.load(f)["nodes"])


@pytest.fixture(scope="module")
def bert_exports(tmp_path_factory, jax_trace_state_module):
    """The JAX BERT and the port's with its weights, each exported at
    batch 2, and the JAX model's outputs on the inputs."""
    d = tmp_path_factory.mktemp("bert")
    jnet = JaxBERT(**BERT)
    jnet.initialize()
    tok, tt, vl = _bert_inputs()
    jout = jnet(*(jmx.nd.array(a, dtype="int32") for a in (tok, tt, vl)))
    jnet.export(str(d / "jax"), 0, input_names=NAMES, input_shapes=SHAPES)
    pnet = from_jax_params(BERTModel(**BERT), jax_params(jnet))
    pnet.export(str(d / "port"), 0, input_names=NAMES, input_shapes=SHAPES)
    return d, [o.asnumpy() for o in jout]


def test_bert_export_op_multiset_equals_the_jax_export(bert_exports):
    d, _ = bert_exports
    assert _ops(d / "port-symbol.json") == _ops(d / "jax-symbol.json")


@pytest.mark.parametrize("which", ["jax", "port"])
def test_bert_export_loads_in_both_packages(bert_exports, which):
    d, want = bert_exports
    sym_file, params = (str(d / ("%s-symbol.json" % which)),
                        str(d / ("%s-0000.params" % which)))
    tok, tt, vl = _bert_inputs()
    blk = SymbolBlock.imports(sym_file, NAMES, params, ctx="cpu")
    got = blk(*(torch.from_numpy(a) for a in (tok, tt, vl)))
    jblk = JaxSymbolBlock.imports(sym_file, NAMES, params)
    jgot = jblk(*(jmx.nd.array(a, dtype="int32") for a in (tok, tt, vl)))
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5)
        np.testing.assert_allclose(j.asnumpy(), w, atol=1e-5)


def test_baked_export_batch_fails_in_both_packages(bert_exports):
    d, _ = bert_exports
    tok, tt, vl = _bert_inputs(batch=3)
    sym_file, params = str(d / "port-symbol.json"), str(d / "port-0000.params")
    blk = SymbolBlock.imports(sym_file, NAMES, params, ctx="cpu")
    with pytest.raises(RuntimeError, match="shape '\\[2, 16, 3, 2, 16\\]'"):
        blk(*(torch.from_numpy(a) for a in (tok, tt, vl)))
    jblk = JaxSymbolBlock.imports(sym_file, NAMES, params)
    with pytest.raises(TypeError, match="\\(2, 16, 3, 2, 16\\)"):
        jblk(*(jmx.nd.array(a, dtype="int32") for a in (tok, tt, vl)))


def test_gpt_nano_export_both_ways(tmp_path, jax_trace_state):
    jnet = jax_gpt_nano()
    jnet.initialize()
    tok = np.random.RandomState(1).randint(0, 256, (2, 8)).astype(np.int32)
    want = jnet(jmx.nd.array(tok, dtype="int32")).asnumpy()
    jnet.export(str(tmp_path / "jax"), 0, input_shapes=[(2, 8)])
    pnet = from_jax_params(gpt_nano(), jax_params(jnet))
    pnet.export(str(tmp_path / "port"), 0, input_shapes=[(2, 8)])
    ops = _ops(tmp_path / "port-symbol.json")
    assert ops == _ops(tmp_path / "jax-symbol.json")
    assert ops["LayerNorm"] == 5 and ops["scaled_dot_attention"] == 2
    for which in ("jax", "port"):
        f = (str(tmp_path / ("%s-symbol.json" % which)),
             str(tmp_path / ("%s-0000.params" % which)))
        got = SymbolBlock.imports(*f[:1], ["data"], f[1], ctx="cpu")(
            torch.from_numpy(tok))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
        jgot = JaxSymbolBlock.imports(f[0], ["data"], f[1])(
            jmx.nd.array(tok, dtype="int32"))
        np.testing.assert_allclose(jgot.asnumpy(), want, atol=1e-5)


def test_bf16_export_reloads_as_bf16(tmp_path):
    from mxnet_tpu_torch import amp

    net = gpt_nano()
    net.initialize(device="cpu")
    amp.convert_hybrid_block(net, "bfloat16")
    tok = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, 8)).astype(np.int32))
    want = net(tok)
    sf, pf = checkpoint.save_for_serving(str(tmp_path / "m"), net,
                                         input_shapes=[(2, 8)])
    blk = checkpoint.load_for_serving(str(tmp_path / "m"), ctx="cpu")
    dtypes = {p.name: p._tensor().dtype
              for p in blk.collect_params().values()}
    for p in net.collect_params().values():
        assert dtypes[p.name] == p._tensor().dtype
    assert torch.bfloat16 in dtypes.values()
    got = blk(tok)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    # spliced into an enclosing trace, and its two refusals
    from mxnet_tpu_torch import sym

    out = blk(sym.var("tokens"))
    assert "tokens" in out.list_arguments()
    with pytest.raises(TypeError, match="ALL inputs"):
        blk(sym.var("a"), tok)
    with pytest.raises(TypeError, match="1 inputs|graph has 1"):
        blk(sym.var("a"), sym.var("b"))


def test_served_export_rows_agree_with_the_jax_server(bert_exports,
                                                      tmp_path):
    d, _ = bert_exports
    specs = [((16,), "int32"), ((16,), "int32"), ((), "int32")]
    tok, tt, vl = _bert_inputs(batch=2, seed=5)
    blk = serve.load(str(d / "jax"), input_names=NAMES, ctx="cpu")
    srv = ModelServer(blk, specs, buckets=(2,), device="cpu")
    assert srv.stats()["captures"] == 1
    got = srv.predict(tok, tt, vl)
    assert srv.stats()["captures"] == 1
    jblk = jserve.load(str(d / "jax"), input_names=NAMES)
    jsrv = jserve.ModelServer(jblk, specs, buckets=(2,))
    want = jsrv.predict(tok, tt, vl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    # the ModelServer snapshot, both ways
    serve.snapshot(srv, str(tmp_path / "p"))
    jserve.snapshot(jsrv, str(tmp_path / "j"), input_names=NAMES)
    back = jserve.load(str(tmp_path / "p"), snapshot=True)
    pback = serve.load(str(tmp_path / "j"), snapshot=True, device="cpu")
    for server in (back, pback):
        for g, w in zip(server.predict(tok, tt, vl), want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-5)
    for s in (srv, jsrv, back, pback):
        s.stop()
