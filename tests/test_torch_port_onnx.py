"""``mxnet_tpu_torch.onnx`` against the JAX package's ``onnx`` (mirrors
tests/test_onnx.py and test_onnx_extended.py's BERT and GPT round trips,
at small sizes): the port's wire codec writes the JAX codec's bytes; the
port's export of a small CNN, a small BERT and a small GPT, on weights
carried from the JAX model, holds the same nodes, attributes and
initializer values as the JAX export (value names compared up to
renaming); a JAX-written file imported into the port and a port-written
file imported into the JAX package give the source model's outputs
within fp32 1e-4 relative, 1e-5 absolute (test_onnx.py's CNN tolerance;
2e-4/2e-5 for BERT and GPT, test_onnx_extended.py's); and the
torch-exported fixture imports as tests/test_onnx_external.py holds it."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import onnx as jonnx
from mxnet_tpu.onnx import proto as JP
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch import onnx as tonnx
from mxnet_tpu_torch.onnx import proto as P
from torch_port_helpers import (jax_params, jax_trace_state,  # noqa: F401
                                same_block_names)

CPU = torch.device("cpu")
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
BERT = dict(vocab_size=53, token_type_vocab_size=2, units=16, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, max_length=12,
            use_decoder=False, use_classifier=False)
GPT = dict(vocab_size=41, units=16, num_layers=2, num_heads=2, max_length=10,
           dropout=0.0)


def test_codec_writes_the_jax_codecs_bytes():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    t, jt = P.tensor_proto("w", arr), JP.tensor_proto("w", arr)
    assert t.tobytes() == jt.tobytes()
    attrs = {"kernel_shape": [3, 3], "group": 1, "alpha": 0.5,
             "mode": "constant", "axis": -1}
    n = P.node_proto("Conv", ["x", "w"], ["y"], "conv0", attrs)
    assert n.tobytes() == JP.node_proto("Conv", ["x", "w"], ["y"], "conv0",
                                        attrs).tobytes()
    d = P.parse_node(n.tobytes())
    assert d["op"] == "Conv" and d["attrs"]["kernel_shape"] == [3, 3]
    assert d["attrs"]["axis"] == -1 and abs(d["attrs"]["alpha"] - 0.5) < 1e-6
    g = P.graph_proto("g", [n], [P.value_info("x", np.float32,
                                              (1, 3, "H", 224))],
                      [P.value_info("y", np.float32, (1, 8))], [t])
    md = P.parse_model(P.model_proto(g, opset=13).tobytes())
    assert md["opset"] == 13
    assert md["graph"]["inputs"][0]["shape"] == [1, 3, "H", 224]
    name, back = P.parse_tensor(t.tobytes())
    assert name == "w"
    np.testing.assert_array_equal(back, arr)


def test_codec_reads_packed_fields_and_bf16():
    m = P.Msg()
    m.packed_varints(1, [2, 3, 4])
    m.varint(2, P.FLOAT)
    m.bytes_(8, "w")
    m.bytes_(9, np.zeros((2, 3, 4), "<f4").tobytes())
    name, arr = P.parse_tensor(m.tobytes())
    assert name == "w" and arr.shape == (2, 3, 4)
    a = P.Msg()
    a.bytes_(1, "kernel_shape")
    a.packed_varints(8, [3, 3])
    a.varint(20, P.ATTR_INTS)
    assert P.parse_attr(a.tobytes()) == ("kernel_shape", [3, 3])
    # a bfloat16 initializer decodes to the same values in both codecs
    import ml_dtypes

    bf = np.array([1.5, -2.25, 3.0e-3], ml_dtypes.bfloat16)
    _, mine = P.parse_tensor(JP.tensor_proto("b", bf).tobytes())
    _, theirs = JP.parse_tensor(P.tensor_proto("b", bf).tobytes())
    np.testing.assert_array_equal(np.asarray(mine, np.float32),
                                  np.asarray(bf, np.float32))
    np.testing.assert_array_equal(np.asarray(theirs, np.float32),
                                  np.asarray(bf, np.float32))


def _canonical(buf):
    """The model's nodes (op, inputs, outputs, attrs) and initializers,
    every value name that is not a graph input or a parameter renamed to
    its order of first appearance."""
    g = P.parse_model(buf)["graph"]
    fixed = {vi["name"] for vi in g["inputs"]}
    names = {}

    def canon(n):
        if n in fixed or n == "":
            return n
        return names.setdefault(n, "v%d" % len(names))

    inits = dict(g["initializers"])
    param_names = {n for n in inits if not n.endswith(tuple(
        "_%d" % i for i in range(10)))}
    nodes = []
    for node in g["nodes"]:
        attrs = {}
        for k, v in node["attrs"].items():
            attrs[k] = np.asarray(v).tolist() if isinstance(
                v, np.ndarray) else v
        nodes.append((node["op"],
                      [n if n in param_names else canon(n)
                       for n in node["inputs"]],
                      [canon(n) for n in node["outputs"]], attrs))
    return nodes, {(n if n in param_names else canon(n)): a
                   for n, a in inits.items()}, [canon(o["name"])
                                                for o in g["outputs"]]


def _assert_same_graph(mine, theirs):
    a_nodes, a_init, a_out = _canonical(mine)
    b_nodes, b_init, b_out = _canonical(theirs)
    assert [n[0] for n in a_nodes] == [n[0] for n in b_nodes]
    assert a_nodes == b_nodes
    assert a_out == b_out
    assert sorted(a_init) == sorted(b_init)
    for k in a_init:
        assert a_init[k].dtype == b_init[k].dtype, k
        np.testing.assert_array_equal(a_init[k], b_init[k], err_msg=k)


def _cnn(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Conv2D(8, 3, padding=1), pkg.gluon.nn.BatchNorm(),
            pkg.gluon.nn.Activation("relu"), pkg.gluon.nn.MaxPool2D(2),
            pkg.gluon.nn.Conv2D(16, 3, padding=1),
            pkg.gluon.nn.LeakyReLU(0.1), pkg.gluon.nn.GlobalAvgPool2D(),
            pkg.gluon.nn.Flatten(), pkg.gluon.nn.Dense(32),
            pkg.gluon.nn.Activation("tanh"), pkg.gluon.nn.Dropout(0.5),
            pkg.gluon.nn.Dense(10))
    return net


def _carry(tnet, jnet):
    """The JAX model's weights into the port's, by name (both packages
    name the blocks alike under ``same_block_names``; the CNN's layers sit
    under no root prefix, which ``from_jax_params`` needs)."""
    theirs = jax_params(jnet)
    mine = {p.name: p for p in tnet.collect_params().values()}
    assert sorted(mine) == sorted(theirs)
    for name, p in mine.items():
        p.set_data(torch.from_numpy(np.array(theirs[name])))


def _pair_models(kind):
    """(JAX model, the port's on the CPU with its weights, the inputs as
    numpy, export kwargs)."""
    import mxnet_tpu_torch as tmx

    rng = np.random.default_rng(0)
    if kind == "cnn":
        jnet, tnet = _cnn(jmx), _cnn(tmx)
        ins = [rng.normal(size=(2, 3, 16, 16)).astype(np.float32)]
        kw = dict(input_shapes={"data": (2, 3, 16, 16)})
    elif kind == "bert":
        from mxnet_tpu.models.bert import BERTModel as JB
        from mxnet_tpu_torch.models.bert import BERTModel as TB

        jnet, tnet = JB(**BERT), TB(**BERT)
        ins = [rng.integers(0, 53, (2, 8)).astype(np.int32),
               rng.integers(0, 2, (2, 8)).astype(np.int32),
               np.array([8, 5], np.float32)]
        kw = dict(input_shapes=[(2, 8), (2, 8), (2,)],
                  input_types=[np.int32, np.int32, np.float32],
                  input_names=("inputs", "token_types", "valid_length"))
    else:
        from mxnet_tpu.models.gpt import GPTModel as JG
        from mxnet_tpu_torch.models.gpt import GPTModel as TG

        jnet, tnet = JG(**GPT), TG(**GPT)
        ins = [rng.integers(0, 41, (2, 7)).astype(np.int32)]
        kw = dict(input_shapes=[(2, 7)], input_types=[np.int32],
                  input_names=("tokens",))
    jnet.initialize()
    jout = jnet(*[jmx.nd.array(a, dtype=a.dtype) for a in ins])
    with tmx.cpu():
        tnet.initialize()
    _carry(tnet, jnet)
    jout = jout if isinstance(jout, (list, tuple)) else [jout]
    return jnet, tnet, ins, kw, [o.asnumpy() for o in jout]


TOL = {"cnn": dict(rtol=1e-4, atol=1e-5), "bert": dict(rtol=2e-4, atol=2e-5),
       "gpt": dict(rtol=2e-4, atol=2e-5)}


def _port_run(blk, ins):
    with torch.no_grad():
        out = blk(*[nd.array(a, dtype=a.dtype, ctx=CPU) for a in ins])
    out = out if isinstance(out, (list, tuple)) else [out]
    return [o.asnumpy() for o in out]


@pytest.mark.parametrize("kind", ["cnn", "bert", "gpt"])
def test_port_export_is_the_jax_export(kind, same_block_names,
                                       jax_trace_state):
    jnet, tnet, ins, kw, jout = _pair_models(kind)
    theirs = jonnx.export_model(jnet, **kw)
    mine = tonnx.export_model(tnet, **kw)
    _assert_same_graph(mine, theirs)


@pytest.mark.parametrize("kind", ["cnn", "bert", "gpt"])
def test_files_cross_between_the_packages(kind, same_block_names,
                                          jax_trace_state):
    jnet, tnet, ins, kw, jout = _pair_models(kind)
    # a JAX-written file, served by the port
    blk = tonnx.import_to_gluon(jonnx.export_model(jnet, **kw), ctx=CPU)
    got = _port_run(blk, ins)
    assert len(got) == len(jout)
    for g, w in zip(got, jout):
        np.testing.assert_allclose(g, w, **TOL[kind])
    # a port-written file, served by the JAX package
    tout = _port_run(tnet, ins)
    jblk = jonnx.import_to_gluon(tonnx.export_model(tnet, **kw))
    back = jblk(*[jmx.nd.array(a, dtype=a.dtype) for a in ins])
    back = back if isinstance(back, (list, tuple)) else [back]
    for g, w in zip(back, tout):
        np.testing.assert_allclose(g.asnumpy(), w, **TOL[kind])


def test_import_model_splits_args_and_aux(tmp_path):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, 3), gluon.nn.BatchNorm(), gluon.nn.Dense(3))
    import mxnet_tpu_torch as tmx

    x = np.random.default_rng(1).normal(size=(2, 3, 8, 8)).astype(np.float32)
    with tmx.cpu():
        net.initialize()
        y = net(nd.array(x)).asnumpy()
    path = str(tmp_path / "m.onnx")
    assert tonnx.export_model(net, input_shapes={"data": x.shape},
                              onnx_file=path) == path
    sym, args, aux = tonnx.import_model(path)
    assert len(args) == 6 and len(aux) == 2  # conv, BN gamma/beta, dense
    assert all(isinstance(v, np.ndarray) for v in {**args, **aux}.values())
    blk = tonnx.import_to_gluon(path, ctx=CPU)
    assert blk._active
    np.testing.assert_allclose(_port_run(blk, [x])[0], y, rtol=1e-4,
                               atol=1e-5)


def test_import_to_gluon_needs_a_device_without_cuda():
    from mxnet_tpu_torch.base import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    net = gluon.nn.Dense(3, in_units=4)
    import mxnet_tpu_torch as tmx

    with tmx.cpu():
        net.initialize()
    buf = tonnx.export_model(net, input_shapes={"data": (1, 4)})
    with pytest.raises(DeviceError):
        tonnx.import_to_gluon(buf)


def test_layernorm_imports_as_the_ports_layernorm_op():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.models.bert import BERTModel as TB

    with tmx.cpu():
        net = TB(**BERT)
        net.initialize()
    buf = tonnx.export_model(
        net, input_shapes=[(2, 8), (2, 8), (2,)],
        input_types=[np.int32, np.int32, np.float32],
        input_names=("inputs", "token_types", "valid_length"))
    ops = [n["op"] for n in P.parse_model(buf)["graph"]["nodes"]]
    assert ops.count("LayerNormalization") == 1 + 2 * BERT["num_layers"]
    sym, _, _ = tonnx.import_model(buf)
    seen, stack, n_ln = set(), [sym], 0
    while stack:
        s = stack.pop()
        if id(s) in seen:
            continue
        seen.add(id(s))
        n_ln += s._op == "LayerNorm"
        stack.extend(s._inputs)
    assert n_ln == 1 + 2 * BERT["num_layers"]


@pytest.mark.skipif(not os.path.exists(os.path.join(FIXDIR, "torch_cnn.onnx")),
                    reason="fixture missing: tools/gen_torch_onnx_fixture.py")
def test_torch_exported_fixture_matches_its_npz():
    ref = np.load(os.path.join(FIXDIR, "torch_cnn.npz"))
    blk = tonnx.import_to_gluon(os.path.join(FIXDIR, "torch_cnn.onnx"),
                                ctx=CPU)
    np.testing.assert_allclose(_port_run(blk, [ref["x"]])[0], ref["y"],
                               rtol=1e-4, atol=1e-5)
    sym, args, aux = tonnx.import_model(os.path.join(FIXDIR,
                                                     "torch_cnn.onnx"))
    assert args and aux
