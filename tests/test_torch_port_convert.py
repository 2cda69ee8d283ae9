"""The port's pretrained converters against the JAX package's
(``gluon/model_zoo/convert.py``) and against the torch reference models.

torchvision is not installed: the state dicts come from the reference
models in ``tools/torch_*_ref.py``, whose keys are torchvision's. For each
family the port's ``{structural name: array}`` equals the JAX converter's
bit for bit (the JAX mapping is caught where its ``load_pretrained`` hands
it to ``apply_converted``), ``get_model(name, pretrained="x.pth")`` loads
it (every family but VGG, whose 120M-parameter classifier goes through
``apply_converted`` in memory), and the logits match the torch model's at
the JAX tests' tolerances. The refusals raise as the JAX ones do.
``transformers`` is not installed either: the HF BERT and GPT-2 state
dicts are synthetic, with HF's key names, at the small config of
``tests/test_pretrained_convert.py``; after the transplants both packages
hold equal parameters and their forwards agree.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import convert as jconvert
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.gluon.model_zoo import convert, model_store, vision
from torch_port_helpers import (few_threads, jax_rng_kept,  # noqa: F401
                                jax_trace_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

pytestmark = pytest.mark.usefixtures("few_threads", "jax_rng_kept")


def _torch_logits(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.tensor(x)).numpy()


def _port_logits(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x)).detach().numpy()


def _jax_mapping(monkeypatch, name, path, classes):
    """The mapping the JAX package's load_pretrained writes for ``path``."""
    seen = {}

    def capture(net, mapping, strict=True):
        seen.update(mapping)
        return net

    monkeypatch.setattr(jconvert, "apply_converted", capture)
    jconvert.load_pretrained(jvision.get_model(name, classes=classes), path,
                             name)
    return seen


def _same_mapping(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _resnet18():
    import torch_resnet_ref as r
    return r.randomize_bn_stats(r.resnet18(num_classes=11))


def _resnet50():
    import torch_resnet_ref as r
    return r.randomize_bn_stats(r.resnet50(num_classes=11))


def _mobilenet():
    import torch_mobilenet_ref as r
    return r.randomize_bn_stats(r.mobilenet_v2(num_classes=9), seed=2)


def _alexnet():
    import torch_alexnet_ref as r
    return r.alexnet(num_classes=6)


def _squeezenet(ver):
    import torch_squeezenet_ref as r
    return getattr(r, "squeezenet" + ver.replace(".", "_"))(num_classes=8)


def _densenet():
    import torch_densenet_ref as r
    return r.randomize_bn_stats(r.densenet121(num_classes=5), seed=8)


def _inception():
    import torch_inception_ref as r
    return r.randomize_bn_stats(r.inception_v3(num_classes=4), seed=9)


# (zoo name, torch model, classes, input size, input scale, rtol, atol)
FAMILIES = {
    "resnet18_v1": (_resnet18, 11, 64, 1.0, 1e-3, 1e-4),
    "resnet50_v1b": (_resnet50, 11, 64, 1.0, 1e-3, 1e-4),
    "mobilenet_v2_tv": (_mobilenet, 9, 64, 1.0, 1e-3, 1e-4),
    "alexnet": (_alexnet, 6, 224, 0.1, 1e-3, 1e-4),
    "squeezenet1.0": (lambda: _squeezenet("1.0"), 8, 224, 0.1, 1e-3, 1e-4),
    "squeezenet1.1": (lambda: _squeezenet("1.1"), 8, 224, 0.1, 1e-3, 1e-4),
    "densenet121": (_densenet, 5, 64, 1.0, 2e-3, 2e-4),
    "inceptionv3": (_inception, 4, 299, 0.1, 2e-3, 2e-4),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_converts_like_jax_and_matches_torch(name, tmp_path,
                                                    monkeypatch,
                                                    jax_trace_state):  # noqa: F811
    make, classes, size, scale, rtol, atol = FAMILIES[name]
    torch.manual_seed(0)
    tm = make()
    state = tm.state_dict()
    if name == "inceptionv3":  # real checkpoints carry the aux head
        state["AuxLogits.conv0.conv.weight"] = torch.zeros(1)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               path)
    want = _jax_mapping(monkeypatch, name, path, classes)
    net = vision.get_model(name, pretrained=path, classes=classes, ctx="cpu")
    got = convert.converted_mapping(net, convert.load_torch_state(path),
                                    name, path)
    _same_mapping(got, want)
    params = net._collect_params_with_prefix()
    for k, a in got.items():
        np.testing.assert_array_equal(params[k]._tensor().detach().numpy(), a,
                                      err_msg=k)
    x = (np.random.default_rng(3).normal(size=(1, 3, size, size))
         * scale).astype(np.float32)
    np.testing.assert_allclose(_port_logits(net, x), _torch_logits(tm, x),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("bn", [False, True])
def test_vgg11_converts_like_jax_and_matches_torch(bn, monkeypatch):
    import torch_vgg_ref as tvref

    torch.manual_seed(4)
    tm = tvref.vgg(11, batch_norm=bn, num_classes=7)
    if bn:
        tvref.randomize_bn_stats(tm, seed=4)
    name = "vgg11_bn" if bn else "vgg11"
    state = tm.state_dict()
    seen = {}
    monkeypatch.setattr(jconvert, "apply_converted",
                        lambda net, m, strict=True: seen.update(m))
    monkeypatch.setattr(jconvert, "load_torch_state", lambda p: state)
    jconvert.load_pretrained(jvision.get_model(name, classes=7), "x.pth",
                             name)
    net = vision.get_model(name, classes=7)
    got = convert.converted_mapping(net, state, name)
    _same_mapping(got, seen)
    convert.apply_converted(net, got, ctx="cpu")
    x = (np.random.default_rng(4).normal(size=(1, 3, 224, 224))
         * 0.1).astype(np.float32)
    np.testing.assert_allclose(_port_logits(net, x), _torch_logits(tm, x),
                               rtol=2e-3, atol=2e-4)


def test_refusals_like_jax(tmp_path):
    import torch_resnet_ref as tref

    ckpt = str(tmp_path / "r50.pth")
    torch.save(tref.resnet50(num_classes=3).state_dict(), ckpt)
    with pytest.raises(ValueError, match="v1b"):
        vision.get_model("resnet50_v1", pretrained=ckpt, classes=3,
                         ctx="cpu")
    with pytest.raises(ValueError, match="v1b"):
        jconvert.load_pretrained(jvision.get_model("resnet50_v1", classes=3),
                                 ckpt, "resnet50_v1")
    with pytest.raises(ValueError, match="no v2"):
        vision.get_model("resnet50_v2", pretrained=ckpt, classes=3,
                         ctx="cpu")
    torch.save({"features.0.weight": torch.zeros(1)}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="no torch converter"):
        convert.load_pretrained(vision.get_model("resnet18_v1"),
                                str(tmp_path / "x.pth"), "mystery_model")
    with pytest.raises(ValueError, match="model store"):
        vision.get_model("resnet18_v1", pretrained=True)
    with pytest.raises(ValueError, match="extension"):
        vision.get_model("resnet18_v1", pretrained="w.ckpt", ctx="cpu")
    # a checkpoint that does not cover the network is refused (strict)
    with pytest.raises(KeyError, match="does not cover"):
        convert.apply_converted(vision.get_model("resnet18_v1"),
                                {"features.0.weight": np.zeros(1)}, ctx="cpu")


def test_cli_and_model_store(tmp_path, monkeypatch):
    import torch_resnet_ref as tref

    torch.manual_seed(1)
    tm = tref.randomize_bn_stats(tref.resnet18(num_classes=1000), seed=1)
    ckpt, out = str(tmp_path / "r18.pth"), str(tmp_path / "r18.params")
    torch.save(tm.state_dict(), ckpt)
    convert._main(["resnet18_v1", ckpt, out, "--device", "cpu"])
    assert os.path.exists(out + ".mxnet-store")
    net = vision.get_model("resnet18_v1", pretrained=out, ctx="cpu")
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 64)).astype(
        np.float32)
    np.testing.assert_allclose(_port_logits(net, x), _torch_logits(tm, x),
                               rtol=1e-3, atol=1e-4)
    with pytest.raises(FileNotFoundError, match="convert"):
        model_store.get_model_file("resnet34_v1", root=str(tmp_path))
    assert model_store.get_model_file("r18", root=str(tmp_path)) == out
    (tmp_path / "hand_placed.params").write_bytes(b"y")
    (tmp_path / "orphan.params.mxnet-store").write_bytes(b"")
    with pytest.warns(UserWarning, match="unmanaged"):
        model_store.purge(root=str(tmp_path))
    assert sorted(p.name for p in tmp_path.glob("*.params")) == \
        ["hand_placed.params"]
    assert not list(tmp_path.glob("*.mxnet-store"))


BERT_CFG = dict(vocab=83, hidden=32, layers=2, heads=4, inter=64, pos=16,
                types=2)


def _hf_bert_state(seed=0):
    c = BERT_CFG
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.2 * rng.normal(size=shape)).astype(np.float32)

    s = {"embeddings.word_embeddings.weight": w(c["vocab"], c["hidden"]),
         "embeddings.position_embeddings.weight": w(c["pos"], c["hidden"]),
         "embeddings.token_type_embeddings.weight": w(c["types"],
                                                      c["hidden"]),
         "embeddings.LayerNorm.weight": 1 + w(c["hidden"]),
         "embeddings.LayerNorm.bias": w(c["hidden"]),
         "pooler.dense.weight": w(c["hidden"], c["hidden"]),
         "pooler.dense.bias": w(c["hidden"])}
    for i in range(c["layers"]):
        p = "encoder.layer.%d." % i
        for n in ("query", "key", "value"):
            s[p + "attention.self.%s.weight" % n] = w(c["hidden"], c["hidden"])
            s[p + "attention.self.%s.bias" % n] = w(c["hidden"])
        s[p + "attention.output.dense.weight"] = w(c["hidden"], c["hidden"])
        s[p + "attention.output.dense.bias"] = w(c["hidden"])
        s[p + "attention.output.LayerNorm.weight"] = 1 + w(c["hidden"])
        s[p + "attention.output.LayerNorm.bias"] = w(c["hidden"])
        s[p + "intermediate.dense.weight"] = w(c["inter"], c["hidden"])
        s[p + "intermediate.dense.bias"] = w(c["inter"])
        s[p + "output.dense.weight"] = w(c["hidden"], c["inter"])
        s[p + "output.dense.bias"] = w(c["hidden"])
        s[p + "output.LayerNorm.weight"] = 1 + w(c["hidden"])
        s[p + "output.LayerNorm.bias"] = w(c["hidden"])
    return {"bert." + k: v for k, v in s.items()}


def _same_params(jm, tm):
    jp = {k: np.asarray(p.data().asnumpy())
          for k, p in jm._collect_params_with_prefix().items()}
    tp = {k: p._tensor().detach().numpy()
          for k, p in tm._collect_params_with_prefix().items()}
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_hf_bert_transplant_matches_jax(jax_trace_state):  # noqa: F811
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.models.bert import BERTModel as JBERT
    from mxnet_tpu_torch.models.bert import BERTModel

    c = BERT_CFG
    kw = dict(vocab_size=c["vocab"], token_type_vocab_size=c["types"],
              units=c["hidden"], hidden_size=c["inter"],
              num_layers=c["layers"], num_heads=c["heads"], dropout=0.0,
              max_length=c["pos"], use_decoder=False, use_classifier=False)
    state = _hf_bert_state()
    rng = np.random.default_rng(0)
    B, T = 2, 10
    tok = rng.integers(0, c["vocab"], (B, T)).astype(np.int32)
    tt = rng.integers(0, 2, (B, T)).astype(np.int32)
    vl = np.array([T, 6], np.int32)
    jm = JBERT(**kw)
    jm.initialize()
    jm(jnd.array(tok), jnd.array(tt), jnd.array(vl.astype(np.float32)))
    jconvert.transplant_hf_bert(jm, state)
    tm = BERTModel(**kw)
    tm.initialize(device="cpu")
    # torch tensors work as the values as well as numpy arrays
    convert.transplant_hf_bert(tm, {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    _same_params(jm, tm)
    jseq, jpool = jm(jnd.array(tok), jnd.array(tt),
                     jnd.array(vl.astype(np.float32)))
    with torch.no_grad():
        seq, pool = tm(torch.from_numpy(tok), torch.from_numpy(tt),
                       torch.from_numpy(vl))
    for i, n in enumerate(vl):
        np.testing.assert_allclose(seq[i, :n].numpy(),
                                   np.asarray(jseq.asnumpy())[i, :n],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pool.numpy(), np.asarray(jpool.asnumpy()),
                               rtol=1e-5, atol=1e-5)


def _hf_gpt2_state(vocab, units, layers, pos, seed=3):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.2 * rng.normal(size=shape)).astype(np.float32)

    s = {"wte.weight": w(vocab, units), "wpe.weight": w(pos, units),
         "ln_f.weight": 1 + w(units), "ln_f.bias": w(units)}
    for i in range(layers):
        p = "h.%d." % i
        s[p + "ln_1.weight"], s[p + "ln_1.bias"] = 1 + w(units), w(units)
        s[p + "attn.c_attn.weight"] = w(units, 3 * units)  # Conv1D: (in, out)
        s[p + "attn.c_attn.bias"] = w(3 * units)
        s[p + "attn.c_proj.weight"] = w(units, units)
        s[p + "attn.c_proj.bias"] = w(units)
        s[p + "ln_2.weight"], s[p + "ln_2.bias"] = 1 + w(units), w(units)
        s[p + "mlp.c_fc.weight"] = w(units, 4 * units)
        s[p + "mlp.c_fc.bias"] = w(4 * units)
        s[p + "mlp.c_proj.weight"] = w(4 * units, units)
        s[p + "mlp.c_proj.bias"] = w(units)
    return {"transformer." + k: v for k, v in s.items()}


def test_hf_gpt2_transplant_matches_jax(jax_trace_state):  # noqa: F811
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.models.gpt import GPTModel as JGPT
    from mxnet_tpu_torch.models.gpt import GPTModel

    kw = dict(vocab_size=211, units=32, num_layers=2, num_heads=4,
              max_length=16, dropout=0.0)
    state = _hf_gpt2_state(211, 32, 2, 16)
    tok = np.random.default_rng(3).integers(0, 211, (2, 12)).astype(np.int32)
    jm = JGPT(**kw)
    jm.initialize()
    jm(jnd.array(tok))
    jconvert.transplant_hf_gpt2(jm, state)
    tm = GPTModel(**kw)
    tm.initialize(device="cpu")
    convert.transplant_hf_gpt2(tm, state)
    _same_params(jm, tm)
    jl = np.asarray(jm(jnd.array(tok)).asnumpy())
    with torch.no_grad():
        tl = tm(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
