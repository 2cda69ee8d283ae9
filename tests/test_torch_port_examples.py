"""The example twins (``examples/torch_*.py``) against the JAX examples,
on the CPU at small settings.

- The data helpers return the JAX example's values: ``synthetic_batch``
  (fine-tune, SSD), ``load_corpus``'s synthetic stream, ``batchify`` and
  ``real_batch``.
- Fine-tune, PTB LM, MNIST, WGAN-GP and SSD: the JAX example's nets are
  built, their weights carried into the twin (``weights=``, through
  ``convert.carry_params``), and the twin's first step's loss is held
  to the JAX first step's within fp32 1e-4 absolute, the fp32 loss
  tolerance of the step parity tests (tests/test_torch_port_train.py);
  dropout is 0 on both sides.
- ``quantize_int8``: the twin's calibrated activation scales equal the
  JAX package's from the same weights and batches (as C.13's test,
  tests/test_torch_port_quant_calib.py: the first layer's within 1e-6
  relative; the deeper ones within one int8 level, 1/127, of theirs).
- ``load_pretrained``: the twin's logits from a fabricated torchvision
  checkpoint equal the JAX example's from the same file (fp32 1e-4).
- ``train_long_context`` (ring and Ulysses) and ``train_bert_distributed``
  on 2 gloo ranks (one group for the module,
  ``tests/torch_port_examples_worker.py``) beside the same twins on 1
  rank, and both against the JAX example's forward on one device: the
  first loss within fp32 1e-4, the second step's (after a step whose
  gradients the ranks averaged) within 1e-4 of the 1-rank run's.
- ``serve_model``: every request answered, one bucket program each.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from torch_port_helpers import (jax_params, jax_rng_kept,  # noqa: F401
                                jax_trace_state_module, keep_block_names,
                                run_rank_groups)

pytestmark = pytest.mark.usefixtures("jax_trace_state_module",
                                      "jax_rng_kept", "keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_examples_worker.py")
LOSS_TOL = 1e-4


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NumpyInit(jmx.init.Initializer):
    """The JAX nets' weights drawn by numpy: ``Xavier()``'s uniform range
    (factor "avg", magnitude 3; biases, betas and means 0, gammas and
    variances 1), without compiling a threefry draw for each weight's
    shape (most of a small net's first forward here). The twins take
    these weights as carried."""

    def __init__(self, seed=0):
        super().__init__()
        self._rng = np.random.default_rng(seed)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        fan_out = shape[0] * (int(np.prod(shape[2:])) if len(shape) > 2
                              else 1)
        bound = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        self._set(arr, self._rng.uniform(-bound, bound, shape)
                  .astype(np.float32))


def jax_example(name):
    return _load("examples/%s.py" % name, "_jax_example_" + name)


def twin(name):
    return _load("examples/torch_%s.py" % name, "_twin_" + name)


# ------------------------------------------------------------ data helpers
def test_data_helpers_match_the_jax_examples():
    jf, tf = jax_example("finetune_bert"), twin("finetune_bert")
    a = jf.synthetic_batch(np.random.default_rng(3), 4, 16, 50)
    with jmx_cpu():
        b = tf.synthetic_batch(np.random.default_rng(3), 4, 16, 50)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())
        assert x.asnumpy().dtype == y.asnumpy().dtype

    jp, tp = jax_example("train_ptb_lm"), twin("train_ptb_lm")
    missing = os.path.join(REPO, "_work", "no_such_corpus.txt")
    (jd, jv), (td, tv) = jp.load_corpus(missing), tp.load_corpus(missing)
    assert jv == tv and jd.dtype == td.dtype
    assert jd.tobytes() == td.tobytes()
    assert jp.batchify(jd, 7).tobytes() == tp.batchify(td, 7).tobytes()

    jw, tw = jax_example("train_wgan_gp"), twin("train_wgan_gp")
    assert jw.real_batch(np.random.default_rng(1), 9).tobytes() == \
        tw.real_batch(np.random.default_rng(1), 9).tobytes()

    js, ts = jax_example("train_ssd"), twin("train_ssd")
    ja = js.synthetic_batch(np.random.default_rng(2), 2, 16, 3)
    with jmx_cpu():
        ta = ts.synthetic_batch(np.random.default_rng(2), 2, 16, 3)
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())


def jmx_cpu():
    import mxnet_tpu_torch as tmx

    return tmx.cpu()


# ------------------------------------------------------- first-step parity
def test_finetune_first_loss_matches_jax():
    from mxnet_tpu.models.bert import BERTClassifier, BERTModel

    jf = jax_example("finetune_bert")
    B, T, vocab = 2, 16, 1000
    bert = BERTModel(vocab_size=vocab, units=128, hidden_size=512,
                     num_layers=2, num_heads=2, max_length=T, dropout=0.0,
                     use_decoder=False, use_classifier=False)
    jnet = BERTClassifier(bert, num_classes=2, dropout=0.0)
    jnet.initialize(NumpyInit())
    tok, tt, vl, y = jf.synthetic_batch(np.random.default_rng(0), B, T,
                                        vocab)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(tok, tt, vl), y)
    r = twin("finetune_bert").main(
        ["--tiny", "--steps", "1", "--batch", str(B), "--seq", str(T),
         "--dropout", "0", "--dtype", "float32", "--device", "cpu"],
        weights=jax_params(jnet))
    assert abs(r["losses"][0] - float(jloss.asnumpy().mean())) <= LOSS_TOL


def test_ptb_first_loss_matches_jax():
    from mxnet_tpu.models.lstm_lm import RNNModel

    jp = jax_example("train_ptb_lm")
    H, B, bptt = 16, 4, 5
    corpus, V = jp.load_corpus(os.path.join(REPO, "_work", "none.txt"))
    data = jp.batchify(corpus, B)
    model = RNNModel("lstm", vocab_size=V, num_embed=H, num_hidden=H,
                     num_layers=2, dropout=0.0)
    model.initialize(NumpyInit())
    x = jnd.array(data[0:bptt], dtype="int32")
    y = jnd.array(data[1:1 + bptt].astype(np.float32))
    logits, _ = model(x, model.begin_state(B))
    jl = float(jgluon.loss.SoftmaxCrossEntropyLoss()(
        logits.reshape(-1, V), y.reshape(-1)).mean().asscalar())
    r = twin("train_ptb_lm").main(
        ["--device", "cpu", "--num-hidden", str(H), "--batch-size", str(B),
         "--bptt", str(bptt), "--max-batches", "1", "--dropout", "0"],
        weights=jax_params(model))
    assert abs(r["losses"][0] - jl) <= LOSS_TOL


def test_mnist_first_loss_matches_jax():
    from mxnet_tpu.gluon.data.vision import MNIST, transforms

    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(128, activation="relu"),
            jgluon.nn.Dense(64, activation="relu"), jgluon.nn.Dense(10))
    net.initialize(NumpyInit())
    ds = MNIST(root=os.path.join(REPO, "_work", "none"), train=True,
               synthetic_size=64).transform_first(transforms.ToTensor())
    data, label = next(iter(jgluon.data.DataLoader(ds, batch_size=16)))
    data = data.reshape(data.shape[0], -1)
    jl = float(jgluon.loss.SoftmaxCrossEntropyLoss()(
        net(data), label.astype("float32")).mean().asscalar())
    r = twin("train_mnist").main(
        ["--device", "cpu", "--epochs", "1", "--batch-size", "16",
         "--samples", "64", "--max-batches", "1", "--shuffle", "0",
         "--workers", "0", "--root", os.path.join(REPO, "_work", "none")],
        weights=jax_params(net))
    assert abs(r["losses"][0] - jl) <= LOSS_TOL


def test_wgan_gp_first_step_matches_jax():
    jw = jax_example("train_wgan_gp")
    rng = np.random.default_rng(0)
    jmx.random.seed(0)
    G, D = jw.make_nets()
    n = 16
    G.initialize(NumpyInit(), force_reinit=True)
    D.initialize(NumpyInit(1), force_reinit=True)
    G(jnd.zeros((1, 8)))  # the deferred shapes, then the initial weights
    D(jnd.zeros((1, 2)))
    weights = {"gen": jax_params(G), "disc": jax_params(D)}
    real = jnd.array(jw.real_batch(rng, n))
    noise = jnd.array(rng.normal(size=(n, 8)).astype(np.float32))
    eps = jnd.array(rng.uniform(size=(n, 1)).astype(np.float32))
    with jautograd.record():
        fake = G(noise).detach()
        interp = eps * real + (1.0 - eps) * fake
        (gp,) = jautograd.grad(D(interp).sum(), [interp], create_graph=True)
        gnorm = jnd.sqrt((gp * gp).sum(axis=1) + 1e-12)
        penalty = ((gnorm - 1.0) ** 2).mean()
        d_loss = D(fake).mean() - D(real).mean() + 10.0 * penalty
    d_loss.backward()
    jgluon.Trainer(D.collect_params(), "adam",
                   {"learning_rate": 2e-3, "beta1": 0.5}).step(n)
    g_loss = -D(G(noise)).mean()
    r = twin("train_wgan_gp").main(
        ["--device", "cpu", "--steps", "1", "--batch", str(n)],
        weights=weights)
    assert abs(r["penalties"][0] - float(penalty.asscalar())) <= LOSS_TOL
    assert abs(r["d_losses"][0] - float(d_loss.asscalar())) <= LOSS_TOL
    # the generator's loss is read after the critic's Adam step, whose
    # gradient came through the penalty's second order path
    assert abs(r["g_losses"][0] - float(g_loss.asscalar())) <= LOSS_TOL


def test_ssd_first_loss_matches_jax():
    from mxnet_tpu.models.ssd import SSDLoss

    js = jax_example("train_ssd")
    net = js.SSD(num_classes=3, sizes=((0.2, 0.3), (0.45, 0.55)),
                 ratios=((1, 2, 0.5),) * 2)
    net.initialize(NumpyInit())
    x, labels = js.synthetic_batch(np.random.default_rng(0), 1, 64, 3)
    loss = SSDLoss(3)
    loss.hybridize()  # one program, not one for each of its many ops
    with jautograd.record():  # BatchNorm on the batch's statistics
        cls_preds, box_preds, anchors = net(x)
        jl = float(loss(cls_preds, box_preds, labels, anchors).mean()
                   .asscalar())
    r = twin("train_ssd").main(
        ["--device", "cpu", "--steps", "1", "--batch", "1", "--size", "64"],
        weights=jax_params(net))
    assert abs(r["losses"][0] - jl) <= LOSS_TOL
    assert r["detections"][0] == 1 and r["detections"][2] == 6


# ------------------------------------------------------------ the others
def test_quantize_int8_scales_equal_jax():
    from mxnet_tpu.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu.quantization import _quantized_layers, quantize_model

    net = get_resnet(1, 18, classes=10, thumbnail=True)
    net.initialize(NumpyInit())
    rng = np.random.RandomState(0)
    calib = [jnd.array(rng.randn(2, 3, 32, 32).astype(np.float32))
             for _ in range(2)]
    net(calib[0])
    weights = jax_params(net)
    quantize_model(net, calib_mode="naive", calib_data=calib)
    want = [float(np.float32(q._x_scale)) for q in _quantized_layers(net, [])]
    r = twin("quantize_int8").main(
        ["--device", "cpu", "--mode", "naive", "--batches", "2",
         "--batch-size", "2"], weights=weights)
    assert len(r["scales"]) == len(want) == 21
    # the first layer reads the batch itself: its scale is exact; a later
    # layer reads the int8 outputs of the layers before it, which a
    # rounding tie can move by a level (measured from the numpy-drawn
    # weights: at most 0.64%), so each is held within one int8 level of
    # its range
    np.testing.assert_allclose(r["scales"][0], want[0], rtol=1e-6)
    np.testing.assert_allclose(r["scales"], want, rtol=1.0 / 127)
    assert r["agreement"] == 1.0


def test_load_pretrained_logits_match_jax(tmp_path):
    from mxnet_tpu.gluon.model_zoo.vision import get_model

    tw = twin("load_pretrained")
    ckpt = tw.fabricate_checkpoint(str(tmp_path / "r18.pth"))
    x = jnd.array(np.random.default_rng(0).normal(size=(1, 3, 64, 64))
                  .astype(np.float32))
    jnet = get_model("resnet18_v1", pretrained=ckpt)
    jnet.hybridize()  # one program, not one for each of its ops
    want = jnet(x).asnumpy()
    r = tw.main([ckpt, "--device", "cpu", "--image-size", "64"])
    np.testing.assert_allclose(r["logits"], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r["native_logits"], r["logits"])


def test_serve_model_answers_every_request():
    r = twin("serve_model").main(["--device", "cpu", "--requests", "10",
                                  "--buckets", "1,8"])
    assert len(r["rows"]) == 10
    assert all(np.asarray(row[0]).shape == (1, 10) for row in r["rows"])
    assert r["stats"]["shed"] == 0 and r["stats"]["timeouts"] == 0
    assert r["stats"]["captures"] == 2


def test_carry_params_pairs_in_order_and_refuses_a_mismatch():
    """``convert.carry_params`` takes a JAX model's weights one for one,
    across root blocks, and refuses another layer's or shape's."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.convert import carry_params

    def nets(pkg, units):
        a, b = pkg.gluon.nn.Dense(units, in_units=4), \
            pkg.gluon.nn.Dense(2, in_units=units)
        seq = pkg.gluon.nn.HybridSequential()
        seq.add(a, b)
        return seq

    jnet = nets(jmx, 3)
    jnet.initialize()
    with jmx_cpu():
        tnet = nets(tmx, 3)
        tnet.initialize()
        carry_params(tnet, jax_params(jnet))
        x = np.random.default_rng(4).normal(size=(5, 4)).astype(np.float32)
        np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(),
                                   jnet(jnd.array(x)).asnumpy(), rtol=1e-6)
        other = nets(tmx, 5)
        other.initialize()
        with pytest.raises(ValueError):
            carry_params(other, jax_params(jnet))
        weights = dict(reversed(list(jax_params(jnet).items())))
        with pytest.raises((KeyError, ValueError)):
            carry_params(tnet, weights)


def test_twins_refuse_without_a_card():
    from mxnet_tpu_torch.base import DeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name, argv in (("finetune_bert", ["--tiny", "--steps", "1"]),
                       ("train_mnist", ["--epochs", "1"]),
                       ("serve_model", ["--requests", "1"])):
        with pytest.raises(DeviceError):
            twin(name).main(argv)


# ---------------------------------------------------- the multi-rank twins
LC = dict(seq=64, heads=2, d=128, vocab=512, layers=2, batch=2)
BERT_DIST = dict(vocab_size=1024, units=128, hidden_size=512, num_layers=2,
                 num_heads=4, max_length=64, dropout=0.0)


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """The twins on 2 gloo ranks and on 1, from the JAX examples' initial
    weights; and the JAX examples' first losses on one device."""
    from mxnet_tpu import parallel as jparallel
    from mxnet_tpu.models.bert import BERTModel

    jl = jax_example("train_long_context")
    params = jl.init_params(jax.random.PRNGKey(0), LC["vocab"], LC["d"],
                            LC["heads"], LC["layers"])
    inp = {"lc_layers": np.array(LC["layers"]),
           "lc_seq": np.array(LC["seq"]), "lc_heads": np.array(LC["heads"]),
           "lc_d": np.array(LC["d"]),
           "lc_embed": np.asarray(params["embed"]),
           "lc_unembed": np.asarray(params["unembed"])}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            inp["lc_l%d_%s" % (i, k)] = np.asarray(v)
    bert = BERTModel(**BERT_DIST)
    bert.initialize(NumpyInit())
    rng = np.random.default_rng(0)
    btok = rng.integers(0, 1024, (4, 64))
    mp = rng.integers(0, 64, (4, 8))
    my = rng.integers(0, 1024, (4, 8))
    bert(jnd.array(btok, dtype="int32"), None, None,
         jnd.array(mp, dtype="int32"))  # the deferred shapes
    inp.update({"bd/" + k: v for k, v in jax_params(bert).items()})
    ref = {}

    def jax_references():
        """The JAX examples' first losses on one device (at one device the
        ring and Ulysses are the same attention), while the ranks run."""
        mesh = jparallel.make_mesh({"sp": 1}, devices=jax.devices()[:1])
        data = np.random.default_rng(0).integers(
            0, LC["vocab"], (LC["batch"], LC["seq"] + 1))
        logits = jl.build_forward(mesh, LC["heads"], jparallel.ring_attention)(
            params, jnp.asarray(data[:, :-1]))
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        ref["lc"] = float(-jnp.take_along_axis(
            lp, jnp.asarray(data[:, 1:])[..., None], -1).mean())
        mlm = bert(jnd.array(btok, dtype="int32"), None, None,
                   jnd.array(mp, dtype="int32"))[-1]
        lpb = jax.nn.log_softmax(jnp.asarray(mlm.asnumpy(), jnp.float32), -1)
        ref["bert"] = float(-jnp.take_along_axis(
            lpb, jnp.asarray(my)[..., None], -1).mean())

    two = tmp_path_factory.mktemp("examples2")
    one = tmp_path_factory.mktemp("examples1")
    res2, res1 = run_rank_groups([(WORKER, two, inp, 2),
                                  (WORKER, one, inp, 1)],
                                 meanwhile=jax_references)
    return res2, res1, ref["lc"], ref["bert"]


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_long_context_on_two_ranks(multi_rank, strategy):
    res2, res1, jax_lc, _ = multi_rank
    case = "lc_" + strategy
    one = res1[case][0]["losses"]
    assert int(res1[case][0]["world"]) == 1
    for r in range(2):
        got = res2[case][r]
        assert int(got["world"]) == 2
        np.testing.assert_allclose(got["losses"], one, atol=LOSS_TOL,
                                   rtol=0)
    assert abs(one[0] - jax_lc) <= LOSS_TOL


def test_bert_distributed_on_two_ranks(multi_rank):
    res2, res1, _, jax_bert = multi_rank
    one = res1["bert"][0]
    assert one["mesh"].tolist() == [1, 1]
    for r in range(2):
        got = res2["bert"][r]
        assert got["mesh"].tolist() == [1, 2]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   atol=LOSS_TOL, rtol=0)
    assert abs(one["losses"][0] - jax_bert) <= LOSS_TOL
