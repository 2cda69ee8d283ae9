"""The port's model parallelism over 4 gloo ranks on the CPU, held against
the JAX package on the first four of conftest's eight CPU devices at the
same mesh shapes (the cases of ``tests/test_parallel.py``).

One group of 4 ranks runs once a module (``tests/torch_port_mp_worker.py``
each, ``torch_port_helpers.run_ranks``); a rank holds its block of what
the JAX package holds as one sharded array, and each test holds every
rank's block against the matching block of the JAX result:

- the Megatron f/g regions (``psum_region_entry``/``_exit``) around an MLP
  split over tp = 4, against the unsplit MLP's gradients;
- ``build_train_step(param_spec=)`` on {dp: 2, tp: 2} (SGD; SGD with
  momentum and the update sharded, 3 steps) and on {fsdp: 4}, against
  the JAX package's single-device step;
- gpt_nano's forward with its parameters split by ``TRANSFORMER_RULES``
  over tp = 4, against the JAX package's replicated forward;
- ring and Ulysses attention at sp = 4, causal and not, output and
  gradients, against the JAX package's at sp = 4;
- ``sequence_parallel_scope`` on gpt_nano (ring at sp = 4, Ulysses at
  sp = 2), against the JAX model unsplit;
- ``pipeline_apply``, the interleaved schedule with its gradients, 1F1B,
  and 1F1B on {tp: 2, pp: 2} and {dp: 2, pp: 2}, against the JAX
  package's at those meshes;
- ``moe_ffn`` at ep = 4 and {dp: 2, ep: 2};
- ``SyncBatchNorm`` on four quarter batches against the JAX BatchNorm on
  the whole batch;
- Megatron compute sharding inside ``tensor_parallel.tp_scope``: a 4-head
  GPT at tp = 4 and gpt_nano at tp = 2 split their heads, FFN columns and
  vocabulary (gpt_nano at tp = 4 reads its attention leaves whole), GPT
  and BERT steps on {dp: 2, tp: 2} against the JAX single-device step,
  the vocabulary-parallel loss and embedding, the dropout rule, and a
  1F1B pipeline of GPT blocks on {tp: 2, pp: 2}.

Tolerances are the JAX tests' own: 1e-5 relative for losses, 1e-5 or
1e-4 absolute for outputs and 2e-5 to 2e-4 for gradients, each named at
its assertion. The in-process tests pin the refusals (no group needed:
they raise before any collective).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import _trace
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.models.bert import BERTModel as JBERTModel
from mxnet_tpu.models.gpt import GPTModel as JGPTModel
from mxnet_tpu.models.gpt import gpt_nano as jgpt_nano
from mxnet_tpu.parallel import tensor_parallel as jtp
from mxnet_tpu.parallel.expert_parallel import moe_ffn as jmoe
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.parallel import tensor_parallel as ttp
from torch_port_helpers import jax_rng_kept, jax_trace_state_module  # noqa: F401
from torch_port_helpers import run_ranks

pytestmark = pytest.mark.usefixtures("jax_trace_state_module",
                                      "jax_rng_kept")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mp_worker.py")
WORLD = 4
SEED = 0


def _devs(n=WORLD):
    return jax.devices()[:n]


def _mesh(axes):
    return jparallel.make_mesh(axes, devices=_devs(int(np.prod(
        list(axes.values())))))


def _jax_gpt():
    mx.random.seed(SEED)
    net = jgpt_nano()
    net.initialize()
    return net


GPT4 = dict(vocab_size=256, units=64, num_layers=2, num_heads=4,
            max_length=64, dropout=0.0)
BERT4 = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
             num_heads=4, max_length=64, dropout=0.0)


def _jax_net(cls, cfg, seed):
    mx.random.seed(seed)
    net = cls(**cfg)
    net.initialize()
    return net


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(SEED)
    inp = {"rg_x": _f32(rng, 8, 16), "rg_w1": _f32(rng, 16, 32, scale=0.3),
           "rg_w2": _f32(rng, 32, 16, scale=0.3), "rg_t": _f32(rng, 8, 16),
           "tp_ffn_1_weight": _f32(rng, 16, 8, scale=0.1),
           "tp_ffn_1_bias": np.zeros(16, np.float32),
           "tp_ffn_2_weight": _f32(rng, 8, 16, scale=0.1),
           "tp_x": _f32(rng, 8, 8), "tp_y": _f32(rng, 8, 8),
           "gpt_toks": rng.integers(0, 256, (2, 8)).astype(np.int32),
           "gpt_toks2": rng.integers(0, 256, (2, 8)).astype(np.int32)}
    for tag, shape in (("ring", (2, 2, 64, 8)), ("uly", (2, 8, 64, 16))):
        for n in ("q", "k", "v", "ct"):
            inp["%s_%s" % (tag, n)] = _f32(rng, *shape)
    for i in range(WORLD):
        inp["pp_w%d" % i] = _f32(rng, 4, 4, scale=0.4)
        inp["pp_b%d" % i] = _f32(rng, 4, scale=0.1)
    for i in range(4 * WORLD):
        inp["il_w%d" % i] = _f32(rng, 4, 4, scale=0.4)
        inp["il_b%d" % i] = np.full(4, 0.01 * i, np.float32)
    inp["pp_xs"] = _f32(rng, 10, 2, 4)
    inp["il_xs"] = _f32(rng, 6, 2, 4)
    inp["fb_xs"], inp["fb_tg"] = _f32(rng, 7, 2, 4), _f32(rng, 7, 2, 4)
    for i in range(2):
        inp["cp_w1%d" % i] = _f32(rng, 4, 8, scale=0.4)
        inp["cp_b1%d" % i] = _f32(rng, 8, scale=0.1)
        inp["cp_w2%d" % i] = _f32(rng, 8, 4, scale=0.4)
        inp["cp_b2%d" % i] = _f32(rng, 4, scale=0.1)
    inp["cp_xs"], inp["cp_tg"] = _f32(rng, 5, 4, 4), _f32(rng, 5, 4, 4)
    inp["moe_x"] = _f32(rng, 64, 16)
    inp["moe_rw"] = _f32(rng, 16, 8, scale=0.5)
    inp["moe_w1"] = _f32(rng, 8, 16, 32, scale=0.3)
    inp["moe_w2"] = _f32(rng, 8, 32, 16, scale=0.3)
    # each quarter batch around its own mean: per-quarter statistics
    # would be far from the global batch's
    inp["bn_x"] = np.concatenate([
        rng.normal(loc=2.0 * i, scale=0.5, size=(4, 3, 4, 4))
        for i in range(WORLD)]).astype(np.float32)
    inp["bn_w"] = _f32(rng, 16, 3, 4, 4)
    for name, p in _jax_gpt().collect_params().items():
        inp["gpt/" + name] = np.asarray(p.data().asnumpy())
    for tag, net in (("gpt4", _jax_net(JGPTModel, GPT4, SEED + 1)),
                     ("bert4", _jax_net(JBERTModel, BERT4, SEED + 2))):
        for name, p in net.collect_params().items():
            inp[tag + "/" + name] = np.asarray(p.data().asnumpy())
    inp["st_gpt_x"] = rng.integers(0, 256, (4, 8)).astype(np.int32)
    inp["st_gpt_y"] = rng.integers(0, 256, (4, 8)).astype(np.int32)
    inp["st_bert_ids"] = rng.integers(0, 256, (4, 8)).astype(np.int32)
    inp["st_bert_types"] = rng.integers(0, 2, (4, 8)).astype(np.int32)
    inp["st_bert_vl"] = np.array([8, 5, 7, 3], np.int32)
    inp["st_bert_pos"] = np.array([[0, 3, 7], [1, 2, 4], [0, 5, 6],
                                   [0, 1, 2]], np.int32)
    # a label in each quarter of the vocabulary
    inp["st_bert_labels"] = np.array([[3, 70, 130], [200, 255, 0],
                                      [64, 127, 191], [192, 1, 100]],
                                     np.int32)
    inp["vx_logits"] = _f32(rng, 6, 64, scale=3.0)
    inp["vx_labels"] = np.array([3, 20, 40, 63, 16, 47], np.int32)
    inp["vx_ct"] = _f32(rng, 6)
    inp["ve_w"] = _f32(rng, 64, 8)
    # every quarter, a negative id (it wraps) and one past the table
    inp["ve_ids"] = np.array([[0, 17, 35, 63, -1], [48, 64, 15, 16, 31]],
                             np.int32)
    inp["ve_ct"] = _f32(rng, 2, 5, 8)
    inp["pg_xs"] = _f32(rng, 4, 2, 8, 64)
    inp["pg_tg"] = _f32(rng, 4, 2, 8, 64)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_trace_state_module):  # noqa: F811
    workdir = tmp_path_factory.mktemp("mp4")
    inp = _inputs()
    return run_ranks(WORKER, workdir, inp, WORLD), inp


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def _block(a, index, n, axis):
    return np.split(np.asarray(a), n, axis=axis)[index]


def test_tp_rules():
    """The rule table's specs, and the port's GPT parameter names hit the
    same rules as the JAX package's."""
    from mxnet_tpu_torch.models.gpt import gpt_nano

    class Fake:
        shape = {"tp": 8}

    for name, shape, want in (("bert_layer0_qkv_weight", (24, 8), ("tp", None)),
                              ("bert_layer0_attn_out_weight", (8, 24),
                               (None, "tp")),
                              ("bert_ln_gamma", (7,), ())):
        assert tuple(ttp.spec_for(name, shape, ttp.TRANSFORMER_RULES,
                                  Fake)) == want
        assert tuple(jtp.spec_for(name, shape, jtp.TRANSFORMER_RULES,
                                  _mesh({"tp": 8}))) == want
    jmesh = _mesh({"tp": 4})
    Fake.shape = {"tp": 4}
    jnet = _jax_gpt()
    tnet = gpt_nano()
    tnet.initialize(device="cpu")
    jspecs = {p.name[len(jnet.prefix):]: tuple(jtp.spec_for(
        p.name, p.data().shape, jtp.TRANSFORMER_RULES, jmesh))
        for p in jnet.collect_params().values()}
    tspecs = {p.name[len(tnet.prefix):]: tuple(ttp.spec_for(
        p.name, tuple(p.shape), ttp.TRANSFORMER_RULES, Fake))
        for p in tnet.collect_params().values()}
    assert tspecs == jspecs
    assert ("tp", None) in tspecs.values() and (None, "tp") in \
        tspecs.values()
    # FSDP: the largest dimension the axis divides
    Fake.shape = {"fsdp": 8}
    assert tuple(ttp._fsdp_spec((16, 4), Fake)) == tuple(
        jtp._fsdp_spec((16, 4), _mesh({"fsdp": 8})))


def test_psum_regions_give_the_unsplit_gradients(ranks):
    out, inp = ranks

    def loss(x, w1, w2):
        y = jnp.tanh(x @ w1) @ w2
        return jnp.mean((y - inp["rg_t"]) ** 2)

    lv, (dx, dw1, dw2) = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        inp["rg_x"], inp["rg_w1"], inp["rg_w2"])
    for r, o in enumerate(out["regions"]):
        _close(o["loss"], lv, 0, 1e-5, "loss")
        # the entry's backward sums the ranks' partial input cotangents
        _close(o["dx"], dx, 2e-5, 0, "dx")
        _close(o["dw1"], _block(dw1, r, WORLD, 1), 2e-5, 0, "dw1")
        _close(o["dw2"], _block(dw2, r, WORLD, 0), 2e-5, 0, "dw2")


def _jax_ffn_steps(inp, optimizer, steps):
    def loss_fn(params, batch, key):
        x, y = batch
        h = jnp.tanh(x @ params["ffn_1_weight"].T + params["ffn_1_bias"])
        return jnp.mean((h @ params["ffn_2_weight"].T - y) ** 2)

    params = {k: jnp.asarray(inp["tp_" + k]) for k in (
        "ffn_1_bias", "ffn_1_weight", "ffn_2_weight")}
    init_states, _ = jparallel.tree_optimizer_step(optimizer)
    states = init_states(params)
    step = jparallel.build_train_step(loss_fn, optimizer, donate=False)
    losses = []
    for i in range(steps):
        params, states, loss = step(params, states, jnp.int32(1 + i),
                                    jax.random.PRNGKey(0),
                                    (inp["tp_x"], inp["tp_y"]))
        losses.append(float(loss))
    return params, losses


def test_dp_tp_train_step_matches_single_device(ranks):
    """{dp: 2, tp: 2}: ffn_1 column-split and ffn_2 row-split over tp, the
    batch over dp; the blocks after the step against the JAX package's
    single-device step (its tolerances: loss 1e-5 relative, weights 1e-4
    relative and 1e-6 absolute)."""
    out, inp = ranks
    jmesh = _mesh({"dp": 2, "tp": 2})
    names = ("ffn_1_bias", "ffn_1_weight", "ffn_2_weight")
    jspecs = [str(tuple(jtp.spec_for(k, inp["tp_" + k].shape,
                                     jtp.TRANSFORMER_RULES, jmesh)))
              for k in names]
    runs = {"sgd": _jax_ffn_steps(inp, mx.optimizer.SGD(learning_rate=0.1),
                                  1),
            "mom": _jax_ffn_steps(inp, mx.optimizer.SGD(learning_rate=0.1,
                                                        momentum=0.9), 3)}
    axis = {"ffn_1_bias": 0, "ffn_1_weight": 0, "ffn_2_weight": 1}
    for r, o in enumerate(out["dptp"]):
        assert list(o["specs"]) == jspecs
        tp_idx = r % 2
        for tag, (params, losses) in runs.items():
            _close(o[tag + "_losses"], losses, 0, 1e-5, tag + " loss")
            for k in names:
                _close(o["%s_%s" % (tag, k)],
                       _block(params[k], tp_idx, 2, axis[k]), 1e-6, 1e-4,
                       "%s %s" % (tag, k))


def test_fsdp_train_step_matches_single_device(ranks):
    out, inp = ranks
    jmesh = _mesh({"fsdp": 4})
    params, losses = _jax_ffn_steps(inp, mx.optimizer.SGD(learning_rate=0.1),
                                    1)
    for r, o in enumerate(out["dptp"]):
        _close(o["fsdp_loss"], losses[0], 0, 1e-5, "loss")
        for k, spec in zip(("ffn_1_bias", "ffn_1_weight", "ffn_2_weight"),
                           o["fsdp_specs"]):
            jspec = tuple(jtp.spec_for(k, inp["tp_" + k].shape,
                                       jtp.FSDP_RULES, jmesh))
            assert str(jspec) == spec
            want = np.asarray(params[k])
            if "fsdp" in jspec:
                want = _block(want, r, WORLD, jspec.index("fsdp"))
            _close(o["fsdp_" + k], want, 1e-6, 1e-4, k)


def test_gpt_tensor_parallel_forward_matches_replicated(ranks):
    """gpt_nano's parameters split by TRANSFORMER_RULES over tp = 4 (qkv
    and ffn column- and row-split, the vocabulary split) and stored as
    blocks: the train step's forward on the gathered weights against the
    JAX package's replicated forward (its tolerances, 2e-4 and 2e-5)."""
    out, inp = ranks
    jnet = _jax_gpt()
    plist = list(jnet.collect_params().values())
    toks = jnp.asarray(inp["gpt_toks"])

    def fwd(arrays, t):
        with _trace.trace_scope(jax.random.PRNGKey(0), False) as tc:
            tc.param_store = {id(p): a for p, a in zip(plist, arrays)}
            return jnet._call_traced(t)

    ref = np.asarray(jax.jit(fwd)([p.data()._data for p in plist], toks))
    for o in out["gpt_tp"]:
        assert int(o["n_col"]) > 0 and int(o["n_row"]) > 0
        _close(o["logits"], ref, 2e-5, 2e-4, "logits")
    # the blocks are quarters of the split parameters
    shapes = [tuple(s[s > 0]) for s in out["gpt_tp"][0]["block_shapes"]]
    whole = [p.data().shape for p in plist]
    assert sum(a != b for a, b in zip(shapes, whole)) >= 2 * int(
        out["gpt_tp"][0]["n_col"])


def _jax_attn(fn, q, k, v, ct):
    """fn's output and the gradients of sum(fn * ct), one compiled
    program."""
    @jax.jit
    def run(q, k, v, ct):
        out, pull = jax.vjp(fn, q, k, v)
        return (out,) + tuple(pull(ct))

    return run(q, k, v, jnp.asarray(ct))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ranks, causal):
    """sp = 4, fp32 (the dense per-block step): output within 1e-4 and
    gradients within the JAX test's 2e-4 absolute, 1e-3 relative."""
    out, inp = ranks
    mesh = _mesh({"sp": 4})
    spec = NamedSharding(mesh, JP(None, None, "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(inp["ring_" + n]), spec)
               for n in "qkv")
    want = _jax_attn(lambda a, b, c: jparallel.ring_attention(
        a, b, c, mesh, causal=causal), q, k, v, inp["ring_ct"])
    full = jparallel.full_attention(jnp.asarray(inp["ring_q"]),
                                    jnp.asarray(inp["ring_k"]),
                                    jnp.asarray(inp["ring_v"]),
                                    causal=causal)
    for r, o in enumerate(out["ring"]):
        _close(o["ring_%d_o" % causal], _block(want[0], r, 4, 2), 1e-4, 0,
               "out")
        _close(o["ring_%d_o" % causal], _block(full, r, 4, 2), 1e-4, 0,
               "out vs full")
        for i, n in enumerate(("dq", "dk", "dv")):
            _close(o["ring_%d_%s" % (causal, n)],
                   _block(want[1 + i], r, 4, 2), 2e-4, 1e-3, n)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(ranks, causal):
    """sp = 4, 8 heads: output within 1e-5 and gradients within 1e-5
    absolute, 1e-4 relative (the JAX test's)."""
    from mxnet_tpu.parallel.ulysses import ulysses_attention

    out, inp = ranks
    mesh = _mesh({"sp": 4})
    want = _jax_attn(lambda a, b, c: ulysses_attention(a, b, c, mesh,
                                                       causal=causal),
                     *(jnp.asarray(inp["uly_" + n]) for n in "qkv"),
                     inp["uly_ct"])
    for r, o in enumerate(out["ring"]):
        _close(o["uly_%d_o" % causal], _block(want[0], r, 4, 2), 1e-5,
               1e-5, "out")
        for i, n in enumerate(("dq", "dk", "dv")):
            _close(o["uly_%d_%s" % (causal, n)],
                   _block(want[1 + i], r, 4, 2), 1e-5, 1e-4, n)


def test_sequence_parallel_scope_gpt_matches_unsharded(ranks):
    """The JAX test's bounds: the loss within 1e-5 relative, every
    parameter's gradient within 2e-4."""
    out, inp = ranks
    jnet = _jax_gpt()
    plist = list(jnet.collect_params().values())
    toks = jnp.asarray(inp["gpt_toks2"])

    def loss(arrays, t):
        with _trace.trace_scope(jax.random.PRNGKey(0), False) as tc:
            tc.param_store = {id(p): a for p, a in zip(plist, arrays)}
            logits = jnet._call_traced(t)
        return (logits.astype(jnp.float32) ** 2).mean()

    ref_l, ref_g = jax.jit(jax.value_and_grad(loss))(
        [p.data()._data for p in plist], toks)
    from mxnet_tpu_torch.models.gpt import gpt_nano

    tnet = gpt_nano()
    tnames = [p.name[len(tnet.prefix):] for p in tnet.collect_params()
              .values()]
    jgrads = {p.name[len(jnet.prefix):]: np.asarray(g)
              for p, g in zip(plist, ref_g)}
    for tag in ("ring", "uly"):
        for o in out["sp_scope"]:
            _close(o[tag + "_loss"], ref_l, 0, 1e-5, tag + " loss")
            worst = max(float(np.abs(o["%s_g%d" % (tag, j)]
                                     - jgrads[name]).max())
                        for j, name in enumerate(tnames))
            assert worst < 2e-4, (tag, worst)


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def test_pipeline_apply_matches_jax(ranks):
    out, inp = ranks
    mesh = _mesh({"pp": 4})
    per = [{"w": jnp.asarray(inp["pp_w%d" % i]),
            "b": jnp.asarray(inp["pp_b%d" % i])} for i in range(4)]
    want = jax.jit(lambda st, xs: jparallel.pipeline_apply(
        _jax_stage, st, xs, mesh))(jparallel.stack_stage_params(per),
                                   jnp.asarray(inp["pp_xs"]))
    ref = inp["pp_xs"]
    for p in per:
        ref = np.tanh(ref @ np.asarray(p["w"]) + np.asarray(p["b"]))
    for o in out["pipeline"]:
        _close(o["apply"], want, 1e-5, 0, "vs jax")
        _close(o["apply"], ref, 1e-5, 0, "vs sequential")


def test_pipeline_interleaved_matches_jax(ranks):
    """16 stages on 4 devices (v = 4): the outputs within 1e-5 and each
    rank's rows of the stacked gradients within 1e-4 of the JAX
    package's."""
    out, inp = ranks
    mesh = _mesh({"pp": 4})
    per = [{"w": jnp.asarray(inp["il_w%d" % i]),
            "b": jnp.asarray(inp["il_b%d" % i])} for i in range(16)]
    st = jparallel.interleave_stage_params(per, 4)
    xs = jnp.asarray(inp["il_xs"])

    def run(s):
        return jparallel.pipeline_apply_interleaved(_jax_stage, s, xs, mesh,
                                                    n_virtual=4)

    want, pull = jax.jit(lambda s: jax.vjp(run, s))(st)
    g, = jax.jit(pull)(2 * want)  # the gradient of sum(y ** 2)
    for r, o in enumerate(out["pipeline"]):
        _close(o["il_out"], want, 1e-5, 0, "out")
        rows = slice(4 * r, 4 * r + 4)
        _close(o["il_gw"][rows], np.asarray(g["w"])[rows], 1e-4, 0, "gw")
        _close(o["il_gb"][rows], np.asarray(g["b"])[rows], 1e-4, 0, "gb")
        others = np.delete(o["il_gw"], np.arange(4 * r, 4 * r + 4), axis=0)
        assert not others.any()  # a rank's gradient is its own rows'


def test_pipeline_1f1b_matches_jax(ranks):
    """7 microbatches on 4 stages: the loss within 1e-5 relative, each
    rank's stage gradients within 1e-5."""
    out, inp = ranks
    mesh = _mesh({"pp": 4})
    per = [{"w": jnp.asarray(inp["pp_w%d" % i]),
            "b": jnp.asarray(inp["pp_b%d" % i])} for i in range(4)]
    loss, grads = jax.jit(lambda st, xs, tg: jparallel.pipeline_train_step_1f1b(
        _jax_stage, lambda y, t: jnp.mean((y - t) ** 2), st, xs, tg, mesh))(
        jparallel.stack_stage_params(per), jnp.asarray(inp["fb_xs"]),
        jnp.asarray(inp["fb_tg"]))
    for r, o in enumerate(out["pipeline"]):
        _close(o["fb_loss"], loss, 0, 1e-5, "loss")
        _close(o["fb_gw"], np.asarray(grads["w"])[r:r + 1], 1e-5, 0, "gw")
        _close(o["fb_gb"], np.asarray(grads["b"])[r:r + 1], 1e-5, 0, "gb")


def test_pipeline_1f1b_composed_matches_jax(ranks):
    """1F1B on {tp: 2, pp: 2} (the stage closing its tp math with the
    f/g regions) and on {dp: 2, pp: 2} (batch_axis): the loss within 1e-5
    relative and each rank's gradient block within 2e-5 (the JAX test's
    bounds) of the JAX package's at the same meshes."""
    from mxnet_tpu.parallel.tensor_parallel import (psum_region_entry,
                                                    psum_region_exit)

    out, inp = ranks
    per = [{k: jnp.asarray(inp["cp_%s%d" % (k, i)])
            for k in ("w1", "b1", "w2", "b2")} for i in range(2)]
    stacked = jparallel.stack_stage_params(per)
    xs, tg = jnp.asarray(inp["cp_xs"]), jnp.asarray(inp["cp_tg"])

    def mse(y, t):
        return jnp.mean((y - t) ** 2)

    def tp_stage(params, x):
        x = psum_region_entry(x, "tp")
        h = jnp.tanh(x @ params["w1"] + params["b1"])
        return psum_region_exit(h @ params["w2"], "tp") + params["b2"]

    def stage(params, x):
        h = jnp.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    spec = {"w1": JP("pp", None, "tp"), "b1": JP("pp", "tp"),
            "w2": JP("pp", "tp", None), "b2": JP("pp")}
    tl, tg_ = jax.jit(lambda st: jparallel.pipeline_train_step_1f1b(
        tp_stage, mse, st, xs, tg, _mesh({"tp": 2, "pp": 2}),
        param_spec=spec))(stacked)
    dl, dg = jax.jit(lambda st: jparallel.pipeline_train_step_1f1b(
        stage, mse, st, xs, tg, _mesh({"dp": 2, "pp": 2}),
        batch_axis="dp"))(stacked)
    tp_dim = {"w1": 2, "b1": 1, "w2": 1, "b2": None}
    for r, o in enumerate(out["compose"]):
        # rank r sits at (tp, pp) = (r // 2, r % 2), (dp, pp) likewise
        outer, pp = r // 2, r % 2
        _close(o["tp_loss"], tl, 0, 1e-5, "tp x pp loss")
        _close(o["dp_loss"], dl, 0, 1e-5, "dp x pp loss")
        for k in ("w1", "b1", "w2", "b2"):
            want = np.asarray(tg_[k])[pp:pp + 1]
            if tp_dim[k] is not None:
                want = _block(want, outer, 2, tp_dim[k])
            _close(o["tp_g" + k], want, 2e-5, 0, "tp x pp " + k)
            _close(o["dp_g" + k], np.asarray(dg[k])[pp:pp + 1], 2e-5, 0,
                   "dp x pp " + k)


def test_moe_ffn_matches_jax(ranks):
    """ep = 4 and {dp: 2, ep: 2}: each rank's tokens within 1e-4 of the
    JAX package's (its bound against the per-token reference), the aux
    loss within 1e-5 relative."""
    out, inp = ranks
    args = [jnp.asarray(inp["moe_" + n]) for n in ("rw", "w1", "w2")]
    x = jnp.asarray(inp["moe_x"])
    m1 = _mesh({"ep": 4})
    y1, a1 = jax.jit(lambda x_: jmoe(x_, *args, m1, capacity_factor=8.0))(
        jax.device_put(x, NamedSharding(m1, JP("ep", None))))
    m2 = _mesh({"dp": 2, "ep": 2})
    y2, a2 = jax.jit(lambda x_: jmoe(x_, *args, m2, capacity_factor=8.0,
                                     batch_axis="dp"))(
        jax.device_put(x, NamedSharding(m2, JP(("dp", "ep"), None))))
    for r, o in enumerate(out["moe"]):
        _close(o["ep_y"], _block(y1, r, 4, 0), 1e-4, 0, "ep y")
        _close(o["dpep_y"], _block(y2, r, 4, 0), 1e-4, 0, "dp x ep y")
        _close(o["ep_aux"], a1, 0, 1e-5, "ep aux")
        _close(o["dpep_aux"], a2, 0, 1e-5, "dp x ep aux")
        assert float(o["ep_aux"]) > 0


def test_sync_batchnorm_four_quarters_match_whole_batch(ranks):
    """Four ranks, a quarter of the batch each, against the JAX BatchNorm
    on the whole batch: the output and dx blocks, the ranks' dgamma and
    dbeta summed (each rank's is its quarter's part), and the running
    statistics, within 1e-5 (outputs and statistics) and 2e-5
    (gradients)."""
    out, inp = ranks
    x, w = inp["bn_x"], inp["bn_w"]
    bn = jgluon.nn.BatchNorm(in_channels=3)
    bn.initialize()
    xa = mx.nd.array(x)
    xa.attach_grad()
    with jautograd.record():
        y = bn(xa)
        loss = (y * mx.nd.array(w)).sum()
    loss.backward()
    y, dx = y.asnumpy(), xa.grad.asnumpy()
    for r, o in enumerate(out["sync_bn"]):
        _close(o["y"], _block(y, r, 4, 0), 1e-5, 0, "y")
        _close(o["dx"], _block(dx, r, 4, 0), 2e-5, 0, "dx")
        _close(o["rmean"], bn.running_mean.data().asnumpy(), 1e-5, 1e-5,
               "running mean")
        _close(o["rvar"], bn.running_var.data().asnumpy(), 1e-5, 1e-5,
               "running var")
    _close(sum(o["dgamma"] for o in out["sync_bn"]),
           bn.gamma.grad().asnumpy(), 2e-5, 1e-5, "dgamma")
    _close(sum(o["dbeta"] for o in out["sync_bn"]),
           bn.beta.grad().asnumpy(), 2e-5, 1e-5, "dbeta")
    # per-quarter statistics would have been far off
    q0 = x[:4]
    per = (q0 - q0.mean((0, 2, 3), keepdims=True)) / np.sqrt(
        q0.var((0, 2, 3), keepdims=True) + 1e-5)
    assert np.abs(out["sync_bn"][0]["y"] - per).max() > 1.0


class _FakeMesh:
    """A mesh's shape with no group behind it: the refusals raise before
    any collective."""

    def __init__(self, **shape):
        self.shape = shape

    def group(self, axis):
        return None

    def local_rank(self, axis):
        return 0


def test_refusals_match_jax():
    """Ulysses with heads the axis does not divide; the scope with a mask,
    a length the axis does not divide, an unknown impl; a param_spec
    naming no axis of the mesh: the JAX package's errors."""
    from mxnet_tpu.parallel.ulysses import ulysses_attention as jul
    from mxnet_tpu_torch.ops import F

    q = torch.zeros(1, 4, 64, 8)
    with pytest.raises(ValueError, match="ring_attention"):
        tparallel.ulysses_attention(q, q, q, _FakeMesh(sp=8))
    with pytest.raises(ValueError, match="ring_attention"):
        jul(jnp.zeros((1, 4, 64, 8)), jnp.zeros((1, 4, 64, 8)),
            jnp.zeros((1, 4, 64, 8)), jparallel.make_mesh({"sp": 8}))
    with pytest.raises(ValueError, match="impl must be"):
        tparallel.sequence_parallel_scope(_FakeMesh(sp=2), impl="tree")
    with pytest.raises(ValueError, match="impl must be"):
        jparallel.sequence_parallel_scope(_mesh({"sp": 2}), impl="tree")
    mask = torch.ones(1, 1, 64, 64)
    with tparallel.sequence_parallel_scope(_FakeMesh(sp=2)):
        with pytest.raises(ValueError, match="causal or unmasked"):
            F.scaled_dot_attention(q, q, q, mask)
        with pytest.raises(ValueError, match="must divide"):
            F.scaled_dot_attention(q[:, :, :63], q[:, :, :63], q[:, :, :63])
    opt = mx.optimizer.SGD(learning_rate=0.1)

    def jloss(params, batch, key):
        return jnp.sum(params["w"] * batch)

    with pytest.raises(ValueError, match="not found in mesh"):
        jparallel.build_train_step(jloss, opt, mesh=_mesh({"dp": 4}),
                                   param_spec={"w": JP("xx")}, donate=False)
    from mxnet_tpu_torch import optimizer as topt

    tstep = tparallel.build_train_step(
        lambda p, b, k: (p["w"] * b).sum(), topt.SGD(learning_rate=0.1),
        mesh=_FakeMesh(dp=4), param_spec={"w": tparallel.P("xx")})
    with pytest.raises(ValueError, match="not an axis"):
        tstep({"w": torch.ones(4)}, {"w": ()}, 1, None, torch.ones(4))
    with pytest.raises(ValueError, match="requires a mesh|mesh="):
        tparallel.build_train_step(lambda p, b, k: 0, topt.SGD(),
                                   param_spec={"w": tparallel.P("dp")})


def test_moe_tie_takes_the_first_expert():
    """Two experts with the same router score: both packages route to the
    first (``jnp.argmax``'s and ``torch.argmax``'s rule)."""
    rng = np.random.default_rng(3)
    x = np.abs(_f32(rng, 8, 4)) + 0.1
    # every token scores sum(x) > 0 on experts 1 and 2, 0 on the others
    rw = np.zeros((4, 4), np.float32)
    rw[:, 1] = rw[:, 2] = 1.0
    w1, w2 = _f32(rng, 4, 4, 6, scale=0.5), _f32(rng, 4, 6, 4, scale=0.5)
    ty, _ = tparallel.moe_ffn(*(torch.from_numpy(a) for a in (x, rw, w1, w2)),
                              _FakeMesh(ep=1), capacity_factor=4.0)
    jm = _mesh({"ep": 1})
    jy, _ = jax.jit(lambda *a: jmoe(*a, jm, capacity_factor=4.0))(
        jnp.asarray(x), jnp.asarray(rw), jnp.asarray(w1), jnp.asarray(w2))
    _close(ty.numpy(), jy, 1e-5, 0, "tie")
    # expert 1's output, not expert 2's
    h = np.maximum(x @ w1[1], 0) @ w2[1]
    p = torch.softmax(torch.from_numpy(x @ rw), -1).numpy()
    _close(ty.numpy(), h * p.max(-1, keepdims=True), 1e-5, 0, "expert 1")


# ----------------------------------------------- Megatron compute sharding
def _jax_logits(jnet, toks):
    plist = list(jnet.collect_params().values())

    def fwd(arrays, t):
        with _trace.trace_scope(jax.random.PRNGKey(0), False) as tc:
            tc.param_store = {id(p): a for p, a in zip(plist, arrays)}
            return jnet._call_traced(t)

    return np.asarray(jax.jit(fwd)([p.data()._data for p in plist], toks))


def test_tp_split_forward_matches_jax(ranks):
    """The 4-head GPT (units 64) at tp = 4 and gpt_nano at tp = 2 split
    every leaf TRANSFORMER_RULES splits (heads, FFN columns, vocabulary)
    and gather none; gpt_nano at tp = 4, whose 2 heads the axis does not
    divide, reads its attention leaves whole (counted). The logits within
    the JAX test's 2e-4 relative, 2e-5 absolute of the JAX package's
    replicated forward."""
    out, inp = ranks
    toks = jnp.asarray(inp["gpt_toks"])
    want = {"h4": _jax_logits(_jax_net(JGPTModel, GPT4, SEED + 1), toks),
            "nano2": _jax_logits(_jax_gpt(), toks)}
    want["nano4"] = want["nano2"]
    for o in out["gpt_split"]:
        for tag, ref in want.items():
            _close(o[tag + "_logits"], ref, 2e-5, 2e-4, tag)
        for tag in ("h4", "nano2"):
            # 2 attentions, 2 FFNs, the embedding and the tied head
            assert (int(o[tag + "_split"]), int(o[tag + "_gathered"]),
                    int(o[tag + "_gathered_leaves"])) == (6, 0, 0), tag
        # the attentions read qkv's weight and bias and attn_out's weight
        # whole; the FFNs and the vocabulary split
        assert (int(o["nano4_split"]), int(o["nano4_gathered"]),
                int(o["nano4_gathered_leaves"])) == (4, 2, 6)


def _jax_bert_loss(jnet):
    plist = list(jnet.collect_params().values())
    xent = jgluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(arrays, batch, key):
        ids, types, vl, pos, labels = batch
        with _trace.trace_scope(key, False) as tc:
            tc.param_store = {id(p): a for p, a in zip(plist, arrays)}
            logits = jnet._call_traced(ids, types, vl, pos)[-1]
            loss = xent._call_traced(logits, labels)
        return jnp.mean(loss)

    return loss_fn, plist


def _jax_steps(loss_fn, plist, batch, steps=2, momentum=0.0):
    sgd = mx.optimizer.SGD(learning_rate=0.1, momentum=momentum)
    params = [p.data()._data for p in plist]
    init_states, _ = jparallel.tree_optimizer_step(sgd)
    states = init_states(params)
    step = jparallel.build_train_step(loss_fn, sgd, donate=False)
    losses = []
    for i in range(steps):
        params, states, loss = step(params, states, jnp.int32(1 + i),
                                    jax.random.PRNGKey(0), batch)
        losses.append(float(loss))
    return [np.asarray(a) for a in params], losses


def test_tp_split_steps_match_single_device(ranks):
    """GPT (4 heads) and BERT (4 heads) on {dp: 2, tp: 2}: two SGD steps
    of build_train_step(param_spec=TRANSFORMER_RULES specs), the split
    leaves consumed split (none gathered), and the GPT's with momentum and
    the update sharded over dp (ZeRO-1), against the JAX package's
    single-device step (the loss within 1e-5 relative; each stored block
    within 1e-4 relative, 2e-5 absolute of the JAX step's block: the
    blocks are the JAX package's)."""
    out, inp = ranks
    jmesh = _mesh({"dp": 2, "tp": 2})
    gnet = _jax_net(JGPTModel, GPT4, SEED + 1)
    gloss, gplist = jparallel.block_loss_fn(
        gnet, jgluon.loss.SoftmaxCrossEntropyLoss(), training=False)
    bnet = _jax_net(JBERTModel, BERT4, SEED + 2)
    bloss, bplist = _jax_bert_loss(bnet)
    gb = (inp["st_gpt_x"], inp["st_gpt_y"])
    runs = {"gpt": (_jax_steps(gloss, gplist, gb), gplist),
            "gpt_zero": (_jax_steps(gloss, gplist, gb, momentum=0.9),
                         gplist),
            "bert": (_jax_steps(bloss, bplist, tuple(
                inp["st_bert_" + k] for k in ("ids", "types", "vl", "pos",
                                              "labels"))), bplist)}
    for tag, ((params, losses), plist) in runs.items():
        jspecs = [tuple(jtp.spec_for(p.name, p.data().shape,
                                     jtp.TRANSFORMER_RULES, jmesh))
                  for p in plist]
        for r, o in enumerate(out["split_steps"]):
            assert list(o[tag + "_specs"]) == [str(s) for s in jspecs]
            assert int(o[tag + "_gathered_leaves"]) == 0
            assert int(o[tag + "_gathered"]) == 0
            assert int(o[tag + "_split"]) > 0
            _close(o[tag + "_losses"], losses, 0, 1e-5, tag + " loss")
            for j, (a, sp) in enumerate(zip(params, jspecs)):
                want = a
                if "tp" in sp:
                    want = _block(a, r % 2, 2, sp.index("tp"))
                _close(o["%s_p%d" % (tag, j)], want, 2e-5, 1e-4,
                       "%s %s" % (tag, plist[j].name))


def test_vocab_parallel_loss_and_embedding_match_jax(ranks):
    """tp = 4, a label in every quarter: the merged loss within 1e-5 of
    the JAX loss over the whole vocabulary and each rank's dx block
    within 1e-6; the split embedding's rows (ids in every quarter, one
    negative, one past the table's end: NaN) equal jnp.take's, the
    table's gradient block within 1e-6."""
    out, inp = ranks
    x, lab = jnp.asarray(inp["vx_logits"]), jnp.asarray(inp["vx_labels"])

    def xent(x):
        return jax.nn.logsumexp(x, -1) - jnp.take_along_axis(
            x, lab[:, None], -1)[:, 0]

    loss, pull = jax.vjp(xent, x)
    dx, = pull(jnp.asarray(inp["vx_ct"]))
    w, ids = jnp.asarray(inp["ve_w"]), jnp.asarray(inp["ve_ids"])
    rows, pull = jax.vjp(lambda w_: jnp.take(w_, ids, axis=0), w)
    dw, = pull(jnp.asarray(inp["ve_ct"]))
    assert np.isnan(np.asarray(rows)).any()
    for r, o in enumerate(out["vocab"]):
        _close(o["loss"], loss, 1e-5, 1e-5, "loss")
        _close(o["dx"], _block(dx, r, 4, 1), 1e-6, 0, "dx")
        np.testing.assert_array_equal(o["rows"], np.asarray(rows))
        _close(o["dw"], _block(dw, r, 4, 0), 1e-6, 0, "dw")


def test_tp_dropout_rule():
    """Pinned in a group: see test_tp_dropout_rule_in_a_group."""
    from mxnet_tpu_torch.parallel.tensor_parallel import step_seed

    class Mesh:
        axis_names = ("dp", "tp")
        shape = {"dp": 2, "tp": 2}

        def __init__(self, dp, t):
            self.at = {"dp": dp, "tp": t}

        def local_rank(self, a):
            return self.at[a]

    seeds = {(d, t_): step_seed(Mesh(d, t_), 3, 0)
             for d in range(2) for t_ in range(2)}
    assert seeds[0, 0] == seeds[0, 1] and seeds[1, 0] == seeds[1, 1]
    assert seeds[0, 0] != seeds[1, 0]
    assert step_seed(Mesh(0, 0), 4, 0) != seeds[0, 0]


def test_tp_dropout_rule_in_a_group(ranks):
    """{dp: 2, tp: 2}: a replicated activation's dropout mask is the same
    on the two ranks of a tensor group and differs across data groups
    and across steps."""
    out, _ = ranks
    m = [o["masks"] for o in out["dropout"]]
    # rank r sits at (dp, tp) = (r // 2, r % 2)
    np.testing.assert_array_equal(m[0], m[1])
    np.testing.assert_array_equal(m[2], m[3])
    assert (m[0] != m[2]).any()
    assert (m[0][0] != m[0][1]).any()


def test_pipeline_of_gpt_blocks_splits_over_tp(ranks):
    """1F1B over two GPT blocks (4 heads) on {tp: 2, pp: 2} with
    TRANSFORMER_RULES specs: each stage splits its attention and FFN
    (none of its leaves gathered); the loss within 1e-5 relative and each
    rank's gradient blocks within 2e-5 of the JAX package's two blocks
    applied in turn to each microbatch (which {dp: 2, pp: 2}, unsplit,
    also matches)."""
    out, inp = ranks
    jnet = _jax_net(JGPTModel, GPT4, SEED + 1)
    blks = list(jnet.blocks)
    plists = [list(b.collect_params().values()) for b in blks]
    names = [p.name[len(blks[0].prefix):] for p in plists[0]]
    xs, tg = jnp.asarray(inp["pg_xs"]), jnp.asarray(inp["pg_tg"])

    def loss(arrays):
        tot = 0.0
        for m in range(xs.shape[0]):
            y = xs[m]
            for b, pl, arr in zip(blks, plists, arrays):
                with _trace.trace_scope(jax.random.PRNGKey(0), False) as tc:
                    tc.param_store = {id(p): a for p, a in zip(pl, arr)}
                    y = b._call_traced(y)
            tot = tot + jnp.mean((y - tg[m]) ** 2)
        return tot / xs.shape[0]

    lv, g = jax.jit(jax.value_and_grad(loss))(
        [[p.data()._data for p in pl] for pl in plists])
    stacked = {nm: np.stack([np.asarray(g[0][j]), np.asarray(g[1][j])])
               for j, nm in enumerate(names)}
    for r, o in enumerate(out["pipeline_gpt"]):
        split, gathered, leaves = (int(v) for v in o["tp_counters"])
        assert split > 0 and gathered == 0 and leaves == 0
        outer, pp = r // 2, r % 2
        specs = dict(zip(sorted(names), o["specs"]))
        for tag in ("tp", "dp"):
            _close(o[tag + "_loss"], lv, 0, 1e-5, tag + " loss")
        for nm in names:
            want = stacked[nm][pp:pp + 1]
            _close(o["dp_g_" + nm], want, 2e-5, 0, "dp x pp " + nm)
            sp = eval(specs[nm])
            if "tp" in sp:
                want = _block(want, outer, 2, sp.index("tp"))
            _close(o["tp_g_" + nm], want, 2e-5, 0, "tp x pp " + nm)
