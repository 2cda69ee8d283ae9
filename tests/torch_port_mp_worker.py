"""One rank of the port's model-parallel CPU tests (gloo).

    python tests/torch_port_mp_worker.py RANK WORLD WORKDIR

As ``tests/torch_port_dist_worker.py`` (whose ``main`` it runs): joins a
gloo group of WORLD ranks through a file store in WORKDIR, reads
WORKDIR/inputs.npz, runs every case of ``CASES`` in order and writes
WORKDIR/rank<RANK>.npz. ``tests/test_torch_port_model_parallel.py``
starts the ranks once a module and holds the results against the JAX
package on four CPU devices.
"""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mxnet_tpu_torch import autograd, gluon, parallel  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch.convert import from_jax_params  # noqa: E402
from mxnet_tpu_torch.gluon.block import _param_store  # noqa: E402
from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm  # noqa: E402
from mxnet_tpu_torch.models.bert import BERTModel  # noqa: E402
from mxnet_tpu_torch.models.gpt import GPTModel, gpt_nano  # noqa: E402
from mxnet_tpu_torch.ops import F  # noqa: E402
from mxnet_tpu_torch.parallel import P  # noqa: E402
from mxnet_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from torch_port_dist_worker import main as run_cases  # noqa: E402


def t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_(True) if grad else x


GPT4 = dict(vocab_size=256, units=64, num_layers=2, num_heads=4,
            max_length=64, dropout=0.0)
BERT4 = dict(vocab_size=256, units=64, hidden_size=128, num_layers=2,
             num_heads=4, max_length=64, dropout=0.0)


def _from(inp, net, tag):
    params = {k[len(tag) + 1:]: v for k, v in inp.items()
              if k.startswith(tag + "/")}
    return from_jax_params(net, params)


def _gpt(inp):
    return _from(inp, gpt_nano(), "gpt")


def _net_loss(net, plist, arrays, toks):
    prev = getattr(_param_store, "params", None)
    _param_store.params = {id(p): a for p, a in zip(plist, arrays)}
    try:
        with autograd.record(train_mode=False):
            logits = net(toks)
    finally:
        _param_store.params = prev
    return logits


def case_regions(inp, out, rank, world):
    """The Megatron MLP split over tp = 4 with the f/g regions: x whole,
    W1's columns and W2's rows split; the loss alike on every rank."""
    mesh = parallel.make_mesh({"tp": world})
    x = t(inp["rg_x"], grad=True)
    w1 = parallel.shard_array(t(inp["rg_w1"]), mesh, None, "tp").clone()
    w2 = parallel.shard_array(t(inp["rg_w2"]), mesh, "tp", None).clone()
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    h = torch.tanh(tp.psum_region_entry(x, "tp", mesh) @ w1)
    y = tp.psum_region_exit(h @ w2, "tp", mesh)
    loss = ((y - t(inp["rg_t"])) ** 2).mean()
    loss.backward()
    out["loss"] = loss.detach().numpy()
    out["dx"], out["dw1"], out["dw2"] = (a.grad.numpy() for a in (x, w1, w2))


def _ffn_loss(params, batch, key):
    x, y = batch
    h = torch.tanh(x @ params["ffn_1_weight"].T + params["ffn_1_bias"])
    return ((h @ params["ffn_2_weight"].T - y) ** 2).mean()


def case_dp_tp(inp, out, rank, world):
    """``build_train_step(param_spec=)`` on {dp: 2, tp: 2}: TRANSFORMER_RULES
    blocks, the batch over dp; SGD, then SGD with momentum and the update
    sharded over dp (ZeRO-1) for 3 steps; FSDP_RULES on {fsdp: 4}."""
    names = ("ffn_1_bias", "ffn_1_weight", "ffn_2_weight")
    whole = {k: t(inp["tp_" + k]) for k in names}
    batch_all = (t(inp["tp_x"]), t(inp["tp_y"]))
    mesh = parallel.make_mesh({"dp": 2, "tp": 2})
    specs = {k: tp.spec_for(k, tuple(v.shape), tp.TRANSFORMER_RULES, mesh)
             for k, v in whole.items()}
    out["specs"] = np.array([str(tuple(specs[k])) for k in names])
    batch = parallel.shard_batch(batch_all, mesh)
    for tag, kw, optim, steps in (
            ("sgd", {}, opt.SGD(learning_rate=0.1), 1),
            ("mom", {"shard_weight_update": True},
             opt.SGD(learning_rate=0.1, momentum=0.9), 3)):
        blocks = dict(zip(names, tp.shard_params(
            [(k, whole[k]) for k in names], mesh)))
        init_states, _ = parallel.tree_optimizer_step(optim)
        states = init_states(blocks)
        step = parallel.build_train_step(
            _ffn_loss, optim, mesh=mesh, param_spec=specs,
            batch_spec=(P("dp"), P("dp")), **kw)
        losses = []
        for i in range(steps):
            blocks, states, loss = step(blocks, states, 1 + i, None, batch)
            losses.append(float(loss))
        out[tag + "_losses"] = np.array(losses)
        for k in names:
            out[tag + "_" + k] = blocks[k].numpy()
    fmesh = parallel.make_mesh({"fsdp": world})
    fspecs = {k: tp.spec_for(k, tuple(v.shape), tp.FSDP_RULES, fmesh)
              for k, v in whole.items()}
    blocks = dict(zip(names, tp.shard_params([(k, whole[k]) for k in names],
                                             fmesh, tp.FSDP_RULES)))
    step = parallel.build_train_step(_ffn_loss, opt.SGD(learning_rate=0.1),
                                     mesh=fmesh, param_spec=fspecs,
                                     batch_spec=P("fsdp"))
    fbatch = parallel.shard_batch(batch_all, fmesh, "fsdp")
    blocks, _, loss = step(blocks, {k: () for k in names}, 1, None, fbatch)
    out["fsdp_loss"] = loss.numpy()
    out["fsdp_specs"] = np.array([str(tuple(fspecs[k])) for k in names])
    for k in names:
        out["fsdp_" + k] = blocks[k].numpy()


def case_gpt_tp(inp, out, rank, world):
    """gpt_nano's parameters split by TRANSFORMER_RULES over tp = 4, stored
    as blocks, gathered by the train step for its forward."""
    mesh = parallel.make_mesh({"tp": world})
    net = _gpt(inp)
    plist = list(net.collect_params().values())
    named = [(p.name, p._tensor().detach()) for p in plist]
    specs = tp.param_specs([(n, tuple(a.shape)) for n, a in named], mesh)
    out["n_col"] = np.array(sum(s == P("tp", None) for s in specs))
    out["n_row"] = np.array(sum(s == P(None, "tp") for s in specs))
    blocks = tp.shard_params(named, mesh)
    seen = {}

    def loss_fn(arrays, toks, key):
        logits = _net_loss(net, plist, arrays, toks)
        seen["logits"] = logits.detach()
        return (logits.float() ** 2).mean()

    step = parallel.build_train_step(loss_fn, opt.SGD(learning_rate=0.0),
                                     mesh=mesh, param_spec=specs)
    step(blocks, [()] * len(blocks), 1, None, t(inp["gpt_toks"]))
    out["logits"] = seen["logits"].numpy()
    out["block_shapes"] = np.array([list(b.shape) + [0] * (2 - b.dim())
                                    for b in blocks])


def _split_forward(net, mesh, toks):
    """``net``'s logits with its parameters split by TRANSFORMER_RULES
    over ``mesh`` and handed over as this rank's blocks inside a
    tp_scope, and the path counters of that forward."""
    plist = list(net.collect_params().values())
    named = [(p.name, p._tensor().detach()) for p in plist]
    specs = tp.param_specs([(n, tuple(a.shape)) for n, a in named], mesh)
    blocks = tp.shard_params(named, mesh)
    tp.reset_counters()
    with tp.tp_scope(mesh, list(zip(blocks, specs))):
        logits = _net_loss(net, plist, blocks, toks)
    return logits.detach(), dict(tp.counters)


def case_gpt_split(inp, out, rank, world):
    """The 4-head GPT at tp = 4 and gpt_nano at tp = 2 (split: heads,
    FFN columns, vocabulary) and at tp = 4 (its 2 heads do not divide:
    the attention reads its leaves whole)."""
    toks = t(inp["gpt_toks"])
    for tag, net, axes in (
            ("h4", _from(inp, GPTModel(**GPT4), "gpt4"), {"tp": world}),
            ("nano2", _gpt(inp), {"dp": 2, "tp": 2}),
            ("nano4", _gpt(inp), {"tp": world})):
        logits, counts = _split_forward(net, parallel.make_mesh(axes), toks)
        out[tag + "_logits"] = logits.numpy()
        for k, v in counts.items():
            out["%s_%s" % (tag, k)] = np.array(v)


def case_split_steps(inp, out, rank, world):
    """GPT (4 heads) and BERT steps on {dp: 2, tp: 2} through
    build_train_step(param_spec=TRANSFORMER_RULES specs): the batch over
    dp, every split leaf consumed by a split layer; SGD, 2 steps, and the
    GPT with momentum and the update sharded over dp (ZeRO-1)."""
    mesh = parallel.make_mesh({"dp": 2, "tp": 2})
    gnet = _from(inp, GPTModel(**GPT4), "gpt4")
    gloss, gplist = parallel.block_loss_fn(
        gnet, gluon.loss.SoftmaxCrossEntropyLoss(), training=False)
    bnet = _from(inp, BERTModel(**BERT4), "bert4")
    bloss, bplist = parallel.block_loss_fn(
        bnet, gluon.loss.SoftmaxCrossEntropyLoss(), training=False,
        out_index=-1)
    gbatch = (t(inp["st_gpt_x"]), t(inp["st_gpt_y"]))
    bbatch = tuple(t(inp["st_bert_" + k])
                   for k in ("ids", "types", "vl", "pos", "labels"))
    for tag, loss_fn, plist, batch, kw in (
            ("gpt", gloss, gplist, gbatch, {}),
            ("bert", bloss, bplist, bbatch, {}),
            ("gpt_zero", gloss, gplist, gbatch,
             {"shard_weight_update": True})):
        named = [(p.name, p._tensor().detach()) for p in plist]
        specs = tp.param_specs([(n, tuple(a.shape)) for n, a in named], mesh)
        blocks = tp.shard_params(named, mesh)
        sgd = opt.SGD(learning_rate=0.1, momentum=0.9 if kw else 0.0)
        states = parallel.tree_optimizer_step(sgd)[0](blocks)
        step = parallel.build_train_step(loss_fn, sgd, mesh=mesh,
                                         param_spec=specs, **kw)
        mine = parallel.shard_batch(batch, mesh)
        tp.reset_counters()
        losses = []
        for i in range(2):
            blocks, states, loss = step(blocks, states, 1 + i, None, mine)
            losses.append(float(loss))
        out[tag + "_losses"] = np.array(losses)
        for k, v in tp.counters.items():
            out["%s_%s" % (tag, k)] = np.array(v)
        out[tag + "_specs"] = np.array([str(tuple(s)) for s in specs])
        for j, b in enumerate(blocks):
            out["%s_p%d" % (tag, j)] = b.detach().numpy()


def case_vocab(inp, out, rank, world):
    """The vocabulary-parallel loss and embedding at tp = 4 on this rank's
    quarter of the vocabulary: the loss, dx for a cotangent, the rows for
    ids in every quarter (and one past the table) and their gradient."""
    mesh = parallel.make_mesh({"tp": world})
    x = parallel.shard_array(t(inp["vx_logits"]), mesh, None, "tp").clone()
    x.requires_grad_(True)
    V = inp["vx_logits"].shape[1]
    scope = tp.tp_scope(mesh, [])
    loss = tp.vocab_parallel_xent([x], t(inp["vx_labels"]),
                                  [rank * V // world], merge=scope.xent_merge)
    loss.backward(t(inp["vx_ct"]))
    out["loss"] = loss.detach().numpy()
    out["dx"] = x.grad.numpy()
    w = parallel.shard_array(t(inp["ve_w"]), mesh, "tp", None).clone()
    w.requires_grad_(True)
    with tp.tp_scope(mesh, [(w, P("tp", None))]) as sc:
        rows = sc.embed(F, t(inp["ve_ids"]), w)
    (rows.nan_to_num(0.0) * t(inp["ve_ct"])).sum().backward()
    out["rows"] = rows.detach().numpy()
    out["dw"] = w.grad.numpy()


def case_dropout(inp, out, rank, world):
    """build_train_step on {dp: 2, tp: 2}: the dropout mask of a
    replicated activation, drawn at steps 1 and 2."""
    mesh = parallel.make_mesh({"dp": 2, "tp": 2})
    masks = []

    def loss_fn(params, batch, key):
        with autograd.record():
            y = F.Dropout(params["w"] * batch, p=0.5, training=True)
        masks.append((y != 0).numpy())
        return y.sum()

    step = parallel.build_train_step(loss_fn, opt.SGD(learning_rate=0.0),
                                     mesh=mesh)
    for i in range(2):
        step({"w": torch.ones(256)}, {"w": ()}, 1 + i, None, torch.ones(256))
    out["masks"] = np.stack(masks)


def case_pipeline_gpt(inp, out, rank, world):
    """1F1B over two GPT blocks (4 heads) on {tp: 2, pp: 2} with
    TRANSFORMER_RULES specs (each stage splits its math over tp), and on
    {dp: 2, pp: 2} unsplit; the loss and each rank's gradient blocks."""
    net = _from(inp, GPTModel(**GPT4), "gpt4")
    blks = list(net.blocks)
    plists = [list(b.collect_params().values()) for b in blks]
    names = [p.name[len(blks[0].prefix):] for p in plists[0]]
    stacked = parallel.stack_stage_params([
        {nm: p._tensor().detach() for nm, p in zip(names, pl)}
        for pl in plists])
    xs, tg = t(inp["pg_xs"]), t(inp["pg_tg"])

    def stage_fn(params, x):
        prev = getattr(_param_store, "params", None)
        _param_store.params = {id(p): params[nm]
                               for p, nm in zip(plists[0], names)}
        try:
            with autograd.record(train_mode=False):
                return blks[0](x)
        finally:
            _param_store.params = prev

    def mse(y, tt):
        return ((y - tt) ** 2).mean()

    tmesh = parallel.make_mesh({"tp": 2, "pp": 2})

    class Fake:
        shape = {"tp": 2}

    spec = {nm: P("pp", *tp.spec_for(nm, tuple(v.shape[1:]),
                                      tp.TRANSFORMER_RULES, Fake))
            for nm, v in stacked.items()}
    for tag, mesh, kw in (("tp", tmesh, {"param_spec": spec}),
                          ("dp", parallel.make_mesh({"dp": 2, "pp": 2}),
                           {})):
        tp.reset_counters()
        loss, grads = parallel.pipeline_train_step_1f1b(
            stage_fn, mse, stacked, xs, tg, mesh, **kw)
        out[tag + "_loss"] = loss.detach().numpy()
        out[tag + "_counters"] = np.array([tp.counters[k] for k in (
            "split", "gathered", "gathered_leaves")])
        for nm, g in grads.items():
            out["%s_g_%s" % (tag, nm)] = g.numpy()
    out["specs"] = np.array([str(tuple(spec[nm])) for nm in sorted(spec)])


def _attn_grads(fn, q, k, v, ct):
    q, k, v = (a.clone().requires_grad_(True) for a in (q, k, v))
    o = fn(q, k, v)
    (o * ct).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def case_ring(inp, out, rank, world):
    """ring_attention at sp = 4 on this rank's blocks, causal and not;
    ulysses_attention likewise (8 heads)."""
    mesh = parallel.make_mesh({"sp": world})

    def blk(a):
        return parallel.shard_array(t(a), mesh, None, None, "sp",
                                    None).contiguous()

    for tag, fn in (("ring", parallel.ring_attention),
                    ("uly", parallel.ulysses_attention)):
        q, k, v, ct = (blk(inp["%s_%s" % (tag, n)])
                       for n in ("q", "k", "v", "ct"))
        for causal in (False, True):
            got = _attn_grads(lambda a, b, c: fn(a, b, c, mesh,
                                                 causal=causal), q, k, v, ct)
            for name, a in zip(("o", "dq", "dk", "dv"), got):
                out["%s_%d_%s" % (tag, causal, name)] = a.numpy()


def case_sp_scope(inp, out, rank, world):
    """gpt_nano, unmodified, inside sequence_parallel_scope: the ring at
    sp = 4, Ulysses at sp = 2 ({dp: 2, sp: 2}, each dp replica its own
    scope); the loss and every parameter's gradient."""
    toks = t(inp["gpt_toks2"])
    for tag, axes, impl in (("ring", {"sp": world}, "ring"),
                            ("uly", {"dp": 2, "sp": 2}, "ulysses")):
        mesh = parallel.make_mesh(axes)
        net = _gpt(inp)
        with parallel.sequence_parallel_scope(mesh, impl=impl):
            with autograd.record(train_mode=False):
                loss = (net(toks).float() ** 2).mean()
            autograd.backward(loss)
        out[tag + "_loss"] = loss.detach().numpy()
        for j, p in enumerate(net.collect_params().values()):
            out["%s_g%d" % (tag, j)] = p._tensor().grad.numpy()


def _stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def case_pipeline(inp, out, rank, world):
    """pipeline_apply over pp = 4 (10 microbatches), the interleaved
    schedule (16 stages, v = 4) with its gradients, and a 1F1B step (7
    microbatches)."""
    mesh = parallel.make_mesh({"pp": world})
    per = [{"w": t(inp["pp_w%d" % i]), "b": t(inp["pp_b%d" % i])}
           for i in range(world)]
    stacked = parallel.stack_stage_params(per)
    out["apply"] = parallel.pipeline_apply(
        _stage, stacked, t(inp["pp_xs"]), mesh).numpy()
    per16 = [{"w": t(inp["il_w%d" % i]), "b": t(inp["il_b%d" % i])}
             for i in range(4 * world)]
    st = parallel.interleave_stage_params(per16, world)
    st = {k: v.requires_grad_(True) for k, v in st.items()}
    y = parallel.pipeline_apply_interleaved(_stage, st, t(inp["il_xs"]),
                                            mesh, n_virtual=4)
    (y ** 2).sum().backward()
    out["il_out"] = y.detach().numpy()
    out["il_gw"], out["il_gb"] = st["w"].grad.numpy(), st["b"].grad.numpy()
    loss, grads = parallel.pipeline_train_step_1f1b(
        _stage, lambda yy, tt: ((yy - tt) ** 2).mean(), stacked,
        t(inp["fb_xs"]), t(inp["fb_tg"]), mesh)
    out["fb_loss"] = loss.numpy()
    out["fb_gw"], out["fb_gb"] = grads["w"].numpy(), grads["b"].numpy()


def _mlp_stage(params, x):
    x = tp.psum_region_entry(x, "tp")
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return tp.psum_region_exit(h @ params["w2"], "tp") + params["b2"]


def case_compose(inp, out, rank, world):
    """1F1B on {tp: 2, pp: 2} (stage weights split over tp, the stage
    closing its tp math with the f/g regions) and on {dp: 2, pp: 2}
    (each dp rank pipelines its half of every microbatch)."""
    per = [{k: t(inp["cp_%s%d" % (k, i)]) for k in ("w1", "b1", "w2", "b2")}
           for i in range(2)]
    stacked = parallel.stack_stage_params(per)
    xs, tg = t(inp["cp_xs"]), t(inp["cp_tg"])

    def mse(y, tt):
        return ((y - tt) ** 2).mean()

    mesh = parallel.make_mesh({"tp": 2, "pp": 2})
    spec = {"w1": P("pp", None, "tp"), "b1": P("pp", "tp"),
            "w2": P("pp", "tp", None), "b2": P("pp")}
    loss, grads = parallel.pipeline_train_step_1f1b(
        _mlp_stage, mse, stacked, xs, tg, mesh, param_spec=spec)
    out["tp_loss"] = loss.numpy()
    for k, g in grads.items():
        out["tp_g" + k] = g.numpy()
    mesh = parallel.make_mesh({"dp": 2, "pp": 2})
    plain = {"w1": P("pp"), "b1": P("pp"), "w2": P("pp"), "b2": P("pp")}

    def stage(params, x):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    loss, grads = parallel.pipeline_train_step_1f1b(
        stage, mse, stacked, xs, tg, mesh, batch_axis="dp", param_spec=plain)
    out["dp_loss"] = loss.numpy()
    for k, g in grads.items():
        out["dp_g" + k] = g.numpy()


def case_moe(inp, out, rank, world):
    """moe_ffn at ep = 4 and at {dp: 2, ep: 2}, each rank its token
    block."""
    rw, w1, w2 = (t(inp["moe_" + n]) for n in ("rw", "w1", "w2"))
    for tag, axes, batch_axis, spec in (
            ("ep", {"ep": world}, None, ("ep", None)),
            ("dpep", {"dp": 2, "ep": 2}, "dp", (("dp", "ep"), None))):
        mesh = parallel.make_mesh(axes)
        x = parallel.shard_array(t(inp["moe_x"]), mesh, *spec)
        y, aux = parallel.moe_ffn(x, rw, w1, w2, mesh,
                                  capacity_factor=8.0, batch_axis=batch_axis)
        out[tag + "_y"] = y.numpy()
        out[tag + "_aux"] = aux.numpy()


def case_sync_bn(inp, out, rank, world):
    """SyncBatchNorm on a quarter of the batch a rank: the output block,
    dx, this rank's dgamma/dbeta and the running statistics."""
    mesh = parallel.make_mesh({"dp": world})
    bn = SyncBatchNorm(in_channels=3, mesh=mesh)
    bn.initialize(device="cpu")
    x = parallel.shard_array(t(inp["bn_x"]), mesh, "dp").clone()
    w = parallel.shard_array(t(inp["bn_w"]), mesh, "dp")
    x.requires_grad_(True)
    with autograd.record():
        y = bn(x)
        loss = (y * w).sum()
    loss.backward()  # x is a plain leaf, not a recorded variable
    out["y"] = y.detach().numpy()
    out["dx"] = x.grad.numpy()
    out["dgamma"] = bn.gamma._tensor().grad.numpy()
    out["dbeta"] = bn.beta._tensor().grad.numpy()
    out["rmean"] = bn.running_mean._tensor().numpy()
    out["rvar"] = bn.running_var._tensor().numpy()


CASES = [("regions", case_regions), ("dptp", case_dp_tp),
         ("gpt_tp", case_gpt_tp), ("ring", case_ring),
         ("sp_scope", case_sp_scope), ("pipeline", case_pipeline),
         ("compose", case_compose), ("moe", case_moe),
         ("sync_bn", case_sync_bn), ("gpt_split", case_gpt_split),
         ("split_steps", case_split_steps), ("vocab", case_vocab),
         ("dropout", case_dropout), ("pipeline_gpt", case_pipeline_gpt)]


if __name__ == "__main__":
    run_cases(sys.argv[1:], CASES)
