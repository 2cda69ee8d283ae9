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

from mxnet_tpu_torch import autograd, parallel  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch.convert import from_jax_params  # noqa: E402
from mxnet_tpu_torch.gluon.block import _param_store  # noqa: E402
from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm  # noqa: E402
from mxnet_tpu_torch.models.gpt import gpt_nano  # noqa: E402
from mxnet_tpu_torch.parallel import P  # noqa: E402
from mxnet_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402
from torch_port_dist_worker import main as run_cases  # noqa: E402


def t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_(True) if grad else x


def _gpt(inp):
    net = gpt_nano()
    params = {k[len("gpt/"):]: v for k, v in inp.items()
              if k.startswith("gpt/")}
    return from_jax_params(net, params)


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
         ("sync_bn", case_sync_bn)]


if __name__ == "__main__":
    run_cases(sys.argv[1:], CASES)
