"""One rank of the port's multi-rank CPU tests (gloo).

    python tests/torch_port_dist_worker.py RANK WORLD WORKDIR

Joins a gloo group of WORLD ranks through a file store in WORKDIR, reads
WORKDIR/inputs.npz (the seeded inputs and initial weights the test wrote),
runs every case of ``CASES`` in order and writes its results to
WORKDIR/rank<RANK>.npz (a case that raises writes its traceback under
``<case>/error``). ``tests/test_torch_port_dist.py`` starts the ranks once
a module and holds the results against the JAX package.
"""
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mxnet_tpu_torch import autograd, dist, gluon, parallel  # noqa: E402
from mxnet_tpu_torch import optimizer as opt  # noqa: E402
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.parallel import distributed  # noqa: E402

CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def case_hierarchical(inp, out, rank):
    mesh = parallel.make_mesh({"dcn": 2, "dp": 2})
    x = inp["hier_x"]
    h = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn")
    o, res = h.reduce(t(x[rank]))
    out["sum"] = o.numpy()
    out["res_is_none"] = np.array(res is None)
    ha = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                    average=True)
    out["mean"] = ha.reduce(t(x[rank]))[0].numpy()
    mesh1 = parallel.make_mesh({"dp": 4})
    x1 = inp["single_x"]
    h1 = dist.HierarchicalAllreduce(mesh1, ici_axis="dp")
    out["single"] = h1.reduce(t(x1[rank]))[0].numpy()
    h2 = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn")
    out["replicated"] = h2.reduce(t(inp["rep_v"]), stacked=False)[0].numpy()
    hk = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                    dcn="kvstore")
    out["kv_host_hop"] = np.array(hk.needs_host_hop)
    out["kv_sum"] = hk.reduce(t(inp["kv_x"][rank]))[0].numpy()
    flat = dist.FlatAllreduce(mesh1, axes=("dp",), average=True)
    out["flat_mean"] = flat.reduce(t(x1[rank]))[0].numpy()


def case_error_feedback(inp, out, rank):
    mesh = parallel.make_mesh({"dcn": 2, "dp": 2})
    v = t(inp["ef_v"])
    for ctype in ("fp16", "int8", "2bit"):
        h = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                       compression={"type": ctype})
        res = h.residual_init(h.pad_to(64))
        cum = torch.zeros(64)
        exact = True
        for _ in range(6):
            shard = v.narrow(0, mesh.local_rank("dp") * 32, 32)
            acc = shard + res
            o, res = h.reduce(v, res, stacked=False)
            quant, deq = h._codec
            payload, r2 = quant(acc)
            exact &= bool(torch.equal(deq(payload) + r2, acc))
            cum += o
        out[ctype + "_cum"] = cum.numpy()
        out[ctype + "_res"] = res.numpy()
        out[ctype + "_exact"] = np.array(exact)
    h = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn",
                                   compression={"type": "2bit",
                                                "threshold": 0.5})
    res = h.residual_init(h.pad_to(32))
    outs = []
    for _ in range(5):
        o, res = h.reduce(torch.full((32,), 0.2), res, stacked=False)
        outs.append(o.numpy())
    out["small_outs"] = np.stack(outs)


def case_bucketer(inp, out, rank):
    mesh = parallel.make_mesh({"dcn": 2, "dp": 2})
    shapes = [tuple(int(x) for x in s if x) for s in inp["bucket_shapes"]]
    grads = [t(inp["bucket_g%d" % i][rank]) for i in range(len(shapes))]
    strat = dist.HierarchicalAllreduce(mesh, ici_axis="dp", dcn_axis="dcn")
    b = dist.GradientBucketer(strat, bucket_mb=0.01)
    avals = [(s, torch.float32) for s in shapes]
    p0 = dist.plan_counter.count
    plan = b.plan(avals)
    out["plan"] = np.array([i for bk in plan for i in bk] + [-1] + [
        len(bk) for bk in plan])
    out["plan_cached"] = np.array(b.plan(avals) is plan)
    r1 = b.exchange(grads)
    for i, r in enumerate(r1):
        out["g%d" % i] = r.numpy()
    c0, n0 = dist.plan_counter.count, dist.bucket_counter.count
    b.exchange(grads)
    out["steady_plans"] = np.array(dist.plan_counter.count - c0)
    out["steady_launches"] = np.array(dist.bucket_counter.count - n0)
    out["plans_made"] = np.array(dist.plan_counter.count - p0)


def _net(inp, prefix):
    net = nn.Sequential()
    net.add(nn.Dense(32, activation="relu", in_units=8),
            nn.Dense(16, activation="relu", in_units=32),
            nn.Dense(1, in_units=16))
    net.initialize(device="cpu")
    params = list(net.collect_params().values())
    for j, p in enumerate(params):
        p.set_data(t(inp["%s_w%d" % (prefix, j)]))
    return net


def _train(inp, rank, world, attach_kw=None, kvstore="device",
           batch_scale=1, keep=False):
    net = _net(inp, "mlp")
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore=kvstore)
    mesh = parallel.make_mesh({"dp": world})
    handle = None
    if attach_kw is not None:
        handle = dist.attach(tr, mesh, ici_axis="dp", average=True,
                             **attach_kw)
    xs, ys = inp["mlp_xs"], inp["mlp_ys"]
    per = xs.shape[1] // world
    losses, memory = [], []
    for s in range(xs.shape[0]):
        if handle is not None:
            handle.gather_params()
        x = t(xs[s, rank * per:(rank + 1) * per])
        y = t(ys[s, rank * per:(rank + 1) * per])
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        autograd.backward(loss)
        glob = loss.detach().clone()
        torch.distributed.all_reduce(glob)
        losses.append(float(glob) / world)
        tr.step(xs.shape[1] * batch_scale)
        if handle is not None and handle.manager is not None:
            memory.append(handle.manager.param_bytes())
    if handle is not None:
        handle.gather_params()
    weights = [p._tensor().detach().clone().numpy()
               for p in net.collect_params().values()]
    if handle is not None and not keep:
        dist.detach(tr)
    return tr, handle, np.array(losses), weights, memory


def case_trainer_zero(inp, out, rank, world):
    for zero in (0, 1, 2, 3):
        b0 = dist.bucket_counter.count
        tr, handle, losses, weights, memory = _train(
            inp, rank, world, {"zero": zero, "bucket_mb": 0.001}, keep=True)
        out["z%d_losses" % zero] = losses
        for j, w in enumerate(weights):
            out["z%d_w%d" % (zero, j)] = w
        out["z%d_launches" % zero] = np.array(dist.bucket_counter.count - b0)
        out["z%d_windows" % zero] = np.array(
            handle.exchanger.windows_ms, dtype=np.float64)
        out["z%d_stats" % zero] = np.array(
            [dist.stats()["attached_trainers"],
             handle.bucketer.stats()["layouts"]])
        if memory:
            out["z3_bytes"] = np.array(memory[-1])
        st = tr._states
        out["z%d_state_numel" % zero] = np.array(sum(
            s.numel() for i in st for s in _leaves(st[i])))
        out["z%d_state_bytes" % zero] = np.array(
            [dist.per_device_bytes(st), dist.global_bytes(st)])
        if zero == 1:
            path = os.path.join(inp["workdir"].item(), "z1.states")
            before = [s.clone() for i in sorted(st) for s in _leaves(st[i])]
            tr.save_states(path)
            torch.distributed.barrier()
            for i in st:
                for s in _leaves(st[i]):
                    s.zero_()
            tr.load_states(path)
            after = [s for i in sorted(tr._states)
                     for s in _leaves(tr._states[i])]
            out["z1_state_roundtrip"] = np.array(
                len(before) == len(after) and all(
                    torch.equal(a, b) for a, b in zip(before, after)))
        if zero == 3:
            mgr = handle.manager
            mgr.release()
            per_sharded, glob = mgr.param_bytes()
            vals = [mgr.shard(p).clone() for p in mgr.params]
            handle.gather_params()
            per_gathered, _ = mgr.param_bytes()
            full = [p._data.detach().clone() for p in mgr.params]
            handle.release_params()
            out["z3_roundtrip"] = np.array(
                [per_sharded, glob, per_gathered, mgr.param_bytes()[0]])
            out["z3_blocks_kept"] = np.array(all(
                torch.equal(mgr.shard(p), v) for p, v in zip(mgr.params,
                                                              vals)))
            for j, f in enumerate(full):
                out["z3_full%d" % j] = f.numpy()
        dist.detach(tr)
        out["z%d_detached" % zero] = np.array(
            [tr._dist is None, not handle.exchanger._hooks,
             dist.stats()["attached_trainers"] == 0])
    # detach restores the plain path: a backward and a local step launch
    # no bucket
    b0 = dist.bucket_counter.count
    net = _net(inp, "mlp")
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    with autograd.record():
        loss = ((net(t(inp["mlp_xs"][0])) - t(inp["mlp_ys"][0])) ** 2).mean()
    autograd.backward(loss)
    tr.step(16)
    out["plain_after_detach_launches"] = np.array(
        dist.bucket_counter.count - b0)


def _accumulated(inp, rank, world, zero, compression=None, second=1.0):
    """grad_req="add": each step two backwards before the update (the
    halves of rank ``rank``'s quarter of the batch, the second's loss
    scaled by ``second``; ``second=None`` runs the first only) through
    attach at ZeRO ``zero``; returns (losses, weights, bucket launches,
    buckets)."""
    net = _net(inp, "mlp")
    for p in net.collect_params().values():
        p.grad_req = "add"
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    handle = dist.attach(tr, parallel.make_mesh({"dp": world}),
                         ici_axis="dp", average=True, zero=zero,
                         bucket_mb=0.001, compression=compression)
    xs, ys = inp["mlp_xs"], inp["mlp_ys"]
    per = xs.shape[1] // world
    part = per // 2
    b0 = dist.bucket_counter.count
    losses = []
    for s in range(xs.shape[0]):
        handle.gather_params()
        total = torch.zeros(())
        for h in range(1 if second is None else 2):
            lo = rank * per + h * part
            x, y = t(xs[s, lo:lo + part]), t(ys[s, lo:lo + part])
            with autograd.record():
                loss = ((net(x) - y) ** 2).sum() / per
                if h == 1:
                    loss = loss * second
            autograd.backward(loss)
            total += loss.detach()
        torch.distributed.all_reduce(total)
        losses.append(float(total) / world)
        tr.step(xs.shape[1])
        net.collect_params().zero_grad()
    handle.gather_params()
    weights = [p._tensor().detach().clone().numpy()
               for p in net.collect_params().values()]
    launches = dist.bucket_counter.count - b0
    buckets = len(handle.exchanger._plan)
    dist.detach(tr)
    return np.array(losses), weights, launches, buckets


def case_accumulate(inp, out, rank, world):
    for zero in (0, 2):
        losses, weights, launches, buckets = _accumulated(inp, rank, world,
                                                          zero)
        out["z%d_losses" % zero] = losses
        for j, w in enumerate(weights):
            out["z%d_w%d" % (zero, j)] = w
        out["z%d_launches" % zero] = np.array([launches, buckets])
    # with fp16 error feedback: a second backward adding exactly zero
    # leaves the step, residuals included, bit for bit that of one
    comp = {"type": "fp16"}
    _, w2, _, _ = _accumulated(inp, rank, world, 0, comp, second=0.0)
    _, w1, _, _ = _accumulated(inp, rank, world, 0, comp, second=None)
    out["fp16_second_zero_equal"] = np.array(
        all(np.array_equal(a, b) for a, b in zip(w2, w1)))


def _leaves(s):
    if isinstance(s, torch.Tensor):
        return [s]
    if isinstance(s, dict):
        return [x for k in sorted(s) for x in _leaves(s[k])]
    if isinstance(s, (list, tuple)):
        return [x for v in s for x in _leaves(v)]
    return []


def case_overlap_vs_serialized(inp, out, rank, world):
    _, _, lo, wo, _ = _train(inp, rank, world,
                             {"zero": 0, "bucket_mb": 0.001})
    out["overlapped"] = lo
    _, _, ls, ws, _ = _train(inp, rank, world, None, kvstore="dist_sync",
                             batch_scale=world)
    out["serialized"] = ls
    out["weights_gap"] = np.array(max(float(np.abs(a - b).max())
                                      for a, b in zip(wo, ws)))


def case_elastic(inp, out, rank, world):
    def build_step(mesh):
        n = mesh.size
        r = mesh.local_rank("dp")
        group = mesh.group("dp")

        def step(state, batch):
            w, k = state
            xb, yb = batch
            per = xb.shape[0] // n
            x, y = xb[r * per:(r + 1) * per], yb[r * per:(r + 1) * per]
            g = 2.0 * x.T @ (x @ w - y) / xb.shape[0]
            loss = ((x @ w - y) ** 2).sum() / xb.shape[0]
            flat = torch.cat([g.reshape(-1), loss.reshape(1)])
            torch.distributed.all_reduce(flat, group=group)
            return (w - 0.1 * flat[:-1].reshape(w.shape), k + 1), flat[-1]

        def place(state, mesh):
            return tuple(torch.as_tensor(a).clone() for a in state)

        return step, place

    def make_batch(s):
        return t(inp["el_x%d" % s]), t(inp["el_y%d" % s])

    init = (torch.zeros(4, 1), torch.zeros((), dtype=torch.int32))
    base = inp["workdir"].item()
    plain = dist.ElasticTrainer(build_step, init, make_batch,
                                os.path.join(base, "el_plain"),
                                save_every=3).run(12)
    drill = dist.ElasticTrainer(build_step, init, make_batch,
                                os.path.join(base, "el_drill"),
                                save_every=3)
    r = drill.run(12, fail_at=7)
    out["plain_losses"] = np.array([plain.losses[s] for s in range(12)])
    out["plain_w"] = plain.state[0].numpy()
    out["left"] = np.array(r.left)
    if not r.left:
        evt = r.recoveries[0]
        out["event"] = np.array([evt["failed_step"], evt["survivors"],
                                 evt["resumed_from"], len(r.recoveries)])
        out["drill_losses"] = np.array([r.losses[s] for s in range(12)])
        out["drill_w"] = r.state[0].numpy()
        out["drill_n"] = np.array(int(r.state[1]))
    out["recorded"] = np.array(dist.stats()["elastic_recoveries_recorded"])
    torch.distributed.barrier()


def case_kvstore(inp, out, rank, world):
    from mxnet_tpu_torch import kvstore

    kv = kvstore.create("dist_sync")
    kv.init("w", torch.zeros(4))
    kv.push("w", torch.full((4,), float(rank + 1)))
    out["world_sum"] = kv.pull("w").asnumpy()
    pair = torch.distributed.new_group([0, 1])
    if rank in (0, 1):
        kv2 = kvstore.DistKVStore("dist_sync", group=pair)
        kv2.init("w", torch.zeros(4))
        kv2.push("w", torch.full((4,), float(rank + 1)))
        out["pair_sum"] = kv2.pull("w").asnumpy()
    out["workers"] = np.array([kv.rank, kv.num_workers])
    # Trainer(kvstore="dist_sync", compression_params=): each rank's
    # pushes are ternarized before the sum
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                       kvstore="dist_sync",
                       compression_params={"type": "2bit", "threshold": 0.5})
    out["compression"] = np.array([tr._kvstore._compression["threshold"]])
    w = net.weight._tensor()
    w.grad = torch.full_like(w, 0.7 if rank % 2 == 0 else 0.2)
    net.bias._tensor().grad = torch.zeros(4)
    tr.allreduce_grads()
    out["compressed_grad"] = w.grad.numpy().copy()


def case_train_step(inp, out, rank, world):
    mesh = parallel.make_mesh({"dp": world})
    sgd = opt.SGD(learning_rate=0.1)

    def loss_fn(params, batch, key):
        x, y = batch
        return ((x @ params["w"] + params["b"] - y) ** 2).mean()

    params = {"w": torch.ones(4, 1), "b": torch.zeros(1)}
    states = {"w": (), "b": ()}
    step = parallel.build_train_step(loss_fn, sgd, mesh=mesh,
                                     batch_spec=(parallel.P("dp"),
                                                 parallel.P("dp")))
    batch = parallel.shard_batch((t(inp["ts_x"]), t(inp["ts_y"])), mesh)
    p, s, loss = step(params, states, 1, None, batch)
    out["ts_loss"] = loss.numpy()
    out["ts_w"] = p["w"].numpy()
    out["ts_b"] = p["b"].numpy()
    # the same with the update sharded (ZeRO-1)
    params = {"w": torch.ones(4, 1), "b": torch.zeros(1)}
    step = parallel.build_train_step(loss_fn, sgd, mesh=mesh,
                                     shard_weight_update=True)
    p, _, _ = step(params, {"w": (), "b": ()}, 1, None, batch)
    out["ts_sharded_w"] = p["w"].numpy()
    # with a momentum state, 3 steps: the sharded states are the blocks
    mom = opt.SGD(learning_rate=0.1, momentum=0.9)
    init_states, _ = parallel.tree_optimizer_step(mom)
    for tag, sharded in (("whole", False), ("sharded", True)):
        params = {"w": torch.ones(8, 1), "b": torch.zeros(1)}
        states = init_states(params)
        step = parallel.build_train_step(loss_fn, mom, mesh=mesh,
                                         shard_weight_update=sharded)
        x8 = t(np.tile(inp["ts_x"], (1, 2)))
        b8 = parallel.shard_batch((x8, t(inp["ts_y"])), mesh)
        for i in range(3):
            params, states, _ = step(params, states, 1 + i, None, b8)
        out["ts_mom_%s_w" % tag] = params["w"].numpy()
        out["ts_mom_%s_state" % tag] = np.array(
            [states["w"].numel(), states["b"].numel()])
    # block_loss_fn: a Gluon block + loss, Adam, 5 steps
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=4),
            nn.Dense(2, in_units=8))
    net.initialize(device="cpu")
    loss_fn2, plist = parallel.block_loss_fn(
        net, gluon.loss.SoftmaxCrossEntropyLoss())
    for j, p in enumerate(plist):
        p.set_data(t(inp["bl_w%d" % j]))
    arrays = [p._tensor().detach().clone() for p in plist]
    parallel.replicate_params(arrays, mesh)
    adam = opt.Adam()
    init_states, _ = parallel.tree_optimizer_step(adam)
    states = init_states(arrays)
    step = parallel.build_train_step(loss_fn2, adam, mesh=mesh)
    batch = parallel.shard_batch((t(inp["bl_x"]), t(inp["bl_y"])), mesh)
    losses = []
    for i in range(5):
        arrays, states, loss = step(arrays, states, 1 + i, None, batch)
        losses.append(float(loss))
    out["bl_losses"] = np.array(losses)
    for j, a in enumerate(arrays):
        out["bl_p%d" % j] = a.numpy()


CASES = [("hier", case_hierarchical), ("ef", case_error_feedback),
         ("bucket", case_bucketer), ("kv", case_kvstore),
         ("trainer", case_trainer_zero),
         ("overlap", case_overlap_vs_serialized),
         ("accumulate", case_accumulate), ("step", case_train_step),
         ("elastic", case_elastic)]


def main(argv, cases=None):
    """Run ``cases`` (default ``CASES``) on this rank."""
    cases = CASES if cases is None else cases
    rank, world, workdir = int(argv[0]), int(argv[1]), argv[2]
    torch.set_num_threads(1)
    os.environ["MXNET_DIST_BUCKET_MB"] = "2.5"
    env_cap = dist.default_bucket_mb()
    distributed.init_process_group(
        init_method="file://" + os.path.join(workdir, "store"),
        num_processes=world, process_id=rank, device="cpu", timeout_s=120)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    results = {"env_bucket_mb": np.array(env_cap),
               "rank_size": np.array([distributed.rank(),
                                      distributed.size()])}
    for name, fn in cases:
        out = {}
        try:
            if fn.__code__.co_argcount == 4:
                fn(inp, out, rank, world)
            else:
                fn(inp, out, rank)
        except Exception:
            out = {"error": np.array(traceback.format_exc())}
            print("rank %d case %s failed:\n%s" % (
                rank, name, out["error"]), file=sys.stderr, flush=True)
            torch.distributed.barrier()
        results.update({"%s/%s" % (name, k): v for k, v in out.items()})
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **results)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
