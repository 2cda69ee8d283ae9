#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (into
   ``mxnet_tpu_torch/_build/``) and prints the build time;
2. holds the LayerNorm kernel against its plain PyTorch version;
3. holds the flash-attention forward kernel against its plain version
   (valid lengths with 0, causal, logsumexp, ragged T = 200, head dim 128);
4. serves BERT-base (full width, bf16, random weights from a seed) through
   ``ModelServer(buckets=(1, 4, 8))`` at seq 512: 16 requests with valid
   lengths spread over 1..512; every served row must match a direct forward
   of the same model on the card, which must match the same forward with
   the plain versions in place of the kernels; the LayerNorm and flash
   counters must rise by 25 and 12 per forward; it serves two bursts and
   prints each one's p50/p99 latency and req/s;
5. breaks one forward at the largest bucket down: host wall, the
   executor's whole dispatch, a new thread's first dispatches, and kernel
   time by class (torch.profiler), hence the device's idle share;
6. times each kernel (CUDA-graph replay) against its plain version, its
   PyTorch library yardstick and its bound, and dense against flash
   attention at seq 128 and 512.

It prints the card's name and power limit and one JSON line of kernel
records, and ends with ``{"ok": true, "device": {...}}``. Any failed phase
ends the run with a nonzero exit. Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEQ = 512
BUCKETS = (1, 4, 8)
N_REQUESTS = 16
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s, fp32
# FLOP/s outside the tensor cores, HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# a kernel against its plain version, elementwise: |kernel - plain| <=
# atol + rtol * |plain| + mtol * mag. LayerNorm, bf16: rtol 2**-6 is two
# bf16 steps at any magnitude, atol 1e-3 two steps at |y| ~ 0.06; fp32: a
# few fp32 steps of a reordered sum. Flash: both sides round each p to
# bf16 (relative error <= 2**-8) at different running maxima, so the sum
# p @ v may differ by 2**-7 * mag, mag = (p @ |v|) / l, the plain version
# on |v|; each output's own rounding adds a step of |plain|
BF16_TOL = (1e-3, 2.0 ** -6, 0.0)
FP32_TOL = (1e-5, 1e-5, 0.0)
FLASH_TOL = (1e-5, 2.0 ** -6, 2.0 ** -7)
# flash logsumexp, fp32 row statistics, absolute
LSE_TOL = 1e-3
# served BERT rows against a direct forward (bf16 through 12 layers)
MODEL_TOL = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(*fns, rounds=3, iters=20):
    """Device time in ms of one call of each callable: ``iters`` calls are
    captured into a CUDA graph, and a replay is timed with CUDA events, so
    the host's launch cost (larger than a small kernel's run) stays out.
    The graphs take turns for ``rounds`` rounds, so a clock change hits
    all of them, and each keeps its median round. One callable gives a
    number, several a list."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for fn in fns:
            for _ in range(3):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graphs.append(graph)
    times = [[] for _ in fns]
    for _ in range(rounds):
        for graph, out in zip(graphs, times):
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / iters)
    del graphs
    torch.cuda.empty_cache()
    med = [float(np.median(t)) for t in times]
    return med[0] if len(fns) == 1 else med


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def held(got, ref, tol, what, mag=None):
    """Check ``|got - ref| <= atol + rtol * |ref| + mtol * mag`` everywhere
    (``mag`` defaults to 0); print and return the reading: max abs error,
    max |ref| and the worst ratio of error to its limit (at most 1 to
    pass)."""
    import torch

    atol, rtol, mtol = tol
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    limit = atol + rtol * ref.abs()
    if mag is not None:
        limit = limit + mtol * mag.float()
    reading = {"case": what, "max_abs_err": float(err.max()),
               "max_abs_plain": float(ref.abs().max()),
               "worst_ratio": float((err / limit).max()),
               "atol": atol, "rtol": rtol, "mtol": mtol}
    print("%s: max |kernel - plain| %.3g, max |plain| %.3g, worst error/limit "
          "%.3f (limit %g + %g |plain| + %g mag)" % (
              what, reading["max_abs_err"], reading["max_abs_plain"],
              reading["worst_ratio"], atol, rtol, mtol), flush=True)
    check(bool(torch.isfinite(got).all()), "%s: non-finite output" % what)
    check(reading["worst_ratio"] <= 1.0,
          "%s: kernel disagrees with its plain version" % what)
    return reading


def phase_build():
    from mxnet_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.extension(verbose=True)
    print("build: %.1f s (%s)" % (time.perf_counter() - t0, _build.BUILD_DIR),
          flush=True)


def phase_layernorm(dev):
    import torch
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED)
    readings = []
    for (R, C), dtype, eps, tol in (((4096, 768), torch.bfloat16, 1e-12,
                                     BF16_TOL),
                                    ((1000, 1000), torch.float32, 1e-5,
                                     FP32_TOL)):
        x = (torch.randn(R, C, device=dev, generator=g) * 2 + 0.5).to(dtype)
        gamma = torch.randn(C, device=dev, generator=g)
        beta = torch.randn(C, device=dev, generator=g)
        y = fused_layernorm(x, gamma, beta, eps)
        torch.cuda.synchronize()
        ref = layernorm_plain(x, gamma, beta, eps)
        check(y.dtype == dtype and y.shape == x.shape, "layernorm shape/dtype")
        readings.append(held(y, ref, tol, "layernorm %s %s eps %g"
                             % ((R, C), str(dtype)[6:], eps)))
    return readings


def _qkv(dev, g, B, H, T, D):
    import torch

    return [torch.randn(B, H, T, D, device=dev, generator=g)
            .to(torch.bfloat16) for _ in range(3)]


def flash_magnitude(q, k, v, vl=None, causal=False, scale=None):
    """(p @ |v|) / l of each output element, from the plain version on |v|:
    the size of the sum whose terms the kernel rounds."""
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

    return flash_attention_plain(q, k, v.abs(), kv_valid_len=vl,
                                 causal=causal, scale=scale)


def phase_flash(dev):
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED)
    readings = []
    cases = [
        # name, (B, H, T, D), causal, valid lengths, lse
        ("bert-512 vl", (8, 12, 512, 64), False,
         rng.choice([0, 1, 37, 256, 512], 8), False),
        ("causal", (2, 12, 512, 64), True, None, False),
        ("causal vl lse", (2, 12, 512, 64), True, np.array([300, 512]), True),
        ("lse", (4, 12, 512, 64), False, np.array([0, 1, 256, 512]), True),
        ("ragged T=200", (3, 4, 200, 64), False, np.array([200, 0, 77]), True),
        ("D=128", (2, 8, 256, 128), False, np.array([256, 100]), True),
    ]
    for name, (B, H, T, D), causal, vl, lse in cases:
        q, k, v = _qkv(dev, g, B, H, T, D)
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        got = flash_attention(q, k, v, causal=causal, kv_valid_len=vlt,
                              return_lse=lse)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, kv_valid_len=vlt, causal=causal,
                                    return_lse=lse)
        what = "flash %s %s causal=%s vl=%s" % (
            name, (B, H, T, D), causal, None if vl is None else
            [int(n) for n in vl])
        if lse:
            (got, got_lse), (ref, ref_lse) = got, ref
            # fp32 row statistics; rows without a valid key hold -1e30
            lse_err = max_err(got_lse, ref_lse)
            print("%s: max |lse - plain lse| %.3g (limit %g)"
                  % (what, lse_err, LSE_TOL))
            check(lse_err <= LSE_TOL, "%s: lse disagrees" % what)
        check(got.shape == q.shape and got.dtype == torch.bfloat16,
              "%s: shape/dtype" % what)
        readings.append(held(got, ref, FLASH_TOL, what,
                             flash_magnitude(q, k, v, vlt, causal)))
        if vl is not None:
            for b in np.flatnonzero(np.asarray(vl) == 0):
                check(not bool(got[b].any()), "%s: vl=0 row not zero" % what)
    return readings


def _bert_requests():
    rng = np.random.RandomState(SEED)
    vl = np.linspace(1, SEQ, N_REQUESTS).astype(np.int32)
    rng.shuffle(vl)
    tok = rng.randint(0, 30522, (N_REQUESTS, SEQ)).astype(np.int32)
    tt = (np.arange(SEQ)[None, :] >= vl[:, None] // 2).astype(np.int32)
    return tok, tt, vl


def phase_serve(dev):
    """BERT-base served through ModelServer in two bursts of requests;
    returns the model, the kernel launch counts of the serving run, the
    forwards it took, the request valid lengths and the serving numbers."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.ops import attention, functional
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.serve import ModelServer

    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    n_params = sum(p.data().numel() for p in model.collect_params().values())
    print("bert_base: %d parameters, bf16 (norms fp32), seq %d" % (n_params,
                                                                   SEQ))
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    t0 = time.perf_counter()
    srv = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, device=dev)
    torch.cuda.synchronize()
    print("server warmup (%s buckets): %.2f s" % (list(BUCKETS),
                                                  time.perf_counter() - t0))
    tok, tt, vl = _bert_requests()

    bursts, outputs = [], []
    with srv:
        batches0 = srv.metrics.batches
        ln.fused_layernorm.launches = 0
        fa.flash_attention.launches = 0
        # the first burst meets a fresh dispatcher thread; the second one
        # is the steady state
        for burst in ("first", "second"):
            t0 = time.perf_counter()
            handles = [(time.perf_counter(), srv.submit(tok[i], tt[i], vl[i]))
                       for i in range(N_REQUESTS)]
            served, lat = [], []
            for t_sub, h in handles:  # in submit order, which is batch order
                served.append(h.result(timeout_s=300))
                lat.append((time.perf_counter() - t_sub) * 1e3)
            wall = time.perf_counter() - t0
            outputs.append(served)
            bursts.append({"burst": burst, "wall_ms": wall * 1e3,
                           "req_per_s": N_REQUESTS / wall,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99))})
            print("burst %-6s: %d requests, %.1f ms wall, %.2f req/s, p50 "
                  "%.2f ms, p99 %.2f ms" % (
                      burst, N_REQUESTS, wall * 1e3, N_REQUESTS / wall,
                      bursts[-1]["p50_ms"], bursts[-1]["p99_ms"]), flush=True)
        launches = {"layernorm": ln.fused_layernorm.launches,
                    "flash_attention_fwd": fa.flash_attention.launches}
        forwards = srv.metrics.batches - batches0
        stats = srv.stats()
    print("served %d requests in %d forwards, fill %.3f"
          % (2 * N_REQUESTS, forwards, stats["batch_fill_ratio"]), flush=True)
    print("kernel launches in the serving run: %s" % launches)
    check(stats["errors"] == 0 and stats["completed"] >= 2 * N_REQUESTS,
          "serving errors: %s" % stats)
    check(forwards >= 1, "no forward dispatched")
    check(launches["layernorm"] == 25 * forwards,
          "layernorm launches %d != 25 x %d forwards"
          % (launches["layernorm"], forwards))
    check(launches["flash_attention_fwd"] == 12 * forwards,
          "flash launches %d != 12 x %d forwards"
          % (launches["flash_attention_fwd"], forwards))

    # reference 1: a direct forward of the same model on the card
    ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]
    with torch.inference_mode():
        direct = [o.float().cpu().numpy() for o in model(*ins)]
    # reference 2: the same forward with the plain versions in place of the
    # kernels (patched into the op modules for this call only)
    saved = (functional.fused_layernorm, attention.flash_attention)
    functional.fused_layernorm = ln.layernorm_plain
    attention.flash_attention = (
        lambda q, k, v, **kw: fa.flash_attention_plain(q, k, v, **kw))
    try:
        with torch.inference_mode():
            plain = [o.float().cpu().numpy() for o in model(*ins)]
    finally:
        functional.fused_layernorm, attention.flash_attention = saved

    def real_rows(outs, i):
        """Request i's sequence rows up to its valid length, pooled, NSP."""
        n = int(vl[i])
        return outs[0][i, :n], outs[1][i], outs[2][i]

    U = model._units
    worst_served = worst_plain = 0.0
    for served in outputs:
        check(served[0][0].shape == (1, SEQ, U)
              and served[0][1].shape == (1, U)
              and served[0][2].shape == (1, 2), "served output shapes")
        stacked = [np.concatenate([s[j] for s in served]) for j in range(3)]
        for i in range(N_REQUESTS):
            for a, b in zip(real_rows(stacked, i), real_rows(direct, i)):
                check(np.isfinite(a).all(), "non-finite served output")
                worst_served = max(worst_served, float(np.abs(a - b).max()))
    for i in range(N_REQUESTS):
        for a, b in zip(real_rows(direct, i), real_rows(plain, i)):
            check(np.isfinite(a).all() and np.isfinite(b).all(),
                  "non-finite direct output")
            worst_plain = max(worst_plain, float(np.abs(a - b).max()))
    print("BERT served rows vs direct forward: max abs %.3g; direct forward "
          "with kernels vs with plain versions: max abs %.3g (tol %g)"
          % (worst_served, worst_plain, MODEL_TOL), flush=True)
    # bf16 through 12 layers, different batch compositions (GEMM shapes)
    # and different rounding points of p: two bf16 steps at |x| ~ 4
    check(worst_served <= MODEL_TOL, "served rows disagree with direct")
    check(worst_plain <= MODEL_TOL, "kernels disagree with plain versions "
          "inside the model")
    return model, launches, forwards, vl, {"bursts": bursts,
                                           "server_stats": stats}


def _kernel_class(name):
    if "flash_fwd_kernel" in name:
        return "flash"
    if "layernorm_fwd_kernel" in name:
        return "layernorm"
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def phase_breakdown(dev, model):
    """Where one serving forward at the largest bucket spends its time: the
    host wall of the forward and of the executor's whole dispatch (pad,
    copy in, forward, copy out), a fresh thread's first dispatches, and the
    kernel time by class from torch.profiler, hence the device's idle
    share of the forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serve import BucketedExecutor

    B = BUCKETS[-1]
    tok, tt, vl = (a[:B] for a in _bert_requests())
    ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]

    def forward():
        with torch.inference_mode():
            model(*ins)

    forward()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    fn, _ = model.serving_fn()
    plist = list(model.collect_params().values())
    pool = BucketedExecutor(fn, lambda: [p.data() for p in plist], (B,), dev)

    def timed_dispatch(into):
        t0 = time.perf_counter()
        pool.run([tok, tt, vl])
        into.append((time.perf_counter() - t0) * 1e3)

    # a thread's first dispatch against its later ones (the server's
    # dispatcher is a fresh thread after every start())
    per_thread = []
    worker = threading.Thread(target=lambda: [timed_dispatch(per_thread)
                                              for _ in range(3)])
    worker.start()
    worker.join()
    dispatch = []
    for _ in range(10):
        timed_dispatch(dispatch)

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            forward()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / n_prof
    by_class = {"gemm": 0.0, "flash": 0.0, "layernorm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # operators; kernels only
            continue
        ms = ev.self_device_time_total / 1e3 / n_prof
        by_class[_kernel_class(ev.key)] += ms
        top.append((ms, ev.count // n_prof, ev.key[:90]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    wall = float(np.median(walls))
    # busy time and wall from the same profiled window; the profiler's own
    # host cost lengthens that wall, so the share leans high
    out = {"bucket": B, "seq": SEQ,
           "forward_wall_ms_median": wall,
           "dispatch_wall_ms_median": float(np.median(dispatch)),
           "new_thread_dispatch_ms": per_thread,
           "kernel_ms_per_forward": by_class,
           "profiled_wall_ms_per_forward": prof_wall,
           "device_idle_share": 1.0 - busy / prof_wall}
    print("breakdown of one bucket-%d forward: host wall %.3f ms, executor "
          "dispatch %.3f ms (medians of 10); a new thread's first three "
          "dispatches %s ms" % (B, wall, out["dispatch_wall_ms_median"],
                                ["%.1f" % t for t in per_thread]), flush=True)
    print("kernel time per forward by class (torch.profiler): %s; %.3f ms "
          "busy in %.3f ms of wall under the profiler: device idle %.1f%%"
          % ({k: round(v, 4) for k, v in by_class.items()}, busy, prof_wall,
             100 * out["device_idle_share"]))
    for ms, n, name in top[:15]:
        print("  %8.4f ms  x%-4d %s" % (ms, n, name))
    check(busy > 0, "the profiler saw no kernel time")
    return out


def _sdpa_mask(vl, T, dev):
    import torch

    return (torch.arange(T, device=dev)[None, :]
            < torch.as_tensor(vl, device=dev)[:, None])[:, None, None, :]


def phase_timing(dev, launches, errs, serve_vl):
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.attention import dense_attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = []

    # LayerNorm at the main path's largest bucket: (8 * 512, 768) bf16
    R, C = BUCKETS[-1] * SEQ, 768
    x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(x.dtype), beta.to(x.dtype)
    ms, plain_ms, lib_ms = time_ms(
        lambda: fused_layernorm(x, gamma, beta, 1e-12),
        lambda: layernorm_plain(x, gamma, beta, 1e-12),
        lambda: TF.layer_norm(x, (C,), gb, bb, 1e-12))
    ln_bytes = 2 * R * C * x.element_size() + 2 * C * 4
    ln_ops = 8 * R * C
    bound = max(ln_bytes / PEAK_BYTES, ln_ops / PEAK_FP32) * 1e3
    records.append({
        "name": "layernorm_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/layernorm.cu",
        "replaces": "mxnet_tpu/ops/pallas/layernorm.py:67",
        "launches": launches["layernorm"], "max_abs_err": errs["layernorm"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if ln_bytes / PEAK_BYTES >= ln_ops / PEAK_FP32
        else "operations",
        "library_ms": lib_ms, "shape": [R, C], "dtype": "bfloat16"})

    # flash forward at the main path's largest bucket, with the valid
    # lengths of the first full batch the server dispatched
    B, H, D = BUCKETS[-1], 12, 64
    vl = np.asarray(serve_vl[:B], np.int64)
    q, k, v = _qkv(dev, g, B, H, SEQ, D)
    vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
    mask = _sdpa_mask(vl, SEQ, dev)
    ms, plain_ms, lib_ms = time_ms(
        lambda: flash_attention(q, k, v, kv_valid_len=vlt),
        lambda: flash_attention_plain(q, k, v, kv_valid_len=vlt),
        lambda: TF.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    # what this data needs: every query row against its example's valid keys
    fl_ops = 4 * H * SEQ * D * int(vl.sum())
    fl_bytes = 2 * (2 * B * H * SEQ * D + 2 * H * D * int(vl.sum())) + 4 * B
    t_ops, t_bytes = fl_ops / PEAK_BF16, fl_bytes / PEAK_BYTES
    records.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas/flash_attention.py:147",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": errs["flash_attention_fwd"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms, "shape": [B, H, SEQ, D], "dtype": "bfloat16",
        "valid_len": vl.tolist()})
    for r in records:
        print("time %-20s kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s)" % (r["name"], r["ms"], r["plain_ms"],
                                      r["library_ms"], r["bound_ms"],
                                      r["bound_by"]), flush=True)

    # dense against flash at seq 128 and 512 (B 8, H 12, D 64, bf16), all
    # keys valid and with the serving valid lengths scaled to the length
    crossover = []
    for T in (128, 512):
        q, k, v = _qkv(dev, g, B, H, T, D)
        for label, lens in (("full", np.full(B, T)),
                            ("serve", np.maximum(1, vl * T // SEQ))):
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            mask = _sdpa_mask(lens, T, dev).to(torch.float32)
            dense, flash = time_ms(
                lambda: dense_attention(q, k, v, mask),
                lambda: flash_attention(q, k, v, kv_valid_len=lt))
            crossover.append({"seq": T, "valid_len": label,
                              "dense_ms": dense, "flash_ms": flash})
            print("attention seq %d (%s lengths): dense %.4f ms, flash %.4f ms"
                  % (T, label, dense, flash), flush=True)
    return records, crossover


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "mxnet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi failed: %s" % smi.stderr.strip()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)
    t_start = time.perf_counter()
    try:
        phase_build()
        checks = {"layernorm": phase_layernorm(dev),
                  "flash_attention_fwd": phase_flash(dev)}
        # each record carries the error of its main-path-shaped case
        errs = {k: v[0]["max_abs_err"] for k, v in checks.items()}
        model, launches, forwards, serve_vl, serving = phase_serve(dev)
        breakdown = phase_breakdown(dev, model)
        records, crossover = phase_timing(dev, launches, errs, serve_vl)
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        return 1
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"checks": checks, "serving": serving,
                      "breakdown": breakdown,
                      "attention_dense_vs_flash": crossover, "card": card}))
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
