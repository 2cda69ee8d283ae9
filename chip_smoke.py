#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (into
   ``mxnet_tpu_torch/_build/``) and prints the build time;
2. holds the LayerNorm kernel against its plain PyTorch version (the
   bert512 step's (8192, 768) and (1280, 768) bf16 first);
3. holds the flash-attention forward kernel against its plain version
   (the bert512 step's (16, 12, 512, 64) with the logsumexp first; valid
   lengths with 0, causal, ragged T = 200, head dim 128);
4. holds the softmax cross-entropy forward and backward kernels against
   their plain versions ((1280, 30522) bf16, (16, 2), (37, 1000) fp32, a
   label in the last column);
5. holds the flash-attention backward kernel (dq, dk and dv from one
   kernel and its dq pass) against its plain version (every key valid at
   (16, 12, 512, 64), valid lengths with 0, causal, ragged T = 200, head
   dim 128, 30 key tiles adding into each dq row at T = 2048), checks that
   dk and dv rows past the valid length are exactly zero, and runs the
   bert512 case twice to read how far dq moves between runs (its partial
   sums land in no fixed order);
6. serves BERT-base (full width, bf16, random weights from a seed) through
   ``ModelServer(buckets=(1, 4, 8))`` at seq 512: 16 requests with valid
   lengths spread over 1..512; every served row must match a direct forward
   of the same model on the card, which must match the same forward with
   the plain versions in place of the kernels (a forward in which no
   kernel may launch); the LayerNorm and flash
   counters must rise by 25 and 12 per forward, and no training kernel may
   launch; it serves two bursts and prints each one's p50/p99 latency and
   req/s;
7. trains BERT-base at the ``bert512`` recipe of ``bench.py`` (batch 16,
   seq 512, 80 masked positions, bf16 with fp32 masters, Adam lr 1e-4 wd
   0.01, dropout 0.1, MLM + NSP loss) through ``autograd.record``,
   ``autograd.backward`` and ``gluon.Trainer.step``: the loss stays finite
   and the weights move; the kernel counters rise by exactly 26 LayerNorm,
   12 flash forward, 12 flash backward, 2 softmax-xent forward and 2
   backward launches a step; one step's loss and every gradient agree with
   the same step run with the plain versions (no kernel may launch in it),
   and the same plain step with planted faults (LayerNorm gamma 1 % high,
   dk/dv missing a query tile) must fail the gradient limit; it times the
   step (samples/s);
8. times the ``bert`` headline step (batch 64, seq 128, 20 masked), whose
   attention takes the dense path and its hand-written backward;
9. times each kernel (CUDA-graph replay) at the bert512 step's shapes
   against its plain version, its PyTorch library yardstick and its bound
   (the two forward kernels also at a served bucket-8 forward's shapes;
   the flash backward also at head dim 128), dense against flash attention
   at seq 128 and 512, and dense against flash forward plus backward at
   seq 64, 128, 256 and 512;
10. breaks one serving forward at the largest bucket down (host wall, the
    executor's whole dispatch, a new thread's first dispatches, kernel time
    by class from torch.profiler, hence the device's idle share), then one
    bert512 step (kernel time by class, the LayerNorm backward and the
    optimizer step, the idle share), and times the step once more. The
    profiler windows come last: after one, an eager step's host wall may
    not return to what it was.

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
# softmax-xent loss and lse: fp32 row statistics, a reordered sum and the
# card's expf against torch's exp, a few fp32 steps at |loss| ~ 10. dx is
# rounded once to the logits' dtype from fp32 values a few fp32 steps
# apart: one bf16 step (< 2**-7 relative) at most
XENT_TOL = (1e-5, 1e-5, 0.0)
XENT_DX_TOL = {"bfloat16": (1e-12, 2.0 ** -7, 0.0),
               "float32": (1e-12, 1e-5, 0.0)}
# flash dq, dk, dv: each output is rounded once to bf16 (one step, < 2**-7
# of |plain|); both sides round each term p or ds to bf16 from fp32 values
# a few fp32 steps apart, which moves the sum by at most 2**-8 of the sum of
# the terms' sizes, mag: scale |ds| |k| (dq), scale |ds|^T |q| (dk) and
# p^T |dO| (dv), from the plain version
FLASH_BWD_TOL = (1e-5, 2.0 ** -7, 2.0 ** -8)
# the training step with the kernels against the same step with the plain
# versions: the loss (about 11 at random weights) and each parameter's
# gradient in relative L2 norm, after bf16 through 12 layers both ways
# (honest readings 0.012-0.014, on the position embedding; the run checks
# that planted faults read above it, PLANTED_FAULTS)
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 2e-2
VOCAB = 30522
# bench.py's two BERT-base pretraining modes: bert512 (the main path,
# BERT phase 2) and bert (the headline)
BERT512 = {"batch": 16, "seq": 512, "masked": 80}
BERT128 = {"batch": 64, "seq": 128, "masked": 20}
TRAIN_STEPS = 3
TIMED_STEPS = 6
# kernel launches a training step (26 LayerNorms: embeddings, 2 x 12
# layers, the MLM head; 12 attention layers; MLM and NSP losses)
STEP_LAUNCHES = {"layernorm": 26, "flash_attention_fwd": 12,
                 "flash_attention_bwd": 12, "softmax_xent_fwd": 2,
                 "softmax_xent_bwd": 2}


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


def kernel_counters():
    """{name: the wrapper whose ``launches`` counts that kernel}."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    return {"layernorm": ln.fused_layernorm,
            "flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "softmax_xent_fwd": sx.softmax_xent_fwd,
            "softmax_xent_bwd": sx.softmax_xent_bwd}


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


class plain_versions:
    """Within the block, every kernel wrapper's module attribute is its
    plain version, so the model runs without the kernels. ``faults`` names
    a wrapper to replace with another function instead (a planted fault)."""

    def __init__(self, **faults):
        self.faults = faults

    def __enter__(self):
        from mxnet_tpu_torch.ops import attention
        from mxnet_tpu_torch.ops.cuda import flash_attention as fa
        from mxnet_tpu_torch.ops.cuda import layernorm as ln
        from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

        def flash_plain(q, k, v, **kw):
            return fa.flash_attention_plain(q, k, v, **kw)

        self._saved = []
        for mod, name, plain in (
                (ln, "fused_layernorm", ln.layernorm_plain),
                (attention, "flash_attention", flash_plain),
                (fa, "flash_attention", flash_plain),
                (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain),
                (sx, "softmax_xent_fwd", sx.softmax_xent_fwd_plain),
                (sx, "softmax_xent_bwd", sx.softmax_xent_bwd_plain)):
            self._saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self.faults.get(name, plain))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


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
    # the bert512 step's two shapes first (16 * 512 rows; the MLM head's
    # 16 * 80), then a served bucket-8 forward's, then fp32
    for (R, C), dtype, eps, tol in (((8192, 768), torch.bfloat16, 1e-12,
                                     BF16_TOL),
                                    ((1280, 768), torch.bfloat16, 1e-12,
                                     BF16_TOL),
                                    ((4096, 768), torch.bfloat16, 1e-12,
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
        # name, (B, H, T, D), causal, valid lengths, lse; the bert512
        # step's call first
        ("bert512 all valid", (16, 12, 512, 64), False, np.full(16, 512),
         True),
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


def phase_xent(dev):
    """The softmax-xent forward and backward kernels against their plain
    versions; the first case is the main path's MLM head."""
    import torch
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    readings = []
    for (R, V), dtype in (((1280, VOCAB), torch.bfloat16),
                          ((16, 2), torch.bfloat16),
                          ((37, 1000), torch.float32)):
        x = (torch.randn(R, V, device=dev, generator=g) * 3).to(dtype)
        labels = torch.randint(0, V, (R,), device=dev, generator=g,
                               dtype=torch.int32)
        labels[0] = V - 1  # a label in the last column
        dy = torch.randn(R, device=dev, generator=g)
        what = "softmax-xent (%d, %d) %s" % (R, V, str(dtype)[6:])
        loss, lse = sx.softmax_xent_fwd(x, labels)
        torch.cuda.synchronize()
        ref_loss, ref_lse = sx.softmax_xent_fwd_plain(x, labels)
        fwd = held(loss, ref_loss, XENT_TOL, what + " loss")
        held(lse, ref_lse, XENT_TOL, what + " lse")
        dx = sx.softmax_xent_bwd(x, labels, ref_lse, dy)
        torch.cuda.synchronize()
        ref_dx = sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy)
        check(dx.dtype == dtype and dx.shape == x.shape,
              "%s: dx shape/dtype" % what)
        bwd = held(dx, ref_dx, XENT_DX_TOL[str(dtype)[6:]], what + " dx")
        readings.append({"fwd": fwd, "bwd": bwd})
    return readings


def flash_bwd_magnitudes(q, k, v, do, lse, delta, vl=None, causal=False):
    """The sizes of the sums whose terms the dq, dk and dv kernels round:
    scale |ds| |k|, scale |ds|^T |q| and p^T |dO|, from the plain version."""
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_p_ds_plain

    scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = flash_p_ds_plain(q, k, v, do, lse, delta, vl, scale, causal)
    ds = ds.abs()
    mdq = torch.matmul(ds, k.float().abs()) * scale
    mdk = torch.matmul(ds.transpose(-1, -2), q.float().abs()) * scale
    mdv = torch.matmul(p.transpose(-1, -2), do.float().abs())
    return mdq, mdk, mdv


def flash_bwd_inputs(dev, g, B, H, T, D, vl=None, causal=False):
    """q, k, v, dO (bf16), and the lse and delta the backward takes, from
    the plain forward."""
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

    q, k, v, do = [torch.randn(B, H, T, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4)]
    o, lse = flash_attention_plain(q, k, v, kv_valid_len=vl, causal=causal,
                                   return_lse=True)
    delta = (o.float() * do.float()).sum(dim=-1)
    return q, k, v, do, lse, delta


def phase_flash_bwd(dev):
    """The flash backward kernel against its plain version; the first case
    is the main path's shape with every key valid. Rows of dk and dv past an
    example's valid length must be exactly zero, and dq of a vl = 0 example
    too. The bert512 case runs again on the same inputs: dq's partial sums
    land in no fixed order, and the two runs must agree within the same
    limit."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    readings = []
    cases = [
        # name, (B, H, T, D), causal, valid lengths
        ("bert512 all valid", (16, 12, 512, 64), False, None),
        ("vl", (8, 12, 512, 64), False, [512, 0, 256, 1, 37, 300, 511, 64]),
        ("causal", (2, 12, 512, 64), True, None),
        ("causal vl", (2, 12, 512, 64), True, [300, 512]),
        ("ragged T=200", (3, 4, 200, 64), False, [200, 0, 77]),
        ("D=128", (2, 8, 256, 128), False, [256, 100]),
        ("D=128 causal ragged", (2, 4, 200, 128), True, [200, 150]),
        # 30 key tiles of 64 add into each dq row
        ("T=2048 vl", (1, 4, 2048, 64), False, [1900]),
    ]
    for name, (B, H, T, D), causal, vl in cases:
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        q, k, v, do, lse, delta = flash_bwd_inputs(dev, g, B, H, T, D, vlt,
                                                   causal)
        args = (q, k, v, do, lse, delta)
        kw = {"kv_valid_len": vlt, "causal": causal}
        dq, dk, dv = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(*args, **kw)
        mdq, mdk, mdv = flash_bwd_magnitudes(*args, vl=vlt, causal=causal)
        what = "flash bwd %s %s causal=%s vl=%s" % (name, (B, H, T, D),
                                                    causal, vl)
        for t, ref in ((dq, q), (dk, k), (dv, v)):
            check(t.shape == ref.shape and t.dtype == torch.bfloat16,
                  "%s: shape/dtype" % what)
        reading = {"dq": held(dq, ref_dq, FLASH_BWD_TOL, what + " dq", mdq),
                   "dk": held(dk, ref_dk, FLASH_BWD_TOL, what + " dk", mdk),
                   "dv": held(dv, ref_dv, FLASH_BWD_TOL, what + " dv", mdv)}
        for b, n in enumerate(vl or []):
            check(not (bool(dk[b, :, n:].any()) or bool(dv[b, :, n:].any())),
                  "%s: dk/dv rows past vl=%d not exactly zero" % (what, n))
            if n == 0:
                check(not bool(dq[b].any()), "%s: vl=0 dq not zero" % what)
        if not readings:
            # the same inputs again: only the order of dq's sums differs
            dq2, dk2, dv2 = fa.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  "%s: dk/dv differ between two runs" % what)
            rerun = held(dq2, dq, FLASH_BWD_TOL, what + " dq run 2 vs run 1",
                         mdq)
            reading["dq_rerun"] = rerun
            print("%s: max |dq run 2 - dq run 1| %.3g; %d of %d elements "
                  "differ" % (what, rerun["max_abs_err"],
                              int((dq2 != dq).sum()), dq.numel()), flush=True)
        readings.append(reading)
    print("flash bwd: dk and dv rows past every valid length are exactly 0",
          flush=True)
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
        reset_counters()
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
        counts = read_counters()
        launches = {k: counts[k] for k in ("layernorm", "flash_attention_fwd")}
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
    check(not any(counts[k] for k in counts if k not in launches),
          "serving launched a training kernel: %s" % counts)

    # reference 1: a direct forward of the same model on the card
    ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]
    with torch.inference_mode():
        direct = [o.float().cpu().numpy() for o in model(*ins)]
    # reference 2: the same forward with the plain versions in place of the
    # kernels (patched into the op modules for this call only)
    reset_counters()
    with plain_versions(), torch.inference_mode():
        plain = [o.float().cpu().numpy() for o in model(*ins)]
    check(not any(read_counters().values()),
          "the plain-version forward launched a kernel: %s" % read_counters())

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


def make_batch(rng, batch, seq, masked):
    """bench.py's ``make_batch`` in numpy: random tokens, token type 0,
    every position valid, random masked positions and labels."""
    return (rng.integers(0, VOCAB, (batch, seq)).astype(np.int32),
            np.zeros((batch, seq), np.int32),
            np.full((batch,), seq, np.float32),
            rng.integers(0, seq, (batch, masked)).astype(np.int32),
            rng.integers(0, VOCAB, (batch, masked)).astype(np.int32),
            rng.integers(0, 2, (batch,)).astype(np.int32))


class TrainStep:
    """BERT-base pretraining through the port's entry points, as a user
    writes it: ``bert_base`` in bf16 via amp, ``gluon.Trainer`` with Adam
    (lr 1e-4, wd 0.01, fp32 masters), MLM and NSP
    ``SoftmaxCrossEntropyLoss``, ``autograd.record`` / ``backward``."""

    def __init__(self, dev, recipe):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.models.bert import bert_base

        self.recipe = recipe
        self.model = bert_base(dropout=0.1, max_length=recipe["seq"])
        self.model.initialize(
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        amp.convert_hybrid_block(self.model, "bfloat16")
        self.params = list(self.model.collect_params().values())
        self.trainer = gluon.Trainer(
            self.model.collect_params(), "adam",
            {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True})
        self.mlm_loss = gluon.loss.SoftmaxCrossEntropyLoss()
        self.nsp_loss = gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.default_rng(SEED)
        self.batch = [torch.from_numpy(a).to(dev) for a in make_batch(
            rng, recipe["batch"], recipe["seq"], recipe["masked"])]

    def __call__(self, update=True):
        """One step; returns the per-sample loss (the head the backward
        starts from)."""
        from mxnet_tpu_torch import autograd

        tok, tt, vl, mp, mlm_y, nsp_y = self.batch
        with autograd.record():
            _, _, nsp, mlm = self.model(tok, tt, vl, mp)
            loss = self.mlm_loss(mlm, mlm_y) + self.nsp_loss(nsp, nsp_y)
        autograd.backward(loss)
        if update:
            self.trainer.step(self.recipe["batch"])
        return loss.detach()

    def timed(self, steps):
        """Median host wall (ms) of ``steps`` steps, each ending in a host
        readback of the loss; the losses."""
        walls, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(self().mean()))
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls)), losses


def _grads(params):
    return [p.grad().detach().clone() for p in params]


def grad_rel_l2(params, grads, ref_grads):
    """[(|g - ref| / |ref| in L2, name)] of each parameter, worst first."""
    rel = []
    for p, g, ref in zip(params, grads, ref_grads):
        num = float((g.float() - ref.float()).norm())
        den = float(ref.float().norm())
        rel.append((num / den if den > 0 else num, p.name))
    return sorted(rel, reverse=True)


def dq_last_tile_dropped(q, k, v, do, lse, delta, kv_valid_len=None,
                         scale=None, causal=False):
    """A planted fault: the plain backward with each example's last 64
    valid keys (one key tile of the dq sum at vl 512) left out of dq."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    vl = kv_valid_len if kv_valid_len is not None else torch.full(
        (q.shape[0],), k.shape[2], dtype=torch.int32, device=q.device)
    dq = fa.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                     (vl - 64).clamp(min=0), scale, causal)
    dk, dv = fa.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                          kv_valid_len, scale, causal)
    return dq, dk, dv


def dkv_last_query_tile_dropped(q, k, v, do, lse, delta, kv_valid_len=None,
                                scale=None, causal=False):
    """A planted fault: the plain backward with the last 64 query rows left
    out of the dk and dv sums."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    B, H, T, _ = q.shape
    n = T - 64
    dq = fa.flash_attention_dq_plain(q, k, v, do, lse, delta, kv_valid_len,
                                     scale, causal)
    dk, dv = fa.flash_attention_dkv_plain(
        q[:, :, :n], k, v, do[:, :, :n],
        lse.reshape(B * H, T, 1)[:, :n].contiguous(),
        delta.reshape(B, H, T)[:, :, :n], kv_valid_len, scale, causal)
    return dq, dk, dv


def layernorm_gamma_high(x, gamma, beta, eps):
    """A planted fault: the plain LayerNorm with gamma 1 % high."""
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    return ln.layernorm_plain(x, gamma * 1.01, beta, eps)


def xent_dx_high(x, labels, lse, dy):
    """A planted fault: the plain softmax-xent backward 1 % high."""
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    return sx.softmax_xent_bwd_plain(x, labels, lse, dy * 1.01)


# faults planted into the plain-version step: (the wrappers each one
# replaces, whether the step's gradient limit must catch it). A dq missing
# one K/V tile moves the gradients about as far as bf16 rounding does, and
# a 1 % scale of the loss gradient moves each by 1 %; only the kernel
# checks at the step's shapes catch those two
PLANTED_FAULTS = {
    "LayerNorm gamma 1% high": (
        {"fused_layernorm": layernorm_gamma_high}, True),
    "dk/dv drop the last query tile": (
        {"flash_attention_bwd": dkv_last_query_tile_dropped}, True),
    "dq drops the last K/V tile": (
        {"flash_attention_bwd": dq_last_tile_dropped}, False),
    "softmax-xent dx 1% high": ({"softmax_xent_bwd": xent_dx_high}, False),
    "none (the plain step again)": ({}, False),
}


def phase_train(dev):
    """The bert512 step: a few steps with finite losses that move the
    weights, exact launch counts a step, one step against the same step
    with the plain versions, and the step's wall and samples/s."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    t0 = time.perf_counter()
    step = TrainStep(dev, BERT512)
    n_params = sum(p.data().numel() for p in step.params)
    watch = [step.model.word_embed.weight, step.model.encoder.ln.gamma,
             step.model.encoder.cells[0].attention.qkv.weight]
    before = [p.data().detach().clone() for p in watch]
    torch.cuda.synchronize()
    print("bert512 step: %d parameters, batch %d, seq %d, %d masked; set-up "
          "%.2f s" % (n_params, BERT512["batch"], BERT512["seq"],
                      BERT512["masked"], time.perf_counter() - t0), flush=True)

    # (a), (b): the main path, with every counter at 0 just before it
    reset_counters()
    losses = [float(step().mean()) for _ in range(TRAIN_STEPS)]
    launches = read_counters()
    print("bert512 losses %s; kernel launches in %d steps: %s"
          % (["%.4f" % x for x in losses], TRAIN_STEPS, launches), flush=True)
    check(all(np.isfinite(losses)), "non-finite training loss")
    for p, b in zip(watch, before):
        check(not torch.equal(p.data(), b), "a weight did not move")
    for name, n in STEP_LAUNCHES.items():
        check(launches[name] == n * TRAIN_STEPS,
              "%s launches %d != %d x %d steps" % (name, launches[name], n,
                                                   TRAIN_STEPS))

    # (c): one step with the kernels and the same step with the plain
    # versions, from the same weights and the same dropout generator
    mx_random.seed(SEED)
    loss_k = step(update=False).float()
    grads_k = _grads(step.params)
    for p, gk in zip(step.params, grads_k):
        check(bool(torch.isfinite(gk).all()), "%s: non-finite grad" % p.name)
    mx_random.seed(SEED)
    reset_counters()
    with plain_versions():
        loss_p = step(update=False).float()
    check(not any(read_counters().values()),
          "the plain-version step launched a kernel: %s" % read_counters())
    grads_p = _grads(step.params)
    loss_err = float((loss_k.mean() - loss_p.mean()).abs())
    rel = grad_rel_l2(step.params, grads_k, grads_p)
    print("bert512 step with kernels vs plain versions: loss %.6f vs %.6f "
          "(|diff| %.3g, limit %g); worst gradient relative L2 %s (limit %g)"
          % (float(loss_k.mean()), float(loss_p.mean()), loss_err,
             STEP_LOSS_TOL, ["%.3g %s" % r for r in rel[:5]], STEP_GRAD_TOL),
          flush=True)
    check(loss_err <= STEP_LOSS_TOL, "step loss disagrees with plain versions")
    check(rel[0][0] <= STEP_GRAD_TOL, "gradient disagrees with plain "
          "versions: %s" % (rel[0],))
    # the same limit against planted faults: the plain step once more with
    # one wrapper replaced by a faulty version
    del grads_k
    faults = {}
    for name, (override, must_catch) in PLANTED_FAULTS.items():
        mx_random.seed(SEED)
        with plain_versions(**override):
            loss_f = step(update=False).float()
        faults[name] = {
            "loss_err": float((loss_f.mean() - loss_p.mean()).abs()),
            "worst_grad_rel_l2": [[r, n] for r, n in grad_rel_l2(
                step.params, _grads(step.params), grads_p)[:3]]}
        print("bert512 step, planted fault %r vs plain versions: loss |diff| "
              "%.3g, worst gradient relative L2 %s" % (
                  name, faults[name]["loss_err"],
                  ["%.3g %s" % tuple(r)
                   for r in faults[name]["worst_grad_rel_l2"]]), flush=True)
        check(not must_catch
              or faults[name]["worst_grad_rel_l2"][0][0] > STEP_GRAD_TOL,
              "the step's gradient limit misses the planted fault %r" % name)
    del grads_p

    # (d): the step's wall after warm-up
    step.timed(1)
    wall, timed_losses = step.timed(TIMED_STEPS)
    check(all(np.isfinite(timed_losses)), "non-finite training loss")
    result = {"recipe": BERT512, "losses": losses + timed_losses,
              "launches": launches, "steps_counted": TRAIN_STEPS,
              "loss_vs_plain": [float(loss_k.mean()), float(loss_p.mean())],
              "worst_grad_rel_l2": [[r, n] for r, n in rel[:5]],
              "planted_faults": faults,
              "step_wall_ms_median": wall,
              "samples_per_s": BERT512["batch"] / wall * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("bert512 step: median wall %.3f ms over %d steps, %.2f samples/s; "
          "peak memory %.2f GB" % (wall, TIMED_STEPS, result["samples_per_s"],
                                   result["peak_memory_gb"]), flush=True)
    return step, result


def _train_kernel_class(name):
    for key, cls in (("flash_fwd_kernel", "flash_attention_fwd"),
                     # the backward kernel and its dq pass
                     ("flash_bwd_", "flash_attention_bwd"),
                     ("xent_fwd_kernel", "softmax_xent_fwd"),
                     ("xent_bwd_kernel", "softmax_xent_bwd"),
                     ("layernorm_fwd_kernel", "layernorm_fwd"),
                     ("multi_tensor_apply", "adam (foreach)")):
        if key in name:
            return cls
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def phase_train_breakdown(step, n_prof=2):
    """Where a bert512 step spends its time, from one torch.profiler
    window: kernel time by class, the LayerNorm backward and the optimizer
    step (their profiler ranges), and the device idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_prof
    by_class, ranges, top = {}, {}, []
    dq_pass = 0.0
    for ev in prof.key_averages():
        if ev.key.startswith("mxnet_tpu_torch::"):
            # a profiler range: its kernels' device time; its span on the
            # device timeline (a CUDA-side event of the same name, gaps
            # included) is not kernel time
            if ev.device_type != DeviceType.CUDA:
                ranges[ev.key] = ev.device_time_total / 1e3 / n_prof
        elif ev.device_type == DeviceType.CUDA:
            ms = ev.self_device_time_total / 1e3 / n_prof
            cls = _train_kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            if "flash_bwd_dq_kernel" in ev.key:
                dq_pass += ms
            top.append((ms, ev.count // n_prof, ev.key[:90]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    out = {"kernel_ms_per_step": by_class,
           "range_device_ms_per_step": ranges,
           "profiled_wall_ms_per_step": wall,
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall,
           "flash_bwd_dq_pass_ms_per_step": dq_pass,
           "flash_bwd_dq_pass_share": dq_pass / max(
               by_class.get("flash_attention_bwd", 0.0), 1e-12)}
    print("flash backward a step: %.4f ms, of which the dq pass %.4f ms "
          "(%.1f%%)" % (by_class.get("flash_attention_bwd", 0.0), dq_pass,
                        100 * out["flash_bwd_dq_pass_share"]), flush=True)
    print("bert512 step breakdown (torch.profiler, %d steps): kernel ms a "
          "step by class %s; device ms of the ranges %s; %.3f ms busy in "
          "%.3f ms of wall under the profiler: device idle %.1f%%"
          % (n_prof, {k: round(v, 4) for k, v in sorted(by_class.items())},
             {k: round(v, 4) for k, v in ranges.items()}, busy, wall,
             100 * out["device_idle_share"]), flush=True)
    for ms, n, name in top[:20]:
        print("  %8.4f ms  x%-4d %s" % (ms, n, name))
    check(busy > 0, "the profiler saw no kernel time")
    return out


def phase_bert128(dev):
    """The bert headline step (batch 64, seq 128, 20 masked): dense
    attention with its hand-written backward, the softmax-xent kernels;
    samples/s and launches a step."""
    import torch

    step = TrainStep(dev, BERT128)
    step.timed(2)
    reset_counters()
    wall, losses = step.timed(TIMED_STEPS)
    launches = read_counters()
    check(all(np.isfinite(losses)), "non-finite bert128 loss")
    want = dict(STEP_LAUNCHES, flash_attention_fwd=0, flash_attention_bwd=0)
    for name, n in want.items():
        check(launches[name] == n * TIMED_STEPS,
              "bert128 %s launches %d != %d x %d steps"
              % (name, launches[name], n, TIMED_STEPS))
    out = {"recipe": BERT128, "losses": losses, "launches": launches,
           "steps_counted": TIMED_STEPS, "step_wall_ms_median": wall,
           "samples_per_s": BERT128["batch"] / wall * 1e3}
    print("bert128 step: median wall %.3f ms over %d steps, %.2f samples/s; "
          "launches %s" % (wall, TIMED_STEPS, out["samples_per_s"], launches),
          flush=True)
    del step
    torch.cuda.empty_cache()
    return out


def _sdpa_mask(vl, T, dev):
    import torch

    return (torch.arange(T, device=dev)[None, :]
            < torch.as_tensor(vl, device=dev)[:, None])[:, None, None, :]


def kernel_record(name, source, replaces, launches, steps, err, ms, plain_ms,
                  lib_ms, t_ops, t_bytes, **extra):
    """One entry of the ``kernels`` line: ``launches`` is the count of the
    bert512 step's run of ``steps`` steps; the bound is the larger of the
    operations' and the bytes' least time (seconds)."""
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "launches_per_step": launches / steps, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms}
    rec.update(extra)
    return rec


def _ln_bound(R, C, esize):
    """(operations, bytes) least times of a LayerNorm of (R, C): x read and
    y written once, fp32 gamma and beta; about 8 fp32 operations an
    element."""
    return 8 * R * C / PEAK_FP32, (2 * R * C * esize + 2 * C * 4) / PEAK_BYTES


def _flash_fwd_bound(B, H, T, D, vl, lse):
    """(operations, bytes) least times of the flash forward in bf16: every
    query row against its example's valid keys (two products), q and o
    whole, the valid rows of k and v, and the lse when it is written."""
    n_keys = int(np.sum(vl))
    ops = 4 * H * T * D * n_keys
    nbytes = 2 * (2 * B * H * T * D + 2 * H * D * n_keys) + 4 * B
    if lse:
        nbytes += 4 * B * H * T
    return ops / PEAK_BF16, nbytes / PEAK_BYTES


def _flash_bwd_bound(B, H, T, D, vl):
    """(operations, bytes) least times of the flash backward in bf16: the
    five products over every query row and its example's valid keys
    (10 * pairs), q, k, v, dO and dq, dk, dv once each, lse and delta."""
    pairs = H * T * D * int(np.sum(vl))
    nbytes = 7 * B * H * T * D * 2 + 2 * B * H * T * 4 + 4 * B
    return 10 * pairs / PEAK_BF16, nbytes / PEAK_BYTES


def phase_timing(dev, launches, steps, errs, serve_launches, forwards,
                 serve_vl):
    """Records of the two forward kernels at the bert512 step's shapes, with
    the same numbers at a served bucket-8 forward's shapes beside them
    (``serving``), and dense against flash attention."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.attention import dense_attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = []

    # LayerNorm: the step's (16 * 512, 768) and a served bucket-8 forward's
    # (8 * 512, 768), bf16 with fp32 gamma and beta
    C = 768
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    shapes = [(BERT512["batch"] * BERT512["seq"], C), (BUCKETS[-1] * SEQ, C)]
    fns = []
    for R, _ in shapes:
        x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
        fns += [lambda x=x: fused_layernorm(x, gamma, beta, 1e-12),
                lambda x=x: layernorm_plain(x, gamma, beta, 1e-12),
                lambda x=x: TF.layer_norm(x, (C,), gb, bb, 1e-12)]
    t = time_ms(*fns)
    serving = dict(zip(("ms", "plain_ms", "library_ms"), t[3:]),
                   shape=list(shapes[1]),
                   bound_ms=max(_ln_bound(*shapes[1], 2)) * 1e3,
                   launches=serve_launches["layernorm"],
                   launches_per_forward=serve_launches["layernorm"] / forwards)
    records.append(kernel_record(
        "layernorm_fwd", "mxnet_tpu_torch/csrc/layernorm.cu",
        "mxnet_tpu/ops/pallas/layernorm.py:67", launches["layernorm"], steps,
        errs["layernorm"], *t[:3], *_ln_bound(*shapes[0], 2),
        shape=list(shapes[0]), dtype="bfloat16", serving=serving))

    # flash forward: the step's (16, 12, 512, 64), every key valid, with the
    # lse; a served bucket-8 forward's, with the valid lengths of the first
    # full batch the server dispatched and no lse
    H, D = 12, 64
    step_shape = (BERT512["batch"], H, BERT512["seq"], D)
    step_vl = np.full(step_shape[0], step_shape[2])
    B = BUCKETS[-1]
    vl = np.asarray(serve_vl[:B], np.int64)
    fns = []
    for shape, lens, lse in ((step_shape, step_vl, True),
                             ((B, H, SEQ, D), vl, False)):
        q, k, v = _qkv(dev, g, *shape)
        vlt = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = _sdpa_mask(lens, shape[2], dev)
        fns += [lambda q=q, k=k, v=v, vlt=vlt, lse=lse: flash_attention(
                    q, k, v, kv_valid_len=vlt, return_lse=lse),
                lambda q=q, k=k, v=v, vlt=vlt, lse=lse: flash_attention_plain(
                    q, k, v, kv_valid_len=vlt, return_lse=lse),
                lambda q=q, k=k, v=v, mask=mask:
                    TF.scaled_dot_product_attention(q, k, v, attn_mask=mask)]
    t = time_ms(*fns)
    serving = dict(zip(("ms", "plain_ms", "library_ms"), t[3:]),
                   shape=[B, H, SEQ, D], valid_len=vl.tolist(),
                   bound_ms=max(_flash_fwd_bound(B, H, SEQ, D, vl, False))
                   * 1e3,
                   launches=serve_launches["flash_attention_fwd"],
                   launches_per_forward=serve_launches["flash_attention_fwd"]
                   / forwards)
    records.append(kernel_record(
        "flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:147",
        launches["flash_attention_fwd"], steps, errs["flash_attention_fwd"],
        *t[:3], *_flash_fwd_bound(*step_shape, step_vl, True),
        shape=list(step_shape), dtype="bfloat16", return_lse=True,
        library="scaled_dot_product_attention with the bool mask",
        serving=serving))
    for r in records:
        print("time %-20s kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s) at %s; serving %s: %.4f / %.4f / %.4f ms"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"], r["shape"],
                 r["serving"]["shape"], r["serving"]["ms"],
                 r["serving"]["plain_ms"], r["serving"]["library_ms"]),
              flush=True)

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


def phase_train_timing(dev, launches, errs, steps):
    """Records of the three training kernels at the bert512 step's shapes:
    CUDA-graph replay of the kernel, its plain version and a PyTorch
    library call computing the same function, and the bound. A library
    backward is timed as forward + backward less the forward alone."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    records = []

    def record(name, source, replaces, *times, **extra):
        records.append(kernel_record(name, source, replaces, launches[name],
                                     steps, errs[name], *times, **extra))

    # softmax-xent at the MLM head: (16 * 80, 30522) bf16 logits
    R, V = BERT512["batch"] * BERT512["masked"], VOCAB
    x = (torch.randn(R, V, device=dev, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    dy = torch.full((R,), 1.0 / BERT512["batch"], device=dev)
    _, lse = sx.softmax_xent_fwd_plain(x, labels)
    xf = x.float().requires_grad_()
    lab64 = labels.long()

    def lib_fwd():
        return TF.cross_entropy(xf, lab64, reduction="none")

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), xf, dy)

    ms, plain_ms, lib_ms, lib_both = time_ms(
        lambda: sx.softmax_xent_fwd(x, labels),
        lambda: sx.softmax_xent_fwd_plain(x, labels),
        lib_fwd, lib_fwd_bwd)
    ops = 5 * R * V  # max, subtract, exp, add, label compare, fp32
    xbytes = R * V * x.element_size()
    record("softmax_xent_fwd", "mxnet_tpu_torch/csrc/softmax_xent.cu",
           "mxnet_tpu/ops/pallas/softmax_xent.py:75", ms, plain_ms, lib_ms,
           ops / PEAK_FP32, (xbytes + 3 * R * 4) / PEAK_BYTES,
           shape=[R, V], dtype="bfloat16",
           library="F.cross_entropy(reduction='none') on fp32 logits")
    ms, plain_ms = time_ms(
        lambda: sx.softmax_xent_bwd(x, labels, lse, dy),
        lambda: sx.softmax_xent_bwd_plain(x, labels, lse, dy))
    record("softmax_xent_bwd", "mxnet_tpu_torch/csrc/softmax_xent.cu",
           "mxnet_tpu/ops/pallas/softmax_xent.py:94", ms, plain_ms,
           lib_both - lib_ms, ops / PEAK_FP32,
           (2 * xbytes + 3 * R * 4) / PEAK_BYTES, shape=[R, V],
           dtype="bfloat16",
           library="backward of F.cross_entropy on fp32 logits (forward + "
           "backward less forward)")
    del x, xf, lse

    # the flash backward at (16, 12, 512, 64), every key valid, and the
    # same at head dim 128 (16, 6, 512, 128)
    lib = "backward of scaled_dot_product_attention with the bool mask " \
        "(forward + backward less forward)"
    at_d128 = None
    for H, D in ((12, 64), (6, 128)):
        B, T = BERT512["batch"], BERT512["seq"]
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        q, k, v, do, lse, delta = flash_bwd_inputs(dev, g, B, H, T, D, vl)
        args = (q, k, v, do, lse, delta)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask = _sdpa_mask(np.full(B, T), T, dev)

        def sdpa():
            return TF.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qs, ks, vs), do)

        ms, plain_ms, lib_fwd_ms, lib_both = time_ms(
            lambda: fa.flash_attention_bwd(*args, kv_valid_len=vl),
            lambda: fa.flash_attention_bwd_plain(*args, kv_valid_len=vl),
            sdpa, sdpa_fwd_bwd)
        t_ops, t_bytes = _flash_bwd_bound(B, H, T, D, vl.cpu().numpy())
        if D == 64:
            record("flash_attention_bwd",
                   "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                   "mxnet_tpu/ops/pallas/flash_attention.py:288 and :311",
                   ms, plain_ms, lib_both - lib_fwd_ms, t_ops, t_bytes,
                   shape=[B, H, T, D], dtype="bfloat16", library=lib)
        else:
            at_d128 = {"shape": [B, H, T, D], "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_both - lib_fwd_ms,
                       "bound_ms": max(t_ops, t_bytes) * 1e3}
        del q, k, v, do, lse, delta, args, qs, ks, vs
    records[-1]["head_dim_128"] = at_d128
    print("time flash_attention_bwd at %s: kernel %.4f ms, plain %.4f ms, "
          "library %.4f ms, bound %.4f ms" % (
              at_d128["shape"], at_d128["ms"], at_d128["plain_ms"],
              at_d128["library_ms"], at_d128["bound_ms"]), flush=True)
    for r in records:
        print("time %-20s kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s), %g launches a step"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"], r["launches_per_step"]),
              flush=True)
    return records


def phase_train_crossover(dev):
    """Dense against flash attention, forward plus backward, at seq 64, 128,
    256 and 512 with 8192 tokens (the bert and bert512 steps' batches at 128
    and 512), every key valid, (H 12, D 64, bf16): the training side of the
    seam's length gate."""
    import torch
    from mxnet_tpu_torch.ops.attention import dense_attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_with_grad)

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    H, D = 12, 64
    out = []
    for T in (64, 128, 256, 512):
        B = 8192 // T
        q, k, v, do = [torch.randn(B, H, T, D, device=dev, generator=g)
                       .to(torch.bfloat16) for _ in range(4)]
        leaves = [t.requires_grad_() for t in (q, k, v)]
        mask = _sdpa_mask(np.full(B, T), T, dev).to(torch.float32)
        lt = torch.full((B,), T, dtype=torch.int32, device=dev)

        def dense():
            return torch.autograd.grad(dense_attention(*leaves, mask), leaves,
                                       do)

        def flash():
            return torch.autograd.grad(
                flash_attention_with_grad(*leaves, kv_valid_len=lt), leaves,
                do)

        dense_ms, flash_ms = time_ms(dense, flash)
        out.append({"seq": T, "batch": B, "dense_ms": dense_ms,
                    "flash_ms": flash_ms})
        print("attention forward + backward, seq %d batch %d: dense %.4f ms, "
              "flash %.4f ms" % (T, B, dense_ms, flash_ms), flush=True)
    return out


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
                  "flash_attention_fwd": phase_flash(dev),
                  "softmax_xent": phase_xent(dev),
                  "flash_attention_bwd": phase_flash_bwd(dev)}
        # each record carries the error of its case at the bert512 step's
        # shape, the first of each phase
        errs = {k: checks[k][0]["max_abs_err"]
                for k in ("layernorm", "flash_attention_fwd")}
        xent0 = checks["softmax_xent"][0]
        bwd0 = checks["flash_attention_bwd"][0]
        errs.update({"softmax_xent_fwd": xent0["fwd"]["max_abs_err"],
                     "softmax_xent_bwd": xent0["bwd"]["max_abs_err"],
                     "flash_attention_bwd": max(
                         bwd0[n]["max_abs_err"] for n in ("dq", "dk", "dv"))})
        model, serve_launches, forwards, serve_vl, serving = phase_serve(dev)
        step, train = phase_train(dev)
        bert128 = phase_bert128(dev)
        records, crossover = phase_timing(
            dev, train["launches"], train["steps_counted"], errs,
            serve_launches, forwards, serve_vl)
        records += phase_train_timing(dev, train["launches"], errs,
                                      train["steps_counted"])
        train_crossover = phase_train_crossover(dev)
        # the profiler windows come last: once a profiler session has run,
        # an eager step's host wall may not return to what it was before
        breakdown = phase_breakdown(dev, model)
        train["breakdown"] = phase_train_breakdown(step)
        for r in records:
            if r["name"] == "flash_attention_bwd":
                r["dq_pass_share"] = train["breakdown"][
                    "flash_bwd_dq_pass_share"]
        wall, _ = step.timed(TIMED_STEPS)
        train["step_wall_ms_median_after_profiler"] = wall
        print("bert512 step after the profiler sessions: median wall %.3f ms"
              % wall, flush=True)
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        return 1
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"checks": checks, "serving": serving,
                      "breakdown": breakdown, "train_bert512": train,
                      "train_bert128": bert128,
                      "attention_dense_vs_flash": crossover,
                      "attention_fwd_bwd_dense_vs_flash": train_crossover,
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
