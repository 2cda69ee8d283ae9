#!/usr/bin/env python3
"""The port's LayerNorm kernels over row counts, beside their library calls
and, where given, earlier versions of them, in one process.

    python3 tools/cuda_layernorm_bench.py [--parent-src OLD_layernorm.cu]
        [--parent-bwd-src OLD_layernorm_bwd.cu]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It builds ``mxnet_tpu_torch/csrc/layernorm.cu`` and
``layernorm_bwd.cu`` (and the ``--parent-src`` and ``--parent-bwd-src``
files, a ``layernorm.cu`` and a ``layernorm_bwd.cu`` of an earlier commit
with the same C launchers, each with the ``layernorm_common.cuh`` beside
it) with ``nvcc`` into shared libraries under
``mxnet_tpu_torch/_build/tiles/`` (ptxas registers and spills printed),
loads each with ctypes, and then:

* forward, bf16 at C = 768 over 8 to 8192 rows (a decode step's 8, GPT
  prefill buckets, the CTA form's edge at 1023/1024, the MLM head's 1280,
  serving's 4096, the bert512 step's 8192): each build's output against
  ``layernorm_plain`` (``chip_smoke.BF16_TOL``), then its time by
  CUDA-graph replay beside ``F.layer_norm`` with bf16 gamma and beta, and
  the bytes bound;
* backward, bf16 at C = 768 over 8192, 1280, 512 and 8 rows: dx, dgamma
  and dbeta against ``layernorm_bwd_plain`` (the ``chip_smoke`` limits),
  then its time (both of its kernels, buffers allocated beforehand) beside
  the plain version and ``aten.native_layer_norm_backward`` with bf16
  gamma.

``--fwd-variant`` and ``--bwd-variant`` (each may repeat) add builds of
the shipped source with some of its ``constexpr int`` constants (those of
``layernorm_common.cuh`` included) set otherwise, for example
``--bwd-variant kBwdWarps=4,kWaves=4`` or ``--fwd-variant kFewRows=2048``.
The builds take turns within each timing, in order and then in reverse
(parent, new, variants, variants, new, parent). Then each backward shape
runs 10 times under torch.profiler, for the device time of each of its
two kernels. It prints one JSON line of results and the card's name and
power limit.
"""
import argparse
import ctypes
import json
import os
import re
import sys

import cuda_variants as cv

sys.path.insert(0, cv.REPO)
import chip_smoke as cs  # noqa: E402

FWD_ROWS = (8, 32, 128, 256, 512, 1023, 1024, 1280, 4096, 8192)
BWD_ROWS = (8192, 1280, 512, 8)
C = 768


def source(path):
    """The source at ``path`` with the ``layernorm_common.cuh`` of its own
    directory inlined, so an earlier commit's file builds with its own
    header."""
    text = open(path).read()
    header = os.path.join(os.path.dirname(path), "layernorm_common.cuh")
    if os.path.exists(header):
        text = text.replace('#include "layernorm_common.cuh"',
                            open(header).read())
    return text


def variant(text, spec):
    """``text`` (its header inlined) with each ``constexpr int NAME = n;``
    of ``spec`` ("NAME=VALUE,...") set to VALUE."""
    for item in spec.split(","):
        name, value = item.split("=")
        text, n = re.subn(r"constexpr int %s = \d+;" % name,
                          "constexpr int %s = %s;" % (name, value), text)
        if n != 1:
            raise RuntimeError("constant %s not found" % name)
    return text


def kernel_ms(fn, n=10):
    """{kernel name: device ms a call} over ``n`` calls under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:80]: ev.self_device_time_total / 1e3 / n
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def bind_fwd(lib):
    fn = ctypes.CDLL(lib).mxt_layernorm_fwd
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, P]
    fn.restype = ctypes.c_int
    return fn


def bind_bwd(lib):
    dll = ctypes.CDLL(lib)
    P = ctypes.c_void_p
    fn = dll.mxt_layernorm_bwd
    fn.argtypes = [P] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    parts = dll.mxt_layernorm_bwd_parts
    parts.argtypes = [ctypes.c_int64, ctypes.c_int]
    parts.restype = ctypes.c_int64
    return fn, parts


def main():
    import torch
    import torch.nn.functional as TF

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-src", help="an earlier layernorm.cu to time "
                    "beside the forward")
    ap.add_argument("--parent-bwd-src", help="an earlier layernorm_bwd.cu "
                    "to time beside the backward")
    ap.add_argument("--fwd-variant", action="append", default=[])
    ap.add_argument("--bwd-variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available() or not os.path.exists(cv.NVCC):
        print("needs a CUDA card and %s" % cv.NVCC, file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    fwd_src = source(os.path.join(cv.CSRC, "layernorm.cu"))
    bwd_src = source(os.path.join(cv.CSRC, "layernorm_bwd.cu"))
    # {name: source}: the forward builds, then the backward builds
    fwd_srcs = {"new": fwd_src}
    if args.parent_src:
        fwd_srcs = {"parent": source(args.parent_src), "new": fwd_src}
    fwd_srcs.update({v: variant(fwd_src, v) for v in args.fwd_variant})
    bwd_srcs = {"new": bwd_src}
    if args.parent_bwd_src:
        bwd_srcs = {"parent": source(args.parent_bwd_src), "new": bwd_src}
    bwd_srcs.update({v: variant(bwd_src, v) for v in args.bwd_variant})
    tags = {}
    for kind, srcs in (("fwd", fwd_srcs), ("bwd", bwd_srcs)):
        for i, (name, text) in enumerate(srcs.items()):
            tags["ln_%s_%d" % (kind, i)] = (kind, name, text)
    built = cv.build_all({t: text for t, (_, _, text) in tags.items()})
    for tag, (_, lines) in built.items():
        print("%s %s:\n  %s" % (tags[tag][:2], tag, "\n  ".join(lines)),
              flush=True)
    if len(built) != len(tags):
        return 1
    fwds = {name: bind_fwd(built[t][0])
            for t, (kind, name, _) in tags.items() if kind == "fwd"}
    bwds = {name: bind_bwd(built[t][0])
            for t, (kind, name, _) in tags.items() if kind == "bwd"}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    order = list(fwds) + list(fwds)[::-1]

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    out = {"card": cv.card(), "forward": [], "backward": []}
    for R in FWD_ROWS:
        x, gamma, beta = cs._ln_inputs(dev, g, R, C, torch.bfloat16)
        gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        ys = {k: torch.empty_like(x) for k in fwds}
        calls = {}
        for k, fn in fwds.items():
            def call(fn=fn, y=ys[k]):
                err = fn(ptr(x), ptr(gamma), ptr(beta), ptr(y), R, C, 1e-5, 1,
                         stream())
                if err:
                    raise RuntimeError("launch failed: %d" % err)
            calls[k] = call
            call()
        torch.cuda.synchronize()
        ref = ln.layernorm_plain(x, gamma, beta, 1e-5)
        for k in fwds:
            cs.held(ys[k], ref, cs.BF16_TOL, "%s layernorm (%d, %d)" % (k, R, C))
        times = cs.time_ms(*[calls[k] for k in order],
                           lambda: TF.layer_norm(x, (C,), gb, bb, 1e-5))
        row = {"rows": R, "library_ms": times[-1],
               "bound_ms": max(cs._ln_bound(R, C, 2)) * 1e3}
        for k in fwds:
            row[k + "_ms"] = [t for t, o in zip(times, order) if o == k]
        out["forward"].append(row)
        print("forward (%d, %d): %s" % (R, C, row), flush=True)
    border = list(bwds) + list(bwds)[::-1]
    for R in BWD_ROWS:
        x, gamma, _ = cs._ln_inputs(dev, g, R, C, torch.bfloat16)
        dy = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
        ref = ln.layernorm_bwd_plain(x, gamma, dy, 1e-12)
        mags = cs.layernorm_bwd_magnitudes(x, gamma, dy, 1e-12)
        calls, parts = {}, {}
        for name, (bwd, bwd_parts) in bwds.items():
            parts[name] = n_parts = bwd_parts(R, sms)
            part = torch.empty((n_parts, 2, C), device=dev)
            dx = torch.empty_like(x)
            dg, db = (torch.empty(C, device=dev) for _ in range(2))

            def call(bwd=bwd, n_parts=n_parts, part=part, dx=dx, dg=dg, db=db):
                err = bwd(ptr(x), ptr(gamma), ptr(dy), ptr(dx), ptr(part),
                          ptr(dg), ptr(db), R, C, n_parts, 1e-12, 1, stream())
                if err:
                    raise RuntimeError("launch failed: %d" % err)

            calls[name] = call
            call()
            torch.cuda.synchronize()
            for got, want, tol, mag, n in (
                    (dx, ref[0], cs.LN_BWD_DX_TOL["bfloat16"], mags[0], "dx"),
                    (dg, ref[1], cs.LN_BWD_PARAM_TOL, mags[1], "dgamma"),
                    (db, ref[2], cs.LN_BWD_PARAM_TOL, mags[2], "dbeta")):
                cs.held(got, want, tol, "%s layernorm bwd (%d, %d) %s"
                        % (name, R, C, n), mag)
        gb = gamma.to(torch.bfloat16)
        bb = torch.zeros_like(gb)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], gb, bb, 1e-12)
        times = cs.time_ms(
            *[calls[k] for k in border],
            lambda: ln.layernorm_bwd_plain(x, gamma, dy, 1e-12),
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [C], mean, rstd, gb, bb, [True, True, True]))
        row = {"rows": R, "plain_ms": times[-2], "library_ms": times[-1],
               "bound_ms": max(cs._ln_bwd_bound(R, C, 2)) * 1e3}
        for k in bwds:
            row[k] = {"parts": parts[k], "ms": [
                t for t, o in zip(times, border) if o == k],
                "kernel_ms": kernel_ms(calls[k])}
        out["backward"].append(row)
        print("backward (%d, %d): %s" % (R, C, row), flush=True)
    print(json.dumps(out))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
