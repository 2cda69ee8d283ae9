#!/usr/bin/env python3
"""Warpgroups a CTA, key tile, ring depth and register budget of the
port's flash-attention forward kernel, measured.

    python3 tools/cuda_flash_fwd_tiles.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. For each candidate (warpgroups a CTA, keys a K/V tile, ring
slots, CTAs an SM should hold, which sets the register budget) it writes a
copy of ``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` with that
``FwdShape`` for its head dim, builds all copies at once with ``nvcc``
into shared libraries under ``mxnet_tpu_torch/_build/tiles/`` (ptxas
registers and spills printed), loads each with ctypes, holds its output
and lse against the plain version with ``chip_smoke.FLASH_TOL`` and
``LSE_TOL``, and times it by CUDA-graph replay beside
``scaled_dot_product_attention`` with the bool mask and without one, at
(16, 12, 512, 64) and (16, 6, 512, 128), every key valid, with the lse.
It prints one JSON line of results and the card's name and power limit.
"""
import ctypes
import json
import os
import sys

import cuda_variants as cv

SRC = os.path.join(cv.CSRC, "flash_attention_fwd.cu")
# (head dim, kWarpgroups, kKeys, kStages, kMinBlocks); the shipped setting
# of each head dim is the first of its candidates
CANDIDATES = [
    (64, 2, 128, 3, 2), (64, 2, 128, 2, 2), (64, 2, 64, 3, 2),
    (64, 2, 64, 4, 2), (64, 1, 128, 2, 3),
    (128, 1, 64, 3, 2), (128, 2, 128, 2, 1), (128, 2, 64, 3, 1),
]


def build_all():
    """{cand: (library, ptxas lines)}"""
    text = open(SRC).read()
    tags = {"fwd_d%d_w%d_n%d_s%d_b%d" % cand: cand for cand in CANDIDATES}
    built = cv.build_all({tag: cv.shape_variant(text, cand[0], {
        "kWarpgroups": cand[1], "kKeys": cand[2], "kStages": cand[3],
        "kMinBlocks": cand[4]}) for tag, cand in tags.items()})
    return {tags[tag]: lib for tag, lib in built.items()}


def bind(lib_path):
    fn = ctypes.CDLL(lib_path).mxt_flash_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float, I, P]
    fn.restype = I
    return fn


def main():
    import numpy as np
    import torch
    import torch.nn.functional as TF

    if not torch.cuda.is_available() or not os.path.exists(cv.NVCC):
        print("cuda_flash_fwd_tiles: needs a CUDA card and %s" % cv.NVCC,
              file=sys.stderr)
        return 2
    sys.path.insert(0, cv.REPO)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_all()
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    results = []
    for H, D in ((12, 64), (6, 128)):
        B, T = 16, 512
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        q, k, v = cs._qkv(dev, g, B, H, T, D)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_valid_len=vl,
                                                return_lse=True)
        mag = cs.flash_magnitude(q, k, v, vl)
        mask = cs._sdpa_mask(np.full(B, T), T, dev)
        fns, cands = [], []
        for cand, (lib, ptxas) in built.items():
            if cand[0] != D:
                continue
            fn = bind(lib)

            def run(fn=fn):
                out = torch.empty_like(q)
                lse = torch.empty((B * H, T, 1), dtype=torch.float32,
                                  device=dev)
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         vl.data_ptr(), out.data_ptr(), lse.data_ptr(),
                         B * H, H, T, T, D, 1.0 / D ** 0.5, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError("launch failed: error %d" % err)
                return out, lse

            try:
                out, lse = run()
                torch.cuda.synchronize()
                worst = cs.held(out, ref, cs.FLASH_TOL, str(cand), mag)[
                    "worst_ratio"]
                lse_err = cs.max_err(lse, ref_lse)
                cs.check(lse_err <= cs.LSE_TOL, "lse disagrees (%.3g)"
                         % lse_err)
            except (RuntimeError, cs.SmokeFailure) as e:
                print("%s: not timed: %s" % (cand, e), flush=True)
                continue
            fns.append(run)
            cands.append((cand, ptxas, worst))
        times = cs.time_ms(
            *fns, lambda: TF.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask),
            lambda: TF.scaled_dot_product_attention(q, k, v))
        t_ops, t_bytes = cs._flash_fwd_bound(B, H, T, D,
                                             vl.cpu().numpy(), True)
        for (cand, ptxas, worst), ms in zip(cands, times):
            rec = {"head_dim": D, "warpgroups": cand[1], "keys": cand[2],
                   "stages": cand[3], "min_blocks": cand[4],
                   "shape": [B, H, T, D], "ms": ms, "sdpa_ms": times[-2],
                   "sdpa_unmasked_ms": times[-1],
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "worst_error_ratio": worst, "ptxas": ptxas}
            results.append(rec)
            print("D %d warpgroups %d keys %d stages %d min blocks %d: %.5f "
                  "ms (SDPA %.5f ms, without a mask %.5f ms, bound %.5f ms), "
                  "worst error/limit %.3f; %s" % (
                      *cand, ms, times[-2], times[-1], rec["bound_ms"],
                      worst, " | ".join(ptxas)), flush=True)
        del q, k, v, ref, ref_lse, mag
    print(json.dumps({"tiles": results}))
    print(cv.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
