#!/usr/bin/env python3
"""Ring depth and register budget of the port's flash-attention backward
kernel, measured.

    python3 tools/cuda_flash_bwd_tiles.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. For each candidate (ring slots, CTAs an SM should hold, which
sets the register budget) it writes a copy of
``mxnet_tpu_torch/csrc/flash_attention_bwd.cu`` with that ``BwdShape`` for
its head dim, builds all copies at once with ``nvcc`` into shared libraries
under ``mxnet_tpu_torch/_build/tiles/`` (ptxas registers and spills printed),
loads each with ctypes, holds its dq, dk and dv against the plain version
with ``chip_smoke.FLASH_BWD_TOL``, and times it by CUDA-graph replay beside
the backward of ``scaled_dot_product_attention`` at (16, 12, 512, 64) and
(16, 6, 512, 128), every key valid. It prints one JSON line of results and
the card's name and power limit.
"""
import ctypes
import json
import os
import sys

import cuda_variants as cv

SRC = os.path.join(cv.CSRC, "flash_attention_bwd.cu")
# (head dim, kStages, kMinBlocks); the shipped setting of each head dim is
# the first of its candidates
CANDIDATES = [
    (64, 3, 3), (64, 2, 3), (64, 2, 2), (64, 4, 2),
    (128, 2, 2), (128, 2, 1), (128, 3, 1),
]


def build_all():
    """{cand: (library, ptxas lines)}"""
    text = open(SRC).read()
    tags = {"d%d_s%d_b%d" % cand: cand for cand in CANDIDATES}
    built = cv.build_all({tag: cv.shape_variant(
        text, cand[0], {"kStages": cand[1], "kMinBlocks": cand[2]})
        for tag, cand in tags.items()})
    return {tags[tag]: lib for tag, lib in built.items()}


def bind(lib_path):
    lib = ctypes.CDLL(lib_path)
    fn = lib.mxt_flash_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 11 + [I] * 5 + [ctypes.c_float, I, P]
    fn.restype = I
    return fn


def workspace(lib_path, batch_heads, tq, d):
    fn = ctypes.CDLL(lib_path).mxt_flash_bwd_workspace
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int64
    return fn(batch_heads, tq, d)


def main():
    import numpy as np
    import torch
    import torch.nn.functional as TF

    if not torch.cuda.is_available() or not os.path.exists(cv.NVCC):
        print("cuda_flash_bwd_tiles: needs a CUDA card and %s" % cv.NVCC,
              file=sys.stderr)
        return 2
    sys.path.insert(0, cv.REPO)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_all()
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    results = []
    for H, D in ((12, 64), (6, 128)):
        B, T = 16, 512
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        q, k, v, do, lse, delta = cs.flash_bwd_inputs(dev, g, B, H, T, D, vl)
        ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, vl)
        mags = cs.flash_bwd_magnitudes(q, k, v, do, lse, delta, vl=vl)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask = cs._sdpa_mask(np.full(B, T), T, dev)

        def sdpa():
            return TF.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qs, ks, vs), do)

        fns, cands = [], []
        for cand, (lib, ptxas) in built.items():
            if cand[0] != D:
                continue
            fn = bind(lib)

            def run(fn=fn, floats=workspace(lib, B * H, T, D)):
                dq_acc = torch.zeros(floats, dtype=torch.float32, device=dev)
                out = [torch.empty_like(q) for _ in range(3)]
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         vl.data_ptr(), dq_acc.data_ptr(), out[0].data_ptr(),
                         out[1].data_ptr(), out[2].data_ptr(), B * H, H, T, T,
                         D, 1.0 / D ** 0.5, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError("launch failed: error %d" % err)
                return out

            try:
                got = run()
                torch.cuda.synchronize()
                worst = [cs.held(a, b, cs.FLASH_BWD_TOL, "%s %s" % (cand, n),
                                 m)["worst_ratio"] for a, b, m, n in
                         zip(got, ref, mags, ("dq", "dk", "dv"))]
            except (RuntimeError, cs.SmokeFailure) as e:
                print("%s: not timed: %s" % (cand, e), flush=True)
                continue
            fns.append(run)
            cands.append((cand, ptxas, max(worst)))
        times = cs.time_ms(*fns, sdpa, sdpa_fwd_bwd)
        lib_ms = times[-1] - times[-2]
        t_ops, t_bytes = cs._flash_bwd_bound(B, H, T, D, vl.cpu().numpy())
        for (cand, ptxas, worst), ms in zip(cands, times):
            rec = {"head_dim": D, "stages": cand[1], "min_blocks": cand[2],
                   "shape": [B, H, T, D], "ms": ms, "sdpa_bwd_ms": lib_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "worst_error_ratio": worst, "ptxas": ptxas}
            results.append(rec)
            print("D %d stages %d min blocks %d: %.4f ms (SDPA backward %.4f "
                  "ms, bound %.4f ms), worst error/limit %.3f; %s" % (
                      D, cand[1], cand[2], ms, lib_ms, rec["bound_ms"], worst,
                      " | ".join(ptxas)), flush=True)
        del q, k, v, do, lse, delta, ref, mags, qs, ks, vs
    print(json.dumps({"tiles": results}))
    print(cv.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
