#!/usr/bin/env python3
"""The flash forward's fp32 form at the quantized paths' shapes, beside an
earlier version of it, its plain version and SDPA, in one process.

    python3 tools/cuda_flash_f32_bench.py [--parent-src OLD.cu]
        [--variant kWarps=8] [--no-sweep]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit. It builds ``mxnet_tpu_torch/csrc/flash_attention_fwd_f32.cu``
(and ``--parent-src``, an earlier ``flash_attention_fwd_f32.cu`` with the
C launcher of its commit: the first form took no workspace and no split)
with ``nvcc`` into shared libraries under ``mxnet_tpu_torch/_build/tiles/``
(ptxas registers and spills printed), loads each with ctypes, and at each
shape of ``shapes()`` (the int8 BERT forward at buckets 8 and 1 with the
served rows' valid lengths, the int8 GPT prefills' causal shapes at 256,
512 and 1024):

* holds every build against ``flash_attention_plain`` under
  ``chip_smoke.FLASH_F32_TOL`` (with ``torch.backends.cuda.matmul.
  allow_tf32`` off, so the plain version is full fp32);
* times the builds by CUDA-graph replay, each with the split that
  ``flash_f32_splits`` chooses for it, taking turns (parent, new,
  variants, variants, new, parent), beside the plain version and
  ``scaled_dot_product_attention`` in fp32, with the bound of
  ``chip_smoke._flash_fwd_f32_bound`` (3xTF32 on the tensor cores);
* unless ``--no-sweep``, times every distinct split count s of each split
  build (chunk = ceil(most key tiles / s)), each held to the plain
  version first.

``--variant`` (may repeat) adds a build of the shipped source with some of
its ``constexpr int`` constants set otherwise, for example ``kWarps=4``
(64 query rows a CTA) or ``kNG=8``. It prints one JSON line of results and the card's
name and power limit.
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

H, D = 12, 64
SEQ = 512


def shapes():
    """(name, (B, H, T, D), causal, valid lengths or None)."""
    vl = cs._bert_requests()[2]
    return [("bert int8 bucket 8, served vl", (8, H, SEQ, D), False,
             [int(n) for n in vl[5:13]]),
            ("bert int8 bucket 1, served vl", (1, H, SEQ, D), False,
             [int(vl[0])]),
            ("gpt int8 prefill causal", (1, H, 256, D), True, None),
            ("gpt int8 prefill causal", (1, H, 512, D), True, None),
            ("gpt int8 prefill causal", (1, H, 1024, D), True, None)]


def variant(text, spec):
    """``text`` with each ``constexpr int NAME = n;`` of ``spec``
    ("NAME=VALUE,...") set to VALUE; a shape field ``static constexpr int
    NAME = D == 64 ? a : b;`` is set at head dim 64."""
    for item in spec.split(","):
        name, value = item.split("=")
        text, n = re.subn(r"constexpr int %s = \d+;" % name,
                          "constexpr int %s = %s;" % (name, value), text)
        if n != 1:
            text = cv.shape_variant(text, 64, {name: value})
    return text


class Build:
    """One built source through its C launcher: the split form (with
    ``mxt_flash_fwd_f32_tile``) or the first form, on the CUDA cores (no
    workspace, no split)."""

    def __init__(self, lib):
        dll = ctypes.CDLL(lib)
        P, I = ctypes.c_void_p, ctypes.c_int
        self.fn = dll.mxt_flash_fwd_f32
        self.split = hasattr(dll, "mxt_flash_fwd_f32_tile")
        if self.split:
            self.fn.argtypes = [P] * 7 + [I] * 5 + [ctypes.c_float, I, I, I,
                                                    P]
            tile_fn = dll.mxt_flash_fwd_f32_tile
            tile_fn.argtypes = [I] + [ctypes.POINTER(I)] * 3
            out = [I() for _ in range(3)]
            if tile_fn(D, *[ctypes.byref(x) for x in out]):
                raise RuntimeError("mxt_flash_fwd_f32_tile failed")
            self.tile = tuple(x.value for x in out)
        else:
            self.fn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float, I, P]
            self.tile = None
        self.fn.restype = I

    def call(self, q, k, v, vl, o, work, causal, splits, chunk):
        import torch

        def ptr(t):
            return ctypes.c_void_p(None if t is None else t.data_ptr())

        B, Hh, T, Dd = q.shape
        args = [ptr(q), ptr(k), ptr(v), ptr(vl), ptr(o), ptr(None)]
        if self.split:
            args.append(ptr(work))
        args += [B * Hh, Hh, T, T, Dd, 1.0 / Dd ** 0.5, int(causal)]
        if self.split:
            args += [splits, chunk]
        args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        err = self.fn(*args)
        if err:
            raise RuntimeError("launch failed: %d" % err)


def main():
    import torch
    import torch.nn.functional as TF

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-src", help="an earlier "
                    "flash_attention_fwd_f32.cu to time beside this one")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available() or not os.path.exists(cv.NVCC):
        print("needs a CUDA card and %s" % cv.NVCC, file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = open(os.path.join(cv.CSRC, "flash_attention_fwd_f32.cu")).read()
    srcs = {"new": src}
    if args.parent_src:
        srcs = {"parent": open(args.parent_src).read(), "new": src}
    srcs.update({v: variant(src, v) for v in args.variant})
    tags = {"f32_%d" % i: name for i, name in enumerate(srcs)}
    built = cv.build_all({t: srcs[n] for t, n in tags.items()})
    for tag, (_, lines) in built.items():
        print("%s %s:\n  %s" % (tags[tag], tag, "\n  ".join(lines)),
              flush=True)
    if len(built) != len(tags):
        return 1
    builds = {tags[t]: Build(built[t][0]) for t in tags}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
    order = list(builds) + list(builds)[::-1]
    out = {"card": cv.card(), "sms": sms,
           "tiles": {n: b.tile for n, b in builds.items()}, "shapes": []}
    print("tiles (query rows, keys, CTAs an SM): %s" % out["tiles"],
          flush=True)
    for name, (B, Hh, T, Dd), causal, vl in shapes():
        q, k, v = cs._qkv(dev, g, B, Hh, T, Dd, torch.float32)
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        ref = fa.flash_attention_plain(q, k, v, kv_valid_len=vlt,
                                       causal=causal)
        mag = cs.flash_magnitude(q, k, v, vlt, causal)
        what = "%s %s" % (name, (B, Hh, T, Dd))

        def configs(b):
            """[(splits, chunk)]: the wrapper's choice first, then the
            sweep's."""
            if not b.split:
                return [(1, 1)]
            first = fa.flash_f32_splits(B * Hh, T, T, causal, sms, Dd,
                                        tile=b.tile)
            most = max(fa.f32_key_tiles(T, T, causal, b.tile))
            seen = [first]
            if not args.no_sweep:
                for s in range(1, min(most, fa.F32_MAX_SPLITS) + 1):
                    chunk = -(-most // s)
                    cfg = (-(-most // chunk), chunk)
                    if cfg not in seen:
                        seen.append(cfg)
            return seen

        cfgs = {n: configs(b) for n, b in builds.items()}
        work = torch.empty(max(s for c in cfgs.values() for s, _ in c)
                           * B * Hh * T * (Dd + 2), device=dev)
        outs = {n: torch.empty_like(q) for n in builds}
        checks, calls = {}, {}
        for n, b in builds.items():
            for s, chunk in cfgs[n]:
                def call(b=b, o=outs[n], s=s, chunk=chunk):
                    b.call(q, k, v, vlt, o, work, causal, s, chunk)
                call()
                torch.cuda.synchronize()
                r = cs.held(outs[n], ref, cs.FLASH_F32_TOL, "%s %s splits %d "
                            "chunk %d" % (n, what, s, chunk), mag)
                checks["%s s%d c%d" % (n, s, chunk)] = r["worst_ratio"]
                calls[(n, s, chunk)] = call
        if causal:
            def sdpa():
                return TF.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)
        else:
            mask = cs._sdpa_mask(vl, T, dev)

            def sdpa():
                return TF.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask)
        times = cs.time_ms(
            *[calls[(n,) + cfgs[n][0]] for n in order],
            lambda: fa.flash_attention_plain(q, k, v, kv_valid_len=vlt,
                                             causal=causal), sdpa)
        t_ops, t_bytes = cs._flash_fwd_f32_bound(B, Hh, T, Dd, vl, causal)
        row = {"case": name, "shape": [B, Hh, T, Dd], "causal": causal,
               "valid_len": vl, "plain_ms": times[-2], "sdpa_ms": times[-1],
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "worst_ratio": checks}
        for n in builds:
            row[n] = {"splits_chunk": list(cfgs[n][0]), "ms": [
                t for t, o in zip(times, order) if o == n]}
        for n, cs_ in cfgs.items():
            if len(cs_) > 1:
                swept = cs.time_ms(*[calls[(n,) + c] for c in cs_])
                row[n]["sweep"] = [{"splits": s, "chunk": c, "ms": t}
                                   for (s, c), t in zip(cs_, swept)]
        out["shapes"].append(row)
        print("%s: %s" % (what, {k_: v_ for k_, v_ in row.items()
                                 if k_ != "worst_ratio"}), flush=True)
    print(json.dumps(out))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
