#!/usr/bin/env python3
"""Host time of one LayerNorm kernel call through its Python wrapper on
one card, to compare two checkouts (a wrapper that calls the kernel
directly against one that goes through a ``torch.library`` op).

    python3 tools/cuda_dispatch_overhead.py [ROOT]

ROOT (default: this checkout) is the checkout whose ``mxnet_tpu_torch`` is
imported; its kernels are built there. At (8, 768) bf16 a call's kernel
takes a few microseconds, so a loop of calls is bound by the host: each
reading is the wall of CALLS calls over CALLS, with one synchronize at the
end, the median of ROUNDS rounds. Readings: ``wrapper_us``
(``fused_layernorm``), ``differentiable_us`` (``layernorm`` under
``no_grad``), ``extension_us`` (the built extension's entry called as the
wrapper's implementation calls it: the floor). Prints one JSON line.
"""
import json
import os
import subprocess
import sys
import time

ROWS, UNITS = 8, 768
CALLS, ROUNDS = 2000, 5


def _per_call_us(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / CALLS * 1e6)
    return sorted(walls)[ROUNDS // 2]


def main(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(ROWS, UNITS, device=dev, generator=g).to(torch.bfloat16)
    gamma = torch.randn(UNITS, device=dev, generator=g)
    beta = torch.randn(UNITS, device=dev, generator=g)
    ext = _build.extension()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def raw():
        ext.layernorm_fwd(x, gamma, beta, y, 1e-5, stream)

    with torch.no_grad():
        out = {"root": root, "wrapper_us": _per_call_us(
                   lambda: ln.fused_layernorm(x, gamma, beta)),
               "differentiable_us": _per_call_us(
                   lambda: ln.layernorm(x, gamma, beta)),
               "extension_us": _per_call_us(raw)}
    try:
        out["commit"] = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["commit"] = None
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    out["shape"], out["calls"], out["rounds"] = [ROWS, UNITS], CALLS, ROUNDS
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
