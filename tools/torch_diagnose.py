#!/usr/bin/env python
"""Environment diagnosis of the PyTorch port (the twin of
``tools/diagnose.py``; ref: incubator-mxnet tools/diagnose.py).

Prints the platform, Python, the packages the port runs on, the
``MXNET_*``/``TORCH*``/``CUDA*`` environment, ``mx.runtime.Features()``,
``mx.libinfo``'s paths, the card's name and power limit (``nvidia-smi``,
where there is a card) and every section of
``mxnet_tpu_torch.observability.snapshot()``: the graph IR, the compile
store and the tuner first, then the rest. Nothing is built or launched.

Run: python tools/torch_diagnose.py [--json]

``--json`` prints ``observability.snapshot()`` as JSON and exits.
"""
import argparse
import json
import os
import platform
import subprocess
import sys


def _card():
    """The card's name and power limit as nvidia-smi gives them, or why
    there is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "no nvidia-smi (%s)" % e
    if r.returncode != 0:
        return "nvidia-smi failed: %s" % r.stderr.strip()
    return r.stdout.strip()


def _line(name, value):
    print("%-13s: %s" % (name, value))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print observability.snapshot() as JSON and exit")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import observability

    if args.as_json:
        print(json.dumps(observability.snapshot(), indent=1,
                         sort_keys=True, default=str))
        return 0

    print("----------Platform Info----------")
    _line("Platform", platform.platform())
    _line("node", platform.node())
    print("----------Python Info----------")
    _line("Version", platform.python_version())
    _line("Compiler", platform.python_compiler())
    print("----------Environment----------")
    for k in sorted(os.environ):
        if k.startswith(("MXNET", "TORCH", "CUDA", "OMP")):
            print('%s="%s"' % (k, os.environ[k]))
    print("----------Package Info----------")
    import torch
    from importlib import metadata

    _line("torch", "%s (CUDA %s)" % (torch.__version__, torch.version.cuda))
    for name in ("numpy", "triton"):
        try:
            _line(name, metadata.version(name))
        except metadata.PackageNotFoundError:
            _line(name, "not installed")
    _line("mxnet_tpu_torch", mx.libinfo.__version__)
    print("----------Features----------")
    print(mx.runtime.Features())
    print("----------Library Info----------")
    _line("lib paths", mx.libinfo.find_lib_path())
    _line("include", mx.libinfo.find_include_path())
    print("----------Device----------")
    _line("card", _card() if torch.cuda.is_available()
          else "no CUDA device in this process")

    snap = observability.snapshot()
    ir = snap["ir"]
    print("----------Graph IR----------")
    _line("canonical", "%d entries / cap %d, %d programs, %d evictions "
          "(MXNET_IR_CACHE_CAP)" % (
              ir["cache"]["entries"], ir["cache"]["cap"],
              ir["cache"]["programs"], ir["cache"]["evictions"]))
    eng = snap["engine"]
    _line("builds", "bulk=%d tape=%d symbol=%d (the same math from two "
          "captures builds once)" % (eng["bulk_compile"],
                                     eng["tape_compile"],
                                     eng["symbol_compile"]))
    _line("interner", "%d signatures / cap %d" % (
        ir["interner"]["entries"], ir["interner"]["cap"]))
    _line("passes", "  ".join(
        "%s[-%dn/-%de, %d rewrites]" % (n, s["nodes_removed"],
                                        s["edges_removed"], s["rewrites"])
        for n, s in sorted(ir["passes"].items())))
    lb = ir["builds"]["last_build"]
    if lb:
        _line("last build", "%s %d captured -> %d canonical -> %d final "
              "nodes%s" % (lb["key"], lb["nodes_captured"],
                           lb["nodes_canonical"], lb["nodes_final"],
                           " (tuned)" if lb["tuned"] else ""))
    print("----------Compile Store----------")
    cc = snap["comp_cache"]
    if not cc["enabled"]:
        _line("store", "off (set MXNET_COMP_CACHE_DIR to keep Inductor's "
              "artifacts across processes)")
    else:
        _line("store", "%s (cap %d MiB), %d entries, %d KiB" % (
            cc["dir"], cc["cap_bytes"] // (1 << 20), cc["entries"],
            cc["bytes"] // 1024))
        _line("robustness", "writes=%d evictions=%d stale=%d corrupt=%d "
              "wrong_key=%d" % (cc["writes"], cc["evictions"], cc["stale"],
                                cc["corrupt"], cc["wrong_key"]))
    _line("this process", "hits=%d misses=%d loaded=%d aot compiles=%d" % (
        cc["hits"], cc["misses"], cc["deserializes"], cc["aot_compiles"]))
    print("----------Autotuning----------")
    tn = snap["tune"]
    _line("store", "%s, %d entries %s" % (
        tn["store"]["path"] or "in memory (MXNET_TUNE_STORE unset)",
        tn["store"]["entries"], tn["store"]["keys"]))
    _line("searches", "%d (candidates %d, pruned %d, timed %d, parity "
          "rejects %d, installs %d)" % (
              tn["searches"], tn["candidates"], tn["pruned"], tn["timed"],
              tn["parity_rejects"], tn["installs"]))
    _line("lookups", "hits=%d misses=%d stale=%d" % (
        tn["store_hits"], tn["store_misses"], tn["stale_records"]))
    print("----------Other Sections----------")
    for name in sorted(snap):
        if name in ("ir", "comp_cache", "tune"):
            continue
        print("%-13s: %s" % (name, json.dumps(snap[name], sort_keys=True,
                                              default=str)[:600]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
