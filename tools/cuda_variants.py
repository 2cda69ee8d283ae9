"""Build variants of one of the port's CUDA sources with nvcc, all at once.

The tile tools (``cuda_flash_fwd_tiles.py``, ``cuda_flash_bwd_tiles.py``)
write a copy of a kernel source per candidate setting of its shape struct,
compile each copy with ``nvcc`` into a shared library under
``mxnet_tpu_torch/_build/tiles/`` (one ``nvcc`` a copy, all started
together) and load it with ctypes through its plain C launcher.
"""
import os
import re
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mxnet_tpu_torch", "csrc")
OUT = os.path.join(REPO, "mxnet_tpu_torch", "_build", "tiles")
NVCC = "/usr/local/cuda/bin/nvcc"
FIELD = r"(static constexpr int %s = D == 64 \? )(\d+) : (\d+);"


def shape_variant(text, D, fields):
    """``text`` with each ``static constexpr int <name> = D == 64 ? a : b;``
    of ``fields`` ({name: value}) set to ``value`` for head dim ``D``."""
    for name, value in fields.items():
        def sub(m):
            a, b = (value, m.group(3)) if D == 64 else (m.group(2), value)
            return "%s%s : %s;" % (m.group(1), a, b)

        text, n = re.subn(FIELD % name, sub, text)
        if n != 1:
            raise RuntimeError("shape field %s not found" % name)
    return text


def build_all(sources):
    """{tag: source text} -> {tag: (library path, ptxas lines)}, one nvcc a
    source, all at once; a failed build is printed and left out."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        cu = os.path.join(OUT, tag + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, tag + ".so")
        cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
               "-I", CSRC, "-o", lib, cu]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    built = {}
    for tag, (lib, p) in procs.items():
        log = p.communicate(timeout=600)[0]
        if p.returncode != 0:
            print("build failed for %s:\n%s" % (tag, log[-3000:]))
            continue
        # ptxas names each kernel, then gives its spills and registers
        built[tag] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling" in ln or "Performance" in ln])
    return built


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()
