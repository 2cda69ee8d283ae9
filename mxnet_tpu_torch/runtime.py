"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``; ref:
python/mxnet/runtime.py, src/libinfo.cc).

``mx.runtime.Features()`` reports what this process can use. The names
are the JAX package's (TPU, XLA, PALLAS and ORBAX_CHECKPOINT read False
here: the port has none of them) and upstream MXNet's GPU names, read from
the live torch: CUDA, CUDNN, NCCL, TRITON, NVCC, CUTLASS, CUDA_KERNELS
(the port's kernels are built: the extension lies in ``_build/``), HOPPER
(capability 9.0), FP8 (capability 8.9 or more), CUDA_GRAPHS and
DIST_KVSTORE (``torch.distributed``). A probe never builds anything: the
kernels build at their first launch, and CUDA_KERNELS only looks for the
built file. Each probe catches only the import or lookup error it
expects.
"""
from __future__ import annotations

import importlib.util
import os
import shutil

import torch

__all__ = ["Feature", "Features", "feature_list"]

CUTLASS_INCLUDE = "/usr/local/cutlass/include"


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return "✔ %s" % self.name if self.enabled else "✖ %s" % self.name


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return shutil.which("nvcc") is not None or os.path.exists(
        os.path.join(home, "bin", "nvcc"))


def _capability():
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_capability(torch.cuda.current_device())


def _detect():
    from . import engine
    from .libinfo import built_extension

    cap = _capability()
    cuda = cap is not None
    feats = {
        "TPU": False, "CPU": True, "CUDA": cuda, "MKLDNN": False,
        "XLA": False, "PALLAS": False, "BF16": True, "INT8": True,
        "CUDNN": cuda and torch.backends.cudnn.is_available(),
        "NCCL": cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available(),
        "TRITON": importlib.util.find_spec("triton") is not None,
        "NVCC": _nvcc(),
        "CUTLASS": os.path.isdir(CUTLASS_INCLUDE),
        "CUDA_KERNELS": built_extension() is not None,
        "HOPPER": cap == (9, 0),
        "FP8": cuda and cap >= (8, 9),
        "CUDA_GRAPHS": cuda and hasattr(torch.cuda, "CUDAGraph"),
        "CPP_HOST_ENGINE": os.path.exists(engine.native_lib_path()),
        "ORBAX_CHECKPOINT": False,
        "DIST_KVSTORE": torch.distributed.is_available(),
        "SIGNAL_HANDLER": False,
        "PROFILER": True,
    }
    return feats


def feature_list():
    return [Feature(k, v) for k, v in _detect().items()]


class Features(dict):
    """dict-like: ``Features()['CUDA'].enabled`` /
    ``Features().is_enabled('CUDA')`` (ref: runtime.py:Features)."""

    def __init__(self):
        super().__init__((f.name, f) for f in feature_list())

    def is_enabled(self, name):
        name = name.upper()
        if name not in self:
            raise RuntimeError("unknown feature %r; known: %s"
                               % (name, sorted(self)))
        return self[name].enabled

    def __repr__(self):
        return "[%s]" % ", ".join(repr(f) for f in self.values())
