"""Build and load the port's CUDA kernels.

All sources under ``mxnet_tpu_torch/csrc`` go to one
``torch.utils.cpp_extension.load`` call at first use, for ``sm_90a``
(Hopper), into ``mxnet_tpu_torch/_build/`` (listed in ``.gitignore``). Only
``csrc/binding.cpp`` includes PyTorch's headers; the kernels are plain CUDA
C++ with a C launcher each, so ``nvcc`` stays quick. ninja compiles the
files in parallel. Nothing is built when a module is imported: the first
wrapper that launches a kernel calls :func:`extension`.
"""
from __future__ import annotations

import os
import threading

import torch

from ...base import DeviceError

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SOURCE_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("binding.cpp", "layernorm.cu", "layernorm_bwd.cu",
           "flash_attention_fwd.cu", "flash_attention_fwd_f32.cu",
           "flash_attention_bwd.cu",
           "softmax_xent.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v")

_lock = threading.Lock()
_ext = None


def extension(verbose=False):
    """The loaded kernel module (built on first call). ``verbose`` prints
    the compiler's output, ptxas register and spill counts included."""
    global _ext
    with _lock:
        if _ext is None:
            if not torch.cuda.is_available():
                raise DeviceError("the CUDA kernels need a CUDA device")
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            _ext = load(
                name="mxnet_tpu_torch_kernels",
                sources=[os.path.join(SOURCE_DIR, s) for s in SOURCES],
                build_directory=BUILD_DIR,
                extra_cflags=["-O2"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=verbose)
        return _ext
