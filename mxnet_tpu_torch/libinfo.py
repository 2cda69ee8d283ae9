"""``mx.libinfo`` (counterpart of ``mxnet_tpu/libinfo.py``; ref:
python/mxnet/libinfo.py).

Upstream locates libmxnet.so and declares ``__version__``. The port's
native pieces are the CUDA kernels' extension (built at the first launch
into ``mxnet_tpu_torch/_build/``) and the prebuilt host libraries in
``src/engine_cc``: :func:`find_lib_path` lists those that exist and never
builds anything; :func:`find_include_path` is the kernels' sources.
"""
from __future__ import annotations

import glob
import os

__version__ = "1.9.0.cuda"  # MXNet 1.9's API, on PyTorch and CUDA

__all__ = ["find_lib_path", "find_include_path", "built_extension"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def built_extension():
    """The built kernel extension's path in ``_build/``, or None."""
    hits = sorted(glob.glob(os.path.join(_PKG, "_build",
                                         "mxnet_tpu_torch_kernels*.so")))
    return hits[0] if hits else None


def find_lib_path():
    """The native libraries present (ref: libinfo.py:find_lib_path): the
    built kernel extension, the host engine and the image library."""
    from .engine import native_lib_path

    so = native_lib_path()
    paths = [built_extension(), so,
             os.path.join(os.path.dirname(so), "libmxtpu_im.so")]
    return [p for p in paths if p is not None and os.path.exists(p)]


def find_include_path():
    """(ref: libinfo.py:find_include_path) The kernels' CUDA sources."""
    return os.path.join(_PKG, "csrc")
