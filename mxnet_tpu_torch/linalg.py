"""``mx.linalg`` / ``mx.nd.linalg`` (counterpart of ``mxnet_tpu/linalg.py``;
ref: src/operator/tensor/la_op.cc) over ``torch.linalg``. The kernels are
the ``linalg_*`` registry ops' (``ops/legacy_ops.py``): one implementation,
two surfaces. Each function takes and returns NDArrays and records under
``autograd.record()``."""
from __future__ import annotations

import torch

from . import autograd
from .ndarray import invoke, unwrap, wrap

__all__ = ["gemm2", "gemm", "potrf", "potri", "trsm", "trmm", "syrk", "det",
           "inverse", "slogdet", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "gelqf", "syevd", "cholesky", "qr",
           "svd", "eigh", "norm", "solve"]


def _op(name, *args, **kwargs):
    return invoke(name, args, kwargs)


def gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    return _op("linalg_gemm2", a, b, transpose_a=transpose_a,
               transpose_b=transpose_b, alpha=alpha)


def gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
         beta=1.0):
    return _op("linalg_gemm", a, b, c, transpose_a=transpose_a,
               transpose_b=transpose_b, alpha=alpha, beta=beta)


def potrf(a):
    """The lower Cholesky factor."""
    return _op("linalg_potrf", a)


cholesky = potrf


def potri(a):
    """(L Lᵀ)⁻¹ from the Cholesky factor L."""
    return _op("linalg_potri", a)


def trsm(a, b, transpose=False, rightside=False, alpha=1.0, lower=True):
    return _op("linalg_trsm", a, b, transpose=transpose,
               rightside=rightside, alpha=alpha, lower=lower)


def trmm(a, b, transpose=False, rightside=False, alpha=1.0, lower=True):
    return _op("linalg_trmm", a, b, transpose=transpose,
               rightside=rightside, alpha=alpha, lower=lower)


def syrk(a, transpose=False, alpha=1.0):
    return _op("linalg_syrk", a, transpose=transpose, alpha=alpha)


def det(a):
    return _op("linalg_det", a)


def inverse(a):
    return _op("linalg_inverse", a)


def slogdet(a):
    return _op("linalg_slogdet", a)


def sumlogdiag(a):
    return _op("linalg_sumlogdiag", a)


def extractdiag(a, offset=0):
    return _op("linalg_extractdiag", a, offset=offset)


def makediag(a, offset=0):
    return _op("linalg_makediag", a, offset=offset)


def extracttrian(a, offset=0, lower=True):
    return _op("linalg_extracttrian", a, offset=offset, lower=lower)


def maketrian(a, offset=0, lower=True):
    return _op("linalg_maketrian", a, offset=offset, lower=lower)


def gelqf(a):
    return _op("linalg_gelqf", a)


def syevd(a):
    return _op("linalg_syevd", a)


def _torch(fn, *arrays, **kwargs):
    rec = autograd.is_recording()
    with torch.set_grad_enabled(rec):
        return wrap(fn(*[unwrap(a, rec) for a in arrays], **kwargs))


def qr(a):
    return _torch(lambda t: tuple(torch.linalg.qr(t)), a)


def svd(a):
    return _torch(lambda t: tuple(torch.linalg.svd(t, full_matrices=False)),
                  a)


def eigh(a):
    return _torch(lambda t: tuple(torch.linalg.eigh(t)), a)


def norm(a, ord=None, axis=None):
    return _torch(lambda t: torch.linalg.norm(t, ord=ord, dim=axis), a)


def solve(a, b):
    return _torch(torch.linalg.solve, a, b)
