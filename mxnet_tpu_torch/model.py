"""``mx.model`` (counterpart of ``mxnet_tpu/model.py``; ref:
python/mxnet/model.py): checkpoints as ``prefix-symbol.json`` and
``prefix-%04d.params``, the arrays keyed ``arg:<name>`` and ``aux:<name>``.

The parameters are written dtype-exact through ``util.save_npz_exact`` (a
bf16 parameter stays bf16, with the JAX package's ``__dtype__`` sidecar),
where the JAX ``save_checkpoint`` writes ``asnumpy()``; so a bf16
checkpoint of the port reloads as bf16 in both packages.
"""
from __future__ import annotations

import os

import torch

from . import symbol as sym_mod
from .ndarray import NDArray
from .util import load_npz_exact, save_npz_exact, to_tensor

__all__ = ["save_checkpoint", "load_checkpoint", "BatchEndParam"]


def _tensor(v):
    if isinstance(v, NDArray):
        return v._data.detach()
    if isinstance(v, torch.Tensor):
        return v.detach()
    return to_tensor(v)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """(ref: model.py:save_checkpoint) The symbol's JSON and the
    parameters."""
    if symbol is not None:
        with open("%s-symbol.json" % prefix, "w") as f:
            f.write(symbol.tojson())
    arrs = {"arg:%s" % k: _tensor(v) for k, v in (arg_params or {}).items()}
    arrs.update({"aux:%s" % k: _tensor(v)
                 for k, v in (aux_params or {}).items()})
    save_npz_exact("%s-%04d.params" % (prefix, epoch), arrs)


def load_checkpoint(prefix, epoch, ctx=None):
    """(ref: model.py:load_checkpoint) → (symbol, arg_params, aux_params),
    the arrays on ``ctx`` (default: the CPU, where the file's bytes are)."""
    from .base import resolve_device

    symbol = sym_mod.load("%s-symbol.json" % prefix)
    path = "%s-%04d.params" % (prefix, epoch)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"  # files written before the exact name
    device = resolve_device(ctx) if ctx is not None else None
    arg_params, aux_params = {}, {}
    for k, v in load_npz_exact(path).items():
        kind, name = k.split(":", 1)
        (arg_params if kind == "arg" else aux_params)[name] = NDArray(
            v if device is None else v.to(device))
    return symbol, arg_params, aux_params


class BatchEndParam:
    """A batch-end callback's argument (ref: model.py:BatchEndParam)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals
