"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; the JAX package's
``mxnet_tpu/gluon/trainer.py``), on one device.

Every dense parameter goes through one multi-tensor optimizer step a call
(``Optimizer.fused_update``), which updates the weights in place; a
parameter without a gradient raises ``RuntimeError`` naming it, or is
skipped with ``ignore_stale_grad=True``. ``optimizer_params`` may carry an
``lr_scheduler``, which ``learning_rate`` reads. The kvstore is the local
one: ``"device"``, ``"local"`` or ``None``. Other
kvstores, gradient compression and weight-update sharding raise
``NotImplementedError`` until the distributed part of the port lands
(``ROADMAP.md`` A.12).

``save_states``/``load_states`` write and read the JAX Trainer's state
file: a pickle of ``num_update``, ``update_count`` and ``arrays``, the
state leaves in the order ``jax.tree_util.tree_flatten`` gives the JAX
Trainer's ``_states`` dict. That order is the parameter indices sorted,
then each state's leaves: a multi-precision state ``{"master", "state"}``
gives its keys sorted (the fp32 master, then the inner state), and the
inner state is the optimizer's (Adam's the tuple (mean, variance); see
``optimizer.py``). Every leaf is an fp32 array but SGLD's uint32
pseudo-state.
"""
from __future__ import annotations

import io
import pickle

import numpy as np
import torch

from .. import optimizer as opt
from ..util import tree_leaves
from .parameter import ParameterDict

# what a state file may name when unpickled: numpy's array reconstruction,
# and ml_dtypes' types (bf16 arrays from the JAX package), which load as raw
# bytes to be refused with the array named, so ml_dtypes is never needed
_PICKLE_GLOBALS = {("numpy._core.multiarray", "_reconstruct"),
                   ("numpy.core.multiarray", "_reconstruct"),
                   ("numpy._core.multiarray", "scalar"),
                   ("numpy.core.multiarray", "scalar"),
                   ("numpy", "ndarray"), ("numpy", "dtype")}


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            return np.void
        if (module, name) not in _PICKLE_GLOBALS:
            raise pickle.UnpicklingError(
                "trainer state file names %s.%s, which it may not"
                % (module, name))
        return super().find_class(module, name)


LOCAL_KVSTORES = ("device", "local", None)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or a list of "
                             "Parameters")
        if kvstore not in LOCAL_KVSTORES:
            raise NotImplementedError(
                "kvstore %r is not ported yet (ROADMAP.md A.12); use one of "
                "%s" % (kvstore, LOCAL_KVSTORES))
        if compression_params:
            raise NotImplementedError(
                "gradient compression needs a distributed kvstore, which is "
                "not ported yet (ROADMAP.md A.12)")
        self._params = [p for p in params if p.grad_req != "null"]
        if isinstance(optimizer, opt.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._optimizer.idx2name = {i: p.name
                                    for i, p in enumerate(self._params)}
        self._states = {}
        self._scale = self._optimizer.rescale_grad

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_weight_update_sharding(self, mesh, axis="dp"):
        raise NotImplementedError("weight-update sharding is not ported yet "
                                  "(ROADMAP.md A.12)")

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step with gradients rescaled by 1/batch_size (one
        device: there is nothing to all-reduce first)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone. A parameter without a gradient raises
        ``RuntimeError``, or is left as it is with ``ignore_stale_grad``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        idx, ws, gs, ss = [], [], [], []
        for i, p in enumerate(self._params):
            if p._data is None:
                continue
            g = p._data.grad
            if g is None:
                if ignore_stale_grad:
                    continue
                raise RuntimeError("gradient of %s not attached; call "
                                   "attach_grad/initialize" % p.name)
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(i, p._tensor())
            idx.append(i)
            ws.append(p._tensor())
            gs.append(g)
            ss.append(self._states[i])
        for i, s in zip(idx, self._optimizer.fused_update(ws, gs, ss, idx)):
            self._states[i] = s

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def _leaves(self):
        """[(parameter name, leaf tensor)] of every state, in file order."""
        return [(self._params[i].name, t) for i in sorted(self._states)
                for t in tree_leaves(self._states[i])]

    def save_states(self, fname):
        """Write the optimizer state in the JAX Trainer's format (see the
        module docstring)."""
        arrays = [t.detach().cpu().numpy() for _, t in self._leaves()]
        with open(fname, "wb") as f:
            pickle.dump({"num_update": self._optimizer.num_update,
                         "update_count":
                             dict(self._optimizer._index_update_count),
                         "arrays": arrays}, f)

    def load_states(self, fname):
        """Read a state file either package wrote. The state of every
        parameter is made first, then filled from the file's arrays in
        order. Every array must have its leaf's dtype and shape; a bf16
        array (the JAX package writes one only for an optimizer whose state
        takes the weight's dtype) raises, naming the array, before any
        state changes."""
        with open(fname, "rb") as f:
            blob = _StateUnpickler(io.BytesIO(f.read())).load()
        for i, p in enumerate(self._params):
            if i not in self._states and p._data is not None:
                self._states[i] = self._optimizer.create_state(i, p._tensor())
        leaves = self._leaves()
        arrays = blob["arrays"]
        if len(arrays) != len(leaves):
            raise ValueError("%s holds %d state arrays, this trainer's "
                             "optimizer state has %d"
                             % (fname, len(arrays), len(leaves)))
        for j, ((name, t), a) in enumerate(zip(leaves, arrays)):
            what = "%s: arrays[%d] (a state of %s)" % (fname, j, name)
            want = np.dtype(str(t.dtype).replace("torch.", ""))
            if a.dtype.kind == "V" or a.dtype != want:
                raise TypeError(
                    "%s is %s, not %s; the port loads its optimizer's state "
                    "dtypes only" % (what, "bfloat16 or another ml_dtypes "
                                     "type" if a.dtype.kind == "V"
                                     else a.dtype, want))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError("%s has shape %s, the state %s"
                                 % (what, a.shape, tuple(t.shape)))
        with torch.no_grad():
            for (_, t), a in zip(leaves, arrays):
                t.copy_(torch.from_numpy(np.array(a, copy=True)))
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(blob["update_count"])
