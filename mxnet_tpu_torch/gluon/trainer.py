"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; the JAX package's
``mxnet_tpu/gluon/trainer.py``).

Every dense parameter goes through one multi-tensor optimizer step a call
(``Optimizer.fused_update``), which updates the weights in place; a
parameter without a gradient raises ``RuntimeError`` naming it, or is
skipped with ``ignore_stale_grad=True``. ``optimizer_params`` may carry an
``lr_scheduler``, which ``learning_rate`` reads.

Gradients are reduced across ranks before the update
(:meth:`Trainer.allreduce_grads`) in one of two ways:

- ``kvstore=`` a name other than ``"device"``/``"local"``/None, or a
  ``KVStore`` object: one batched push and pull of every gradient (a
  ``"dist_sync"`` store sums them over the ranks); ``compression_params``
  sets the store's 2-bit compression (without a store it warns and is
  ignored, as in the JAX package);
- ``mxnet_tpu_torch.dist.attach(trainer, mesh, ...)``: the bucketed
  exchange launched under the backward, which ``allreduce_grads``
  finishes.

``set_weight_update_sharding(mesh, axis)`` shards the update (ZeRO-1,
``optimizer.sharded_step``): each rank updates its block of every weight
along the first axis the group size divides and the weights are
all-gathered; the optimizer state holds only the rank's blocks.
``mesh=None`` (or ``axis=None``) switches it off; the states are re-laid
either way. ``update_on_kvstore`` is taken for the reference's signature;
the update always runs in the trainer, as in the JAX package.

When every parameter belongs to a hybridized block (``hybridize()``) and
the optimizer allows it (``Optimizer.graph_safe``: SGD, NAG, Adam, AdamW,
AdaGrad, AdaDelta, RMSProp, Ftrl), a local whole update runs as one
``optimizer.StepProgram``: a CUDA graph of the fused step, its rates and
update counts written into device buffers before each replay
(:meth:`graph_stats`). The others step eagerly.

``save_states``/``load_states`` write and read the JAX Trainer's state
file: a pickle of ``num_update``, ``update_count`` and ``arrays``, the
state leaves in the order ``jax.tree_util.tree_flatten`` gives the JAX
Trainer's ``_states`` dict. That order is the parameter indices sorted,
then each state's leaves: a multi-precision state ``{"master", "state"}``
gives its keys sorted (the fp32 master, then the inner state), and the
inner state is the optimizer's (Adam's the tuple (mean, variance); see
``optimizer.py``). Every leaf is an fp32 array but SGLD's uint32
pseudo-state. Under weight-update sharding the file holds the whole
states (every rank gathers them; global rank 0 writes), the layout the
JAX package's sharded states have, and loading takes each rank's blocks.
"""
from __future__ import annotations

import io
import pickle
import warnings

import numpy as np
import torch

from .. import optimizer as opt
from ..util import map_state, tree_leaves
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
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or a list of "
                             "Parameters")
        self._kvstore = None
        if isinstance(kvstore, str) and kvstore not in LOCAL_KVSTORES:
            from ..kvstore import create as kv_create

            self._kvstore = kv_create(kvstore)
        elif not isinstance(kvstore, str) and kvstore is not None:
            self._kvstore = kvstore
        if compression_params:
            if self._kvstore is None:
                # the local path has no wire to compress
                warnings.warn("compression_params ignored: kvstore=%r "
                              "reduces nothing across ranks; gradient "
                              "compression applies to dist kvstores"
                              % (kvstore,))
            else:
                self._kvstore.set_gradient_compression(compression_params)
        self._wu_mesh = None
        self._wu_axis = "dp"
        self._dist = None  # DistHandle installed by dist.attach
        self._params = [p for p in params if p.grad_req != "null"]
        if isinstance(optimizer, opt.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **(optimizer_params or {}))
        self._optimizer.idx2name = {i: p.name
                                    for i, p in enumerate(self._params)}
        self._states = {}
        self._scale = self._optimizer.rescale_grad
        self._program = None  # optimizer.StepProgram, when hybridized

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_weight_update_sharding(self, mesh, axis="dp"):
        """Shard the weight update over ``axis`` of ``mesh`` (ZeRO-1, Xu
        et al., arXiv 2004.13336), on every rank; ``mesh=None`` or
        ``axis=None`` updates whole weights again. Existing optimizer
        states are re-laid (blocks taken, or gathered back)."""
        old = self._layout_fn()
        self._wu_mesh = mesh
        self._wu_axis = axis
        new = self._layout_fn()
        if old is None and new is None:
            return
        for i in list(self._states):
            full = self._states[i] if old is None else map_state(
                self._states[i], old(i)[0])
            self._states[i] = full if new is None else map_state(
                full, new(i)[1])

    def _layout_fn(self):
        """None when the update is whole; else ``layout(i) -> (gather,
        cut)`` of parameter ``i``: functions of a state leaf that give it
        whole, and this rank's block of a whole one."""
        if self._wu_mesh is None or self._wu_axis is None:
            return None
        from ..dist.zero import block, gather_block, shard_dim

        mesh, axis = self._wu_mesh, self._wu_axis
        n, r, group = mesh.shape[axis], mesh.local_rank(axis), \
            mesh.group(axis)

        def layout(i):
            shape = self._full_shape(self._params[i])
            d = shard_dim(shape, n)
            bshape = list(shape)
            if d is not None:
                bshape[d] //= n

            def gather(t):
                if d is None or tuple(t.shape) != tuple(bshape):
                    return t
                full = torch.empty(shape, dtype=t.dtype, device=t.device)
                gather_block(full, t, d, group, n)
                return full

            def cut(t):
                # a whole leaf gives its block; a block (a ZeRO-3 weight's
                # state) stays; either carries its whole shape
                if d is None:
                    return t
                if tuple(t.shape) == tuple(shape):
                    t = block(t, d, r, n).clone()
                elif tuple(t.shape) != tuple(bshape):
                    return t
                t._full_shape = tuple(shape)
                return t

            return gather, cut

        return layout

    def _full_shape(self, p):
        manager = getattr(self._dist, "manager", None)
        if manager is not None and id(p) in manager.full_shapes:
            return manager.full_shapes[id(p)]
        return tuple(p._data.shape)

    def allreduce_grads(self):
        """Reduce the gradients across ranks: finish the attached dist
        exchange, or push every gradient to the kvstore and pull the sum
        back into it (one batched push and pull; each key reset first, so
        a step's pull is that step's sum). Nothing to do on the local
        path."""
        if self._dist is not None:
            self._dist.finish()
            return
        if self._kvstore is None:
            return
        keys, grads = [], []
        for i, p in enumerate(self._params):
            if p._data is None or p._data.grad is None:
                continue
            keys.append(i)
            grads.append(p._data.grad)
        if not keys:
            return
        for k, g in zip(keys, grads):
            self._kvstore.init(k, torch.zeros_like(g))
        self._kvstore.push(keys, grads)
        self._kvstore.pull(keys, out=grads)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients across ranks (:meth:`allreduce_grads`),
        then one optimizer step with them rescaled by 1/batch_size."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone. A parameter without a gradient raises
        ``RuntimeError``, or is left as it is with ``ignore_stale_grad``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        dist = self._dist
        shards = dist.grad_shards if dist is not None else {}
        manager = dist.manager if dist is not None else None
        idx, ws, gs, ss = [], [], [], []
        for i, p in enumerate(self._params):
            if p._data is None:
                continue
            g = shards.get(id(p), p._data.grad)
            if g is None:
                if ignore_stale_grad:
                    continue
                raise RuntimeError("gradient of %s not attached; call "
                                   "attach_grad/initialize" % p.name)
            w = manager.shard(p) if manager is not None else p._tensor()
            if i not in self._states:
                state = self._optimizer.create_state(i, w)
                sharded = self._layout_fn()
                self._states[i] = state if sharded is None else \
                    map_state(state, sharded(i)[1])
            idx.append(i)
            ws.append(w)
            gs.append(g)
            ss.append(self._states[i])
        if self._graphed(idx):
            if self._program is None:
                self._program = opt.StepProgram(self._optimizer)
            new = self._program.run(ws, gs, ss, idx)
        elif self._layout_fn() is None:
            new = self._optimizer.fused_update(ws, gs, ss, idx)
        else:
            mesh, axis = self._wu_mesh, self._wu_axis
            fused = self._optimizer.fused_update
            new = opt.sharded_step(
                lambda wb, gb: fused(wb, gb, ss, idx), ws, gs,
                group=mesh.group(axis), nshard=mesh.shape[axis],
                rank=mesh.local_rank(axis), keep_sharded=manager is not None,
                full_shapes=[self._full_shape(self._params[i])
                             for i in idx])
        for i, s in zip(idx, new):
            self._states[i] = s
        if dist is not None:
            dist.grad_shards = {}
        if manager is not None:
            # the blocks moved: the whole weights are stale until the
            # next gather_params()
            manager.release()

    def _graphed(self, idx):
        """Whether this step runs as the optimizer's step program: every
        parameter stepped belongs to a hybridized block, the optimizer can
        be captured, and the update is local and whole."""
        return (self._optimizer.graph_safe and self._dist is None
                and self._layout_fn() is None and bool(idx) and all(
                    self._params[i]._hybridized
                    for i in idx))

    def graph_stats(self):
        """The step program's counts (``optimizer.StepProgram``), or None
        when no step ran through one."""
        p = self._program
        return None if p is None else {"captures": p.captures,
                                       "replays": p.replays,
                                       "recaptures": p.recaptures}

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def _leaves(self, states=None):
        """[(parameter name, leaf tensor)] of every state, in file order."""
        states = self._states if states is None else states
        return [(self._params[i].name, t) for i in sorted(states)
                for t in tree_leaves(states[i])]

    def _whole_states(self):
        layout = self._layout_fn()
        if layout is None:
            return self._states
        return {i: map_state(s, layout(i)[0])
                for i, s in self._states.items()}

    def save_states(self, fname):
        """Write the optimizer state in the JAX Trainer's format (see the
        module docstring). Under weight-update sharding every rank calls
        it (the states are gathered) and global rank 0 writes."""
        from ..parallel import distributed

        arrays = [t.detach().cpu().numpy()
                  for _, t in self._leaves(self._whole_states())]
        if self._layout_fn() is not None and distributed.rank() != 0:
            return
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
        layout = self._layout_fn()
        if layout is not None:  # whole states to fill, then cut
            mesh, axis = self._wu_mesh, self._wu_axis
            self.set_weight_update_sharding(None)
        for i, p in enumerate(self._params):
            if i not in self._states and p._data is not None:
                self._states[i] = self._optimizer.create_state(i, p._tensor())
        try:
            self._fill_states(fname, blob)
        finally:
            if layout is not None:
                self.set_weight_update_sharding(mesh, axis)

    def _fill_states(self, fname, blob):
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
