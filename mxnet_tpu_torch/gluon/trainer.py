"""gluon.Trainer (ref: python/mxnet/gluon/trainer.py; the JAX package's
``mxnet_tpu/gluon/trainer.py``), on one device.

Every dense parameter goes through one multi-tensor optimizer step a call
(``Optimizer.fused_update``), which updates the weights in place. The
kvstore is the local one: ``"device"``, ``"local"`` or ``None``. Other
kvstores, gradient compression and weight-update sharding raise
``NotImplementedError`` until the distributed part of the port lands
(``ROADMAP.md`` A.12); saving and loading the trainer's state waits for
checkpoint interchange (A.7).
"""
from __future__ import annotations

from .. import optimizer as opt
from .parameter import ParameterDict

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

    def step(self, batch_size):
        """One optimizer step with gradients rescaled by 1/batch_size (one
        device: there is nothing to all-reduce first)."""
        self.update(batch_size)

    def update(self, batch_size):
        self._optimizer.rescale_grad = self._scale / batch_size
        idx, ws, gs, ss = [], [], [], []
        for i, p in enumerate(self._params):
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(i, p.data())
            idx.append(i)
            ws.append(p.data())
            gs.append(p.grad())
            ss.append(self._states[i])
        for i, s in zip(idx, self._optimizer.fused_update(ws, gs, ss, idx)):
            self._states[i] = s

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname):
        raise NotImplementedError("trainer state checkpoints are not ported "
                                  "yet (ROADMAP.md A.7)")

    def load_states(self, fname):
        raise NotImplementedError("trainer state checkpoints are not ported "
                                  "yet (ROADMAP.md A.7)")
