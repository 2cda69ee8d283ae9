"""Multi-layer RNN, LSTM and GRU layers (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; ref: python/mxnet/gluon/rnn/
rnn_layer.py) over the fused op ``F.RNN`` (``ops/rnn.py``).

The parameters are named as in MXNet and the JAX package, per layer and
direction: ``l0_i2h_weight``, ``l0_h2h_weight``, ``l0_i2h_bias``,
``l0_h2h_bias``, ``r0_...`` for the reverse direction. ``input_size=0``
defers the first layer's input width to the first forward. Without
states the layer starts from fp32 zeros (so under amp the LSTM cell state
runs in fp32) and returns the output alone; with states it returns
``(output, new_states)``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...ops.rnn import GATES
from ..block import HybridBlock
from ..nn.basic_layers import _symbolic

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be TNC or NTC, got %r" % (layout,))
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._gates = GATES[mode]
        ng, nh = self._gates, hidden_size
        with self.name_scope():
            for layer in range(num_layers):
                for suffix in ["l", "r"][:self._dir]:
                    in_sz = input_size if layer == 0 else nh * self._dir
                    for name, shape, init in (
                            ("i2h_weight", (ng * nh, in_sz),
                             i2h_weight_initializer),
                            ("h2h_weight", (ng * nh, nh),
                             h2h_weight_initializer),
                            ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                            ("h2h_bias", (ng * nh,), h2h_bias_initializer)):
                        pname = "%s%d_%s" % (suffix, layer, name)
                        p = self.params.get(pname, shape=shape, init=init,
                                            allow_deferred_init=True,
                                            dtype=dtype)
                        setattr(self, pname, p)

    def _weight_names(self):
        return ["%s%d_%s" % (suffix, layer, nm)
                for layer in range(self._num_layers)
                for suffix in ["l", "r"][:self._dir]
                for nm in ("i2h_weight", "h2h_weight", "i2h_bias",
                           "h2h_bias")]

    def infer_shape(self, x, *args):
        for suffix in ["l", "r"][:self._dir]:
            p = getattr(self, "%s0_i2h_weight" % suffix)
            p.shape = (self._gates * self._hidden_size, x.shape[-1])

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states as NDArrays of zeros (``func(shape, ctx=ctx,
        **kwargs)`` when given), on ``ctx`` or the current context."""
        if func is None:
            from ...ndarray import zeros as func
        return [func(info["shape"], ctx=ctx, **kwargs)
                for info in self.state_info(batch_size)]

    def hybrid_forward(self, F, inputs, states=None, **params):
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        return_states = states is not None
        if states is None:
            shape = (self._num_layers * self._dir, x.shape[1],
                     self._hidden_size)
            states = [torch.zeros(shape, device=x.device)
                      for _ in range(2 if self._mode == "lstm" else 1)]
        if self._mode == "lstm":
            h0, c0 = states
        else:
            h0 = states[0] if isinstance(states, (list, tuple)) else states
            c0 = torch.zeros_like(h0)
        weights = [params[n] for n in self._weight_names()]
        kw = dict(mode=self._mode, num_layers=self._num_layers,
                  bidirectional=self._dir == 2, p=self._dropout)
        if not _symbolic(x):  # in a graph the executor's is_train sets it
            kw["training"] = autograd.is_training()
        out, hn, cn = F.RNN(x, h0, c0, *weights, **kw)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if not return_states:
            return out
        return out, ([hn, cn] if self._mode == "lstm" else [hn])


class RNN(_RNNLayer):
    """(ref: rnn_layer.py:RNN)"""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)


class LSTM(_RNNLayer):
    """(ref: rnn_layer.py:LSTM)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """(ref: rnn_layer.py:GRU)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
