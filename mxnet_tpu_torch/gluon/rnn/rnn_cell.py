"""Single-step recurrent cells (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``; ref: python/mxnet/gluon/rnn/
rnn_cell.py).

A cell maps ``(inputs (N, C), states)`` to ``(output, new_states)``;
``unroll`` runs it over a sequence step by step (the fused layers of
``rnn_layer.py`` are the fast form of the same recurrences). Gate orders
are MXNet's: LSTM ``[i, f, g, o]``, GRU ``[r, z, n]``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...ndarray import NDArray, unwrap, wrap
from ..block import HybridBlock
from ..nn.basic_layers import _symbolic

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ResidualCell", "ZoneoutCell",
           "ModifierCell"]


def _tensors(x):
    if isinstance(x, (list, tuple)):
        return [_tensors(a) for a in x]
    return unwrap(x, autograd.is_recording())


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states as NDArrays of zeros (``func(shape, ctx=ctx,
        **kwargs)`` when given), on ``ctx`` or the current context."""
        if func is None:
            from ...ndarray import zeros as func
        return [func(info["shape"], ctx=ctx, **kwargs)
                for info in self.state_info(batch_size)]

    def reset(self):
        pass

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs`` (layout NTC or
        TNC); returns (outputs stacked along T, or their list with
        ``merge_outputs=False``, final states). NDArray inputs give NDArray
        results (ref: rnn_cell.py:RecurrentCell.unroll)."""
        as_nd = isinstance(inputs, NDArray)
        axis = layout.find("T")
        x = _tensors(inputs)
        if begin_state is None:
            begin_state = self.begin_state(x.shape[layout.find("N")],
                                           ctx=_context(x))
        states = _tensors(begin_state)
        outputs = []
        for t in range(length):
            out, states = self(x.select(axis, t), states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return (wrap(outputs), wrap(states)) if as_nd else (outputs, states)


def _context(t):
    from ...context import context_from_device

    return context_from_device(t.device)


class _GatedCell(RecurrentCell):
    """The shared body of RNNCell, LSTMCell and GRUCell: ``gates`` x
    ``hidden_size`` input and recurrent projections."""

    _gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        g = self._gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(g, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(g, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get("i2h_bias", shape=(g,),
                                            init=i2h_bias_initializer)
            self.h2h_bias = self.params.get("h2h_bias", shape=(g,),
                                            init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._gates * self._hidden_size,
                                 x.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        g = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=g),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=g))


class RNNCell(_GatedCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._activation = activation

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_GatedCell):
    """Gate order [i, f, g, o] (ref: rnn_cell.py:LSTMCell)."""

    _gates = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        i, f, g, o = (i2h + h2h).chunk(4, dim=-1)
        c = torch.sigmoid(f) * states[1] + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, [h, c]


class GRUCell(_GatedCell):
    """Gate order [r, z, n] (ref: rnn_cell.py:GRUCell)."""

    _gates = 3

    def hybrid_forward(self, F, inputs, states, **params):
        i2h, h2h = self._projections(F, inputs, states[0], **params)
        xr, xz, xn = i2h.chunk(3, dim=-1)
        hr, hz, hn = h2h.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._children.values()
                for info in cell.state_info(batch_size)]

    def __len__(self):
        return len(self._children)

    def hybrid_forward(self, F, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states


# every cell here runs eagerly, so the hybrid class is the sequential one
# (ref: gluon/rnn/rnn_cell.py:HybridSequentialRNNCell)
HybridSequentialRNNCell = SequentialRNNCell


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, their outputs
    concatenated along the last axis; only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        as_nd = isinstance(inputs, NDArray)
        axis = layout.find("T")
        x = _tensors(inputs)
        if begin_state is None:
            begin_state = self.begin_state(x.shape[layout.find("N")],
                                           ctx=_context(x))
        states = _tensors(begin_state)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, x, states[:nl], layout,
                                             True)
        r_out, r_states = self.r_cell.unroll(
            length, torch.flip(x, dims=(axis,)), states[nl:], layout, True)
        out = torch.cat([l_out, torch.flip(r_out, dims=(axis,))], dim=2)
        states = l_states + r_states
        return (wrap(out), wrap(states)) if as_nd else (out, states)


class DropoutCell(RecurrentCell):
    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            kw = {} if _symbolic(inputs) else {
                "training": autograd.is_training()}  # a graph: is_train
            inputs = F.Dropout(inputs, p=self._rate, **kw)
        return inputs, states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another (ref: rnn_cell.py:ModifierCell):
    state shapes, ``begin_state`` and ``reset`` are the wrapped cell's."""

    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func=func, **kwargs)

    def reset(self):
        self.base_cell.reset()


class ResidualCell(ModifierCell):
    def hybrid_forward(self, F, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout (ref: rnn_cell.py:ZoneoutCell; Krueger et al. 2016): while
    training, each unit keeps its previous value with probability p, for
    the states and/or the output. The previous output is carried on the
    cell (``reset`` clears it)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(base_cell, **kwargs)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        out, new_states = self.base_cell(inputs, states)
        training = autograd.is_training()

        def keep_new(p, like):
            # Dropout of ones: 0 with probability p, else nonzero
            return F.Dropout(torch.ones_like(like), p=p,
                             training=training) != 0

        if self._zs > 0:
            new_states = [torch.where(keep_new(self._zs, s_new), s_new, s_old)
                          for s_old, s_new in zip(states, new_states)]
        if self._zo > 0:
            prev = self._prev_output
            out = torch.where(keep_new(self._zo, out), out,
                              prev if prev is not None
                              else torch.zeros_like(out))
            self._prev_output = out
        return out, new_states
