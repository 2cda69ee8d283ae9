"""Convolutional recurrent cells, the variational dropout cell and the
projected LSTM cell (counterpart of ``mxnet_tpu/gluon/contrib/rnn.py``;
ref: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py,
Conv{1,2,3}D{RNN,LSTM,GRU}Cell, and contrib/rnn/rnn_cell.py).

A convolutional cell's state keeps its spatial structure: h is (batch,
hidden_channels, *spatial), and the input and state projections are
convolutions (cuDNN's) instead of dense products. The cells compose with
``gluon.rnn``'s ``RecurrentCell`` machinery (``unroll``,
``SequentialRNNCell``, ...).
"""
from __future__ import annotations

from ... import autograd
from ..rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "VariationalDropoutCell", "LSTMPCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _ConvCellBase(RecurrentCell):
    """Shared conv-cell machinery (ref: conv_rnn_cell.py:_BaseConvRNNCell)."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 **kwargs):
        super().__init__(**kwargs)
        dims = len(input_shape) - 1
        self._dims = dims
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            assert k % 2 == 1, ("h2h kernel must be odd to preserve the "
                                "state's spatial shape, got %r"
                                % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        # SAME padding for the state conv
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        in_c = input_shape[0]
        gates = self._num_gates
        self._state_spatial = tuple(
            (s + 2 * p - d * (k - 1) - 1) + 1
            for s, p, k, d in zip(input_shape[1:], self._i2h_pad,
                                  self._i2h_kernel, self._i2h_dilate))
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(gates * hidden_channels, in_c) + self._i2h_kernel)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(gates * hidden_channels, hidden_channels)
                + self._h2h_kernel)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(gates * hidden_channels,), init="zeros")
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(gates * hidden_channels,), init="zeros")

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        n = 2 if isinstance(self, _ConvLSTMMixin) else 1
        return [{"shape": shape} for _ in range(n)]

    def _conv_pair(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                   h2h_bias):
        gates = self._num_gates * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, num_filter=gates)
        h2h = F.Convolution(h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate, num_filter=gates)
        return i2h, h2h

    def _split(self, F, x, k):
        c = self._hidden_channels
        return [F.slice_axis(x, axis=1, begin=i * c, end=(i + 1) * c)
                for i in range(k)]

    def _act(self, F, x):
        return F.Activation(x, act_type=self._activation)


class _ConvRNNMixin:
    _num_gates = 1

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMMixin:
    _num_gates = 4

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        # MXNet gate order [i, f, g, o] (src/operator/rnn-inl.h)
        i, f, g, o = self._split(F, gates, 4)
        i, f, o = F.sigmoid(i), F.sigmoid(f), F.sigmoid(o)
        g = self._act(F, g)
        c = f * states[1] + i * g
        h = o * self._act(F, c)
        return h, [h, c]


class _ConvGRUMixin:
    _num_gates = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        # gate order [r, z, n]; reset applied after the recurrent conv
        ir, iz, inn = self._split(F, i2h, 3)
        hr, hz, hn = self._split(F, h2h, 3)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = self._act(F, inn + r * hn)
        out = (1 - z) * n + z * states[0]
        return out, [out]


def _cell(name, mixin, dims):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 **kwargs):
        assert len(input_shape) == dims + 1, (
            "%s expects input_shape (C,%s), got %r"
            % (name, ",".join("S" * dims), input_shape))
        _ConvCellBase.__init__(self, input_shape, hidden_channels,
                               i2h_kernel, h2h_kernel, **kwargs)

    return type(name, (mixin, _ConvCellBase), {"__init__": __init__})


Conv1DRNNCell = _cell("Conv1DRNNCell", _ConvRNNMixin, 1)
Conv2DRNNCell = _cell("Conv2DRNNCell", _ConvRNNMixin, 2)
Conv3DRNNCell = _cell("Conv3DRNNCell", _ConvRNNMixin, 3)
Conv1DLSTMCell = _cell("Conv1DLSTMCell", _ConvLSTMMixin, 1)
Conv2DLSTMCell = _cell("Conv2DLSTMCell", _ConvLSTMMixin, 2)
Conv3DLSTMCell = _cell("Conv3DLSTMCell", _ConvLSTMMixin, 3)
Conv1DGRUCell = _cell("Conv1DGRUCell", _ConvGRUMixin, 1)
Conv2DGRUCell = _cell("Conv2DGRUCell", _ConvGRUMixin, 2)
Conv3DGRUCell = _cell("Conv3DGRUCell", _ConvGRUMixin, 3)


class VariationalDropoutCell(RecurrentCell):
    """Variational (per-sequence) dropout wrapper (ref: python/mxnet/gluon/
    contrib/rnn/rnn_cell.py:VariationalDropoutCell, Gal & Ghahramani 2016).

    One Bernoulli mask per sequence for each of inputs / recurrent state /
    outputs, sampled on the first step after ``reset()`` and reused every
    step, unlike ``DropoutCell``, which draws anew each step. Masks are
    inverted-dropout scaled (``F.Dropout`` of ones) and drawn from
    ``random.generator`` of the input's device. Call ``reset()`` between
    sequences (the upstream contract) so that fresh masks are drawn."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._mask_i = self._mask_s = self._mask_o = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def reset(self):
        self.base_cell.reset()
        self._mask_i = self._mask_s = self._mask_o = None

    def _mask(self, F, slot, ref, rate):
        """The sequence's mask for ``slot``, drawn at its first step after
        ``reset()`` (inverted-dropout scaled: ``F.Dropout`` of ones)."""
        cached = self.__dict__.get(slot)
        if cached is None:
            cached = self.__dict__[slot] = F.Dropout(
                F.ones_like(ref), p=rate, training=True)
        return cached

    def hybrid_forward(self, F, inputs, states):
        # inference is a pure pass-through even if a training-phase mask is
        # still cached (upstream relies on reset() alone; gating on the mode
        # removes the stale-mask foot-gun)
        if not autograd.is_training():
            return self.base_cell(inputs, states)
        if self._di > 0:
            inputs = inputs * self._mask(F, "_mask_i", inputs, self._di)
        if self._ds > 0:
            states = ([states[0] * self._mask(F, "_mask_s", states[0],
                                              self._ds)] + list(states[1:]))
        out, nstates = self.base_cell(inputs, states)
        if self._do > 0:
            out = out * self._mask(F, "_mask_o", out, self._do)
        return out, nstates

    def __repr__(self):
        return ("VariationalDropoutCell(p_in=%g, p_state=%g, p_out=%g, %r)"
                % (self._di, self._ds, self._do, self.base_cell))


class LSTMPCell(RecurrentCell):
    """LSTM with a recurrent projection layer (ref: python/mxnet/gluon/
    contrib/rnn/rnn_cell.py:LSTMPCell; Sak et al. 2014). The recurrent
    state is ``r = h @ h2r`` of size ``projection_size`` — h2h and the
    output operate on the projected state, cutting recurrent matmul cost
    from O(h²) to O(h·p). Gate order [i, f, g, o] as LSTMCell."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, projection_size),
                init=h2h_weight_initializer)
            self.h2r_weight = self.params.get(
                "h2r_weight", shape=(projection_size, hidden_size),
                init=h2r_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        nh = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=4 * nh)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * nh)
        gates = i2h + h2h
        i = F.sigmoid(F.slice_axis(gates, axis=-1, begin=0, end=nh))
        f = F.sigmoid(F.slice_axis(gates, axis=-1, begin=nh, end=2 * nh))
        g = F.tanh(F.slice_axis(gates, axis=-1, begin=2 * nh, end=3 * nh))
        o = F.sigmoid(F.slice_axis(gates, axis=-1, begin=3 * nh, end=4 * nh))
        c = f * states[1] + i * g
        hidden = o * F.tanh(c)
        r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                             num_hidden=self._projection_size)
        return r, [r, c]
