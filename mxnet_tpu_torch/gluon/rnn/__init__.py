"""Recurrent layers and cells of the port (counterpart of
``mxnet_tpu/gluon/rnn``; ref: python/mxnet/gluon/rnn)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (RecurrentCell, RNNCell, LSTMCell, GRUCell,  # noqa: F401
                       SequentialRNNCell, HybridSequentialRNNCell,
                       BidirectionalCell, DropoutCell, ResidualCell,
                       ZoneoutCell, ModifierCell)
