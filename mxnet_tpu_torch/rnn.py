"""``mx.rnn``, the legacy cell namespace (counterpart of
``mxnet_tpu/rnn.py``; ref: python/mxnet/rnn/rnn_cell.py, rnn/io.py).

The cells are ``gluon.rnn``'s under their legacy names; ``FusedRNNCell``
(upstream's cuDNN path) wraps the fused ``gluon.rnn`` layer, and
``BucketSentenceIter`` batches variable-length token sequences one bucket
at a time for a ``BucketingModule``.
"""
from __future__ import annotations

import warnings

import numpy as np

from .gluon import rnn as _grnn
from .gluon.rnn.rnn_cell import (  # noqa: F401
    BidirectionalCell, DropoutCell, GRUCell, LSTMCell, RecurrentCell,
    ModifierCell, ResidualCell, RNNCell, SequentialRNNCell, ZoneoutCell,
)

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ResidualCell", "ZoneoutCell",
           "ModifierCell", "FusedRNNCell", "BucketSentenceIter"]


class BucketSentenceIter:
    """(ref: rnn/io.py:BucketSentenceIter) Each sentence goes to the
    smallest bucket that holds it, padded with ``invalid_label`` (longer
    ones are discarded); each batch comes from one bucket, with
    ``bucket_key`` set, the labels the inputs shifted left by one. Layout
    ``NT`` (batch-major) or ``TN`` (time-major); ``shuffle`` permutes each
    bucket and the plan with ``RandomState(seed)``. Batches are NDArrays on
    the current context."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT", shuffle=False, seed=0):
        from .io import DataDesc

        if layout not in ("NT", "TN"):
            raise ValueError("layout must be 'NT' (batch-major) or 'TN' "
                             "(time-major), got %r" % (layout,))
        if buckets is None:
            lens = sorted({len(s) for s in sentences if len(s) > 0})
            if not lens:
                raise ValueError("no non-empty sentences to bucket")
            buckets = [l for l in lens
                       if sum(len(s) <= l for s in sentences) >= batch_size]
            buckets = buckets or [max(lens)]
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.layout = layout
        self._dtype = dtype
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)

        self.data = [[] for _ in self.buckets]
        ndiscard = 0
        for s in sentences:
            i = next((j for j, b in enumerate(self.buckets) if b >= len(s)),
                     None)
            if i is None:
                ndiscard += 1
                continue
            padded = np.full(self.buckets[i], invalid_label, np.int64)
            padded[:len(s)] = s
            self.data[i].append(padded)
        self.data = [np.asarray(d).reshape(-1, b) for d, b in
                     zip(self.data, self.buckets)]
        if ndiscard:
            warnings.warn("discarded %d sentences longer than the largest "
                          "bucket" % ndiscard)
        self.default_bucket_key = max(self.buckets)
        shape = self._shape(self.default_bucket_key)
        self.provide_data = [DataDesc(data_name, shape, dtype, layout=layout)]
        self.provide_label = [DataDesc(label_name, shape, dtype,
                                       layout=layout)]
        self.reset()

    def _shape(self, bucket):
        if self.layout == "TN":
            return (bucket, self.batch_size)
        return (self.batch_size, bucket)

    def reset(self):
        self._plan = []
        for i, d in enumerate(self.data):
            order = self._rng.permutation(len(d)) if self._shuffle \
                else range(len(d))
            order = list(order)
            for k in range(len(d) // self.batch_size):
                self._plan.append(
                    (i, order[k * self.batch_size:(k + 1) * self.batch_size]))
        if self._shuffle:
            self._rng.shuffle(self._plan)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from . import nd
        from .io import DataBatch, DataDesc

        if self._cursor >= len(self._plan):
            raise StopIteration
        i, rows = self._plan[self._cursor]
        self._cursor += 1
        buf = self.data[i][rows]
        label = np.full_like(buf, self.invalid_label)
        label[:, :-1] = buf[:, 1:]
        if self.layout == "TN":
            buf, label = buf.T, label.T
        shape = self._shape(self.buckets[i])
        return DataBatch(
            data=[nd.array(buf.astype(self._dtype))],
            label=[nd.array(label.astype(self._dtype))],
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, shape, self._dtype,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, shape, self._dtype,
                                    layout=self.layout)])


class FusedRNNCell:
    """(ref: rnn_cell.py:FusedRNNCell) A multi-layer RNN as one fused
    ``gluon.rnn`` layer (``TNC``); ``unroll`` runs ``length`` steps and
    returns the outputs and the final states."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None):
        cls = {"lstm": _grnn.LSTM, "gru": _grnn.GRU,
               "rnn_tanh": _grnn.RNN, "rnn_relu": _grnn.RNN}[mode]
        kwargs = dict(hidden_size=num_hidden, num_layers=num_layers,
                      bidirectional=bidirectional, dropout=dropout,
                      layout="TNC")
        if mode.startswith("rnn_"):
            kwargs["activation"] = mode.split("_")[1]
        self._layer = cls(**kwargs)
        self._mode = mode

    def __getattr__(self, name):
        return getattr(self._layer, name)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        from . import nd

        x = inputs
        if layout == "NTC":
            x = nd.swapaxes(x, dim1=0, dim2=1)
        T = x.shape[0]
        if length > T:
            raise ValueError("unroll length %d exceeds sequence length %d"
                             % (length, T))
        if length < T:
            x = nd.slice_axis(x, axis=0, begin=0, end=length)
        self._layer.initialize(device=x.context)
        if begin_state is None:
            # the legacy API returns the final states (truncated-BPTT
            # carry-over), so the layer always gets states
            begin_state = self._layer.begin_state(batch_size=x.shape[1],
                                                  ctx=x.context)
        out, states = self._layer(x, begin_state)
        if layout == "NTC":
            out = nd.swapaxes(out, dim1=0, dim2=1)
        return out, states
