"""The LSTM PTB language model (counterpart of
``mxnet_tpu/models/lstm_lm.py``; ref: incubator-mxnet
example/gluon/word_language_model/model.py).

Embedding, dropout, the fused multi-layer recurrence of ``gluon.rnn``,
dropout, and the decoder: with ``tie_weights`` (and equal embedding and
hidden widths) one product against the embedding table, else a Dense
layer. The parameter names are the JAX package's. Called with states,
the model returns ``(logits, new_states)`` (the stateful evaluation
idiom: ``begin_state``, then one chunk of bptt tokens after another with
the states carried); without, the logits alone, from zero states.
"""
from __future__ import annotations

from ..gluon import nn, rnn
from ..gluon.block import HybridBlock, param_value

__all__ = ["RNNModel", "lstm_ptb"]


class RNNModel(HybridBlock):
    def __init__(self, mode="lstm", vocab_size=10000, num_embed=650,
                 num_hidden=650, num_layers=2, dropout=0.5, tie_weights=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._num_hidden = num_hidden
        self._tie = tie_weights and num_embed == num_hidden
        layer = {"lstm": rnn.LSTM, "gru": rnn.GRU}.get(mode, rnn.RNN)
        with self.name_scope():
            self.drop = nn.Dropout(dropout)
            self.embed = nn.Embedding(vocab_size, num_embed,
                                      prefix="word_embed_")
            self.rnn = layer(num_hidden, num_layers, dropout=dropout,
                             input_size=num_embed)
            if not self._tie:
                self.decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=num_hidden)

    def begin_state(self, batch_size, **kwargs):
        return self.rnn.begin_state(batch_size, **kwargs)

    def hybrid_forward(self, F, inputs, states=None):
        """inputs (T, N) int token ids -> logits (T, N, vocab)."""
        emb = self.drop(self.embed(inputs))
        if states is None:
            out = self.rnn(emb)
        else:
            out, states = self.rnn(emb, states)
        out = self.drop(out)
        if self._tie:
            w = param_value(self.embed.weight)
            T, N, H = out.shape
            logits = F.dot(out.reshape(T * N, H), w.t()).reshape(T, N, -1)
        else:
            logits = self.decoder(out)
        return logits if states is None else (logits, states)


def lstm_ptb(vocab_size=10000, tie_weights=True, **kwargs):
    """``bench.py``'s ``lstm`` model: 2 x 650 LSTM over a 650-wide
    embedding, tied decoder."""
    return RNNModel("lstm", vocab_size=vocab_size, tie_weights=tie_weights,
                    **kwargs)
