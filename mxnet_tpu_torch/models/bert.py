"""BERT (counterpart of ``mxnet_tpu/models/bert.py``; GluonNLP parity).

The same post-LN encoder, learned positional embeddings, GELU FFN, pooler,
tied MLM decoder and NSP head, with the same block structure and parameter
names. Attention goes through the ``F.scaled_dot_attention`` seam with the
BERT mask declared a prefix mask, so long sequences take the flash kernel;
every LayerNorm goes through the LayerNorm kernel.

Inside a ``tensor_parallel.tp_scope`` the attention, the FFN, a
vocabulary-split ``word_embed`` and the tied MLM decoder split their
math over the scope's ranks as the GPT blocks do (``models/gpt.py``); the
decoder's bias stays whole, each rank adding its slice.
"""
from __future__ import annotations

from .. import initializer as init_mod
from ..gluon import nn
from ..gluon.block import HybridBlock, param_block, param_value
from ..parallel import tensor_parallel as tp

__all__ = ["BERTModel", "BERTEncoder", "bert_base"]


class BERTAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units,
                                prefix="qkv_")
            self.attn_out = nn.Dense(units, flatten=False, in_units=units,
                                     prefix="attn_out_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x, mask=None):
        out, _ = tp.attention(x, self.qkv, self.attn_out, self._num_heads,
                              lambda h, H: self._attend(F, h, mask, H))
        if self.dropout is not None:
            out = self.dropout(out)
        return out

    def _attend(self, F, qkv, mask, H):
        """(B, T, 3 H D) fused q/k/v of H heads -> the attention (B, T,
        H D), before the output projection."""
        B, T = qkv.shape[0], qkv.shape[1]
        D = qkv.shape[2] // (3 * H)
        C = H * D
        qkv = F.reshape(qkv, shape=(B, T, 3, H, D))
        qkv = F.transpose(qkv, axes=(2, 0, 3, 1, 4))  # (3, B, H, T, D)
        # contiguous heads: the flash kernel reads (B, H, T, D) rows
        q = F.squeeze(F.slice_axis(qkv, axis=0, begin=0, end=1),
                      axis=0).contiguous()
        k = F.squeeze(F.slice_axis(qkv, axis=0, begin=1, end=2),
                      axis=0).contiguous()
        v = F.squeeze(F.slice_axis(qkv, axis=0, begin=2, end=3),
                      axis=0).contiguous()
        out = F.scaled_dot_attention(q, k, v, mask, prefix_mask=True)
        return F.reshape(F.transpose(out, axes=(0, 2, 1, 3)), shape=(B, T, C))


class BERTPositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                                  prefix="ffn_1_")
            self.activation = nn.Activation(activation)
            self.ffn_2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                                  prefix="ffn_2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        x = tp.ffn(x, self.ffn_1, self.activation, self.ffn_2)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class BERTEncoderCell(HybridBlock):
    """Post-LN cell (ref: gluonnlp bert.py:BERTEncoderCell)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attention = BERTAttention(units, num_heads, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units, epsilon=1e-12)
            self.ffn = BERTPositionwiseFFN(units, hidden_size, dropout)
            self.ln2 = nn.LayerNorm(in_channels=units, epsilon=1e-12)

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        x = self.ln2(x + self.ffn(x))
        return x


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, max_length=512, **kwargs):
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        with self.name_scope():
            self.position_weight = self.params.get(
                "position_weight", shape=(max_length, units),
                init=init_mod.Normal(0.02))
            self.dropout = nn.Dropout(dropout) if dropout else None
            self.ln = nn.LayerNorm(in_channels=units, epsilon=1e-12)
            self.cells = nn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.cells.add(BERTEncoderCell(units, hidden_size, num_heads,
                                               dropout, prefix="layer%d_" % i))

    def hybrid_forward(self, F, x, mask=None, position_weight=None):
        T = x.shape[1]
        pos = F.slice_axis(position_weight, axis=0, begin=0, end=T)
        x = x + F.expand_dims(pos, axis=0)
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """(ref: gluonnlp bert.py:BERTModel)"""

    def __init__(self, vocab_size=30522, token_type_vocab_size=2, units=768,
                 hidden_size=3072, num_layers=12, num_heads=12, dropout=0.1,
                 max_length=512, use_pooler=True, use_decoder=True,
                 use_classifier=True, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        with self.name_scope():
            self.word_embed = nn.Embedding(
                vocab_size, units, weight_initializer=init_mod.Normal(0.02),
                prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size, units,
                                                 prefix="token_type_embed_")
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout, max_length)
            if use_pooler:
                self.pooler = nn.Dense(units, activation="tanh", flatten=False,
                                       in_units=units, prefix="pooler_")
            if use_decoder:
                # MLM decoder, weight tied with word_embed at apply time
                self.decoder_transform = nn.Dense(
                    units, activation="gelu", flatten=False, in_units=units,
                    prefix="mlm_transform_")
                self.decoder_ln = nn.LayerNorm(in_channels=units,
                                               epsilon=1e-12)
                self.decoder_bias = self.params.get(
                    "decoder_bias", shape=(vocab_size,), init=init_mod.Zero())
            if use_classifier:
                self.classifier = nn.Dense(2, flatten=False, in_units=units,
                                           prefix="nsp_")

    def _make_mask(self, F, token_ids, valid_length):
        if valid_length is None:
            return None
        T = token_ids.shape[1]
        pos = F.arange(0, T, ctx=token_ids.device)  # (T,)
        return F.lesser(F.reshape(pos, shape=(1, 1, 1, T)),
                        F.reshape(valid_length, shape=(-1, 1, 1, 1)))

    def hybrid_forward(self, F, inputs, token_types=None, valid_length=None,
                       masked_positions=None, decoder_bias=None):
        w = param_block(self.word_embed.weight)
        scope = tp.split_scope(lambda: [(w, tp.COLUMN)])
        x = self.word_embed(inputs) if scope is None else \
            scope.embed(F, inputs, w)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        mask = self._make_mask(F, inputs, valid_length)
        seq = self.encoder(x, mask)
        outputs = [seq]
        if self._use_pooler:
            cls = F.squeeze(F.slice_axis(seq, axis=1, begin=0, end=1), axis=1)
            pooled = self.pooler(cls)
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.classifier(pooled))
        if self._use_decoder and masked_positions is not None:
            h = _gather_positions(F, seq, masked_positions)
            h = self.decoder_ln(self.decoder_transform(h))
            # tied decoder: logits = h @ word_embed.T + bias
            scope = tp.split_scope(lambda: [(w, tp.COLUMN)])
            if scope is not None:  # column-parallel over the vocabulary
                logits = scope.vocab_logits(F, h, w, decoder_bias,
                                            flat=False)
            else:
                tied = param_value(self.word_embed.weight)
                logits = F.dot(h, F.transpose(tied)) + decoder_bias
            outputs.append(logits)
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


def _gather_positions(F, seq, positions):
    """seq (B, T, C), positions (B, P) → (B, P, C)."""
    B, T, C = seq.shape
    P = positions.shape[1]
    flat = F.reshape(seq, shape=(B * T, C))
    offset = F.reshape(F.arange(0, B, ctx=seq.device) * T, shape=(B, 1))
    idx = F.cast(positions, dtype="int32") + F.cast(offset, dtype="int32")
    out = F.take(flat, F.reshape(idx, shape=(B * P,)), axis=0)
    return F.reshape(out, shape=(B, P, C))


def bert_base(vocab_size=30522, dropout=0.1, max_length=512, **kwargs):
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, dropout=dropout,
                     max_length=max_length, **kwargs)
