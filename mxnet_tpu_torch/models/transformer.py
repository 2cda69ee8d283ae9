"""Transformer NMT (counterpart of ``mxnet_tpu/models/transformer.py``;
ref: gluon-nlp scripts/machine_translation, sockeye/transformer.py).

The post-LN encoder-decoder with fixed sinusoidal positions (the
``pos_enc`` :class:`~mxnet_tpu_torch.gluon.Constant`), an optional shared
source/target embedding, and three ways to translate: greedy over a
fixed-capacity KV cache (``decode_step``), greedy by running the whole
prefix again every step, and beam search. Attention goes through the
``F.scaled_dot_attention`` seam: at NMT's lengths (under the flash
threshold) it is the dense path, with the ``src_valid`` key-padding mask
and the decoder's causal triangle. Every LayerNorm goes through the
LayerNorm kernel: 12 in the encoder, 18 in the decoder.

The decode caches are tensors written in place by ``F.cache_write``
(fixed (B, H, capacity, D) buffers, attention masked to the live prefix).
Tokens are chosen on the host each step, and beam search ranks its
candidates in numpy, with the JAX package's code and tie rules.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock, param_value
from ..ndarray import NDArray, unwrap, wrap
from ..ops import functional as F

__all__ = ["TransformerModel", "transformer_base"]


def _sinusoid(max_len, units):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / units)
    enc = np.zeros((max_len, units), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


class MultiHeadAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._heads = num_heads
        with self.name_scope():
            self.query = nn.Dense(units, flatten=False, in_units=units,
                                  prefix="query_")
            self.key = nn.Dense(units, flatten=False, in_units=units,
                                prefix="key_")
            self.value = nn.Dense(units, flatten=False, in_units=units,
                                  prefix="value_")
            self.attn_out = nn.Dense(units, flatten=False, in_units=units,
                                     prefix="attn_out_")

    def _split(self, x):
        B, T, C = x.shape
        H = self._heads
        return x.reshape(B, T, H, C // H).transpose(1, 2)

    def _merge(self, out):
        B, H, T, D = out.shape
        return out.transpose(1, 2).reshape(B, T, H * D)

    def hybrid_forward(self, F, q_in, kv_in, mask=None, causal=False):
        q = self._split(self.query(q_in))
        k = self._split(self.key(kv_in))
        v = self._split(self.value(kv_in))
        out = F.scaled_dot_attention(q, k, v, mask, causal=causal)
        return self.attn_out(self._merge(out))

    def project_kv(self, kv_in):
        """K and V heads of ``kv_in`` for the decode cache."""
        return {"k": self._split(self.key(kv_in)),
                "v": self._split(self.value(kv_in))}

    def step(self, q_in, cache):
        """One decode step, q_in (B, 1, C). A self-attention cache holds
        (B, H, capacity, D) buffers that this step writes at position
        ``cache["n"]`` in place, attending to positions up to it; a
        cross-attention cache (``cache["static"]``) holds the encoder's
        projections."""
        q = self._split(self.query(q_in))
        if cache.get("static"):
            out = F.scaled_dot_attention(q, cache["k"], cache["v"])
        else:
            n = cache["n"]
            k = F.cache_write(cache["k"], self._split(self.key(q_in)), n)
            v = F.cache_write(cache["v"], self._split(self.value(q_in)), n)
            cache["n"] = n + 1
            cap = k.shape[2]
            mask = (torch.arange(cap, device=k.device) <= n).reshape(
                1, 1, 1, cap)
            out = F.scaled_dot_attention(q, k, v, mask)
        return self.attn_out(self._merge(out))


class FFN(HybridBlock):
    def __init__(self, units, hidden, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ffn_1 = nn.Dense(hidden, flatten=False, in_units=units,
                                  activation="relu", prefix="ffn_1_")
            self.ffn_2 = nn.Dense(units, flatten=False, in_units=hidden,
                                  prefix="ffn_2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        x = self.ffn_2(self.ffn_1(x))
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class EncoderCell(HybridBlock):
    def __init__(self, units, hidden, heads, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.attn = MultiHeadAttention(units, heads, dropout)
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.ffn = FFN(units, hidden, dropout)
            self.ln2 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, mask=None):
        x = self.ln1(x + self.attn(x, x, mask))
        return self.ln2(x + self.ffn(x))


class DecoderCell(HybridBlock):
    def __init__(self, units, hidden, heads, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.self_attn = MultiHeadAttention(units, heads, dropout,
                                                prefix="self_")
            self.ln1 = nn.LayerNorm(in_channels=units)
            self.cross_attn = MultiHeadAttention(units, heads, dropout,
                                                 prefix="cross_")
            self.ln2 = nn.LayerNorm(in_channels=units)
            self.ffn = FFN(units, hidden, dropout)
            self.ln3 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, enc_out, self_mask=None, cross_mask=None):
        x = self.ln1(x + self.self_attn(x, x, self_mask, causal=True))
        x = self.ln2(x + self.cross_attn(x, enc_out, cross_mask))
        return self.ln3(x + self.ffn(x))

    def step(self, x, cache):
        """One token through the layer with its caches
        ``{"self": ..., "cross": ...}``."""
        x = self.ln1(x + self.self_attn.step(x, cache["self"]))
        x = self.ln2(x + self.cross_attn.step(x, cache["cross"]))
        return self.ln3(x + self.ffn(x))


class TransformerModel(HybridBlock):
    def __init__(self, src_vocab=32000, tgt_vocab=32000, units=512,
                 hidden=2048, num_layers=6, num_heads=8, dropout=0.1,
                 max_len=512, share_embed=False, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_len = max_len
        with self.name_scope():
            self.src_embed = nn.Embedding(
                src_vocab, units, weight_initializer=init_mod.Normal(0.02),
                prefix="src_embed_")
            self.tgt_embed = (self.src_embed if share_embed else
                              nn.Embedding(tgt_vocab, units,
                                           weight_initializer=init_mod.Normal(
                                               0.02),
                                           prefix="tgt_embed_"))
            self.pos_enc = self.params.get_constant(
                "pos_enc", _sinusoid(max_len, units))
            self.enc_cells = nn.HybridSequential(prefix="enc_")
            for i in range(num_layers):
                self.enc_cells.add(EncoderCell(units, hidden, num_heads,
                                               dropout,
                                               prefix="enc_layer%d_" % i))
            self.dec_cells = nn.HybridSequential(prefix="dec_")
            for i in range(num_layers):
                self.dec_cells.add(DecoderCell(units, hidden, num_heads,
                                               dropout,
                                               prefix="dec_layer%d_" % i))
            self.proj = nn.Dense(tgt_vocab, flatten=False, in_units=units,
                                 prefix="proj_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def _embed(self, embed, x, pos_enc):
        h = embed(x) * math.sqrt(self._units)
        h = h + pos_enc[:x.shape[1]][None]
        if self.dropout is not None:
            h = self.dropout(h)
        return h

    def encode(self, src, pos_enc, src_mask=None):
        h = self._embed(self.src_embed, src, pos_enc)
        for cell in self.enc_cells:
            h = cell(h, src_mask)
        return h

    def decode(self, tgt, enc_out, pos_enc, cross_mask=None):
        h = self._embed(self.tgt_embed, tgt, pos_enc)
        for cell in self.dec_cells:
            h = cell(h, enc_out, None, cross_mask)
        return self.proj(h)

    def hybrid_forward(self, F, src, tgt, src_valid=None, pos_enc=None,
                       **params):
        """src (B, S), tgt (B, T) token ids (teacher forcing), src_valid
        (B,) the source lengths (keys past them masked) -> logits
        (B, T, tgt_vocab)."""
        mask = None
        if src_valid is not None:
            S = src.shape[1]
            mask = (torch.arange(S, device=src.device).reshape(1, 1, 1, S)
                    < src_valid.reshape(-1, 1, 1, 1))
        enc_out = self.encode(src, pos_enc, mask)
        return self.decode(tgt, enc_out, pos_enc, mask)

    # ------------------------------------------------------- inference
    def init_cache(self, enc_out, capacity=None):
        """A decode cache a layer: self-attention K/V as (B, H, capacity, D)
        zeros (``capacity`` defaults to ``max_len``), cross-attention K/V
        the encoder output's projections."""
        cap = int(capacity if capacity is not None else self._max_len)
        B = enc_out.shape[0]
        H = self.dec_cells[0].self_attn._heads
        D = self._units // H
        caches = []
        for cell in self.dec_cells:
            cross = cell.cross_attn.project_kv(enc_out)
            cross["static"] = True
            caches.append({"self": {
                "k": enc_out.new_zeros((B, H, cap, D)),
                "v": enc_out.new_zeros((B, H, cap, D)), "n": 0},
                "cross": cross})
        return caches

    def decode_step(self, tok, caches, position):
        """tok (B, 1) the current tokens at ``position`` -> logits
        (B, 1, tgt_vocab); writes the caches in place."""
        h = self.tgt_embed(tok) * math.sqrt(self._units)
        h = h + param_value(self.pos_enc)[position:position + 1][None]
        for cell, cache in zip(self.dec_cells, caches):
            h = cell.step(h, cache)
        return self.proj(h)

    def translate(self, src, max_len=64, bos=2, eos=3, beam=1,
                  use_cache=True, device=None):
        """Greedy (``beam=1``) or beam-search translation of src (B, S)
        token ids, on ``device`` (default: the current CUDA device; the
        parameters must be there): (B, <= max_len) int32 starting with
        ``bos``, stopping early once every row has emitted ``eos``. Greedy
        decodes over the fixed cache, or with ``use_cache=False`` runs the
        whole prefix again every step (the oracle the cached path is held
        against); beam search takes one sentence. An NDArray src gives an
        NDArray."""
        device = resolve_device(device)
        as_nd = isinstance(src, NDArray)
        src = torch.as_tensor(unwrap(src, False), device=device)
        if self.proj.weight._tensor().device != device:
            raise ValueError("translate on %s, but the parameters are on %s"
                             % (device, self.proj.weight._tensor().device))
        with torch.no_grad():
            if beam > 1:
                out = self._beam_search(src, max_len, bos, eos, beam)
            else:
                out = self._greedy(src, max_len, bos, eos, use_cache)
        return wrap(out) if as_nd else out

    def _greedy(self, src, max_len, bos, eos, use_cache):
        B = src.shape[0]
        tgt = torch.full((B, 1), bos, dtype=torch.int32, device=src.device)
        if use_cache:
            enc_out = self.encode(src, param_value(self.pos_enc))
            caches = self.init_cache(enc_out, capacity=max_len)
            pieces = [tgt]
            cur = tgt
            for t in range(max_len - 1):
                logits = self.decode_step(cur, caches, t)
                nxt = _host(logits[:, -1]).argmax(-1).astype("int32")
                cur = torch.from_numpy(nxt[:, None]).to(src.device)
                pieces.append(cur)
                if (nxt == eos).all():
                    break
            return torch.cat(pieces, dim=1)
        for _ in range(max_len - 1):
            logits = self(src, tgt)
            nxt = _host(logits[:, -1]).argmax(-1).astype("int32")
            tgt = torch.cat([tgt, torch.from_numpy(nxt[:, None]).to(
                src.device)], dim=1)
            if (nxt == eos).all():
                break
        return tgt

    def _beam_search(self, src, max_len, bos, eos, beam):
        if src.shape[0] != 1:
            raise ValueError("beam search takes one sentence, got %d"
                             % src.shape[0])
        src_rep = src.repeat(beam, 1)
        seqs = np.full((beam, 1), bos, np.int32)
        scores = np.array([0.0] + [-1e9] * (beam - 1))
        done = np.zeros(beam, bool)
        for _ in range(max_len - 1):
            logits = self(src_rep, torch.from_numpy(seqs).to(src.device))
            logp = np.log(np.maximum(_softmax_np(_host(logits[:, -1])),
                                     1e-30))
            logp[done] = -1e9
            logp[done, eos] = 0.0
            cand = scores[:, None] + logp  # (beam, V)
            flat = cand.ravel()
            top = np.argpartition(-flat, beam)[:beam]
            top = top[np.argsort(-flat[top])]
            parents, tokens = top // logp.shape[1], top % logp.shape[1]
            seqs = np.concatenate([seqs[parents],
                                   tokens[:, None].astype(np.int32)], axis=1)
            scores = flat[top]
            done = done[parents] | (tokens == eos)
            if done.all():
                break
        return torch.from_numpy(seqs[np.argmax(scores)][None]).to(src.device)


def _host(logits):
    """Logits on the host as numpy, fp32 (a bf16 value is exact in
    fp32)."""
    return logits.detach().float().cpu().numpy()


def _softmax_np(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def transformer_base(src_vocab=32000, tgt_vocab=32000, **kwargs):
    """``bench.py``'s ``nmt`` model: 6 + 6 layers, 512 units, FFN 2048, 8
    heads."""
    return TransformerModel(src_vocab, tgt_vocab, units=512, hidden=2048,
                            num_layers=6, num_heads=8, **kwargs)
