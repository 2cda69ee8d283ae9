"""GPT-style decoder-only language model (counterpart of
``mxnet_tpu/models/gpt.py``; GPT-2 layout).

The same pre-LN blocks, learned positional embeddings, exact-erf GELU FFN
and LM head tied to the token embedding (one ``torch.matmul`` against the
table), with the same block structure and parameter names. Self-attention
goes through the ``F.scaled_dot_attention`` seam with ``causal=True``, so a
prompt of 256 tokens or more in bf16 takes the flash kernel; every
LayerNorm goes through the LayerNorm kernel.

Incremental decode runs over fixed-capacity caches: ``init_cache``
allocates (B, H, capacity, D) buffers once, every step writes its K/V into
them in place (``F.cache_write``) and attends to the live prefix, so no
buffer changes shape across steps. ``prefill`` fills a cache from the whole
prompt in one forward; ``decode_step_fixed`` is the per-slot-position step
``serve.GenerativeServer`` runs for all its slots at once, and
``decode_step_fixed_quant`` the same step over int8 KV pages.

Inside a ``tensor_parallel.tp_scope`` (``build_train_step(param_spec=)``
enters one) a block whose leaves ``TRANSFORMER_RULES`` split computes its
share only: its heads, its FFN columns, its vocabulary rows (the module
docstring of ``parallel/tensor_parallel.py`` says how).
"""
from __future__ import annotations

import torch

from .. import initializer as init_mod
from ..base import next_pow2, resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock, param_block, param_value
from ..ops import functional as nd
from ..parallel import tensor_parallel as tp

__all__ = ["GPTModel", "gpt2_small", "gpt_nano"]


class _CausalSelfAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._units = units
        self._heads = num_heads
        with self.name_scope():
            self.qkv = nn.Dense(3 * units, flatten=False, in_units=units,
                                prefix="qkv_")
            self.attn_out = nn.Dense(units, flatten=False, in_units=units,
                                     prefix="attn_out_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def _qkv_heads(self, F, x):
        return self._split_heads(F, self.qkv(x), self._heads)

    def _split_heads(self, F, h, H):
        """(B, T, 3 H D) fused q/k/v of H heads -> [q, k, v], each
        (B, H, T, D)."""
        B, T, C3 = h.shape
        h = F.reshape(h, shape=(B, T, 3, H, C3 // (3 * H)))
        h = F.transpose(h, axes=(2, 0, 3, 1, 4))  # (3, B, H, T, D)
        # contiguous heads: the flash kernel and the cache read (B, H, T, D)
        # rows
        return [F.squeeze(F.slice_axis(h, axis=0, begin=i, end=i + 1),
                          axis=0).contiguous() for i in range(3)]

    def _merge_heads(self, F, out):
        B, H, T, D = out.shape
        return F.reshape(F.transpose(out, axes=(0, 2, 1, 3)),
                         shape=(B, T, H * D))

    def forward_kv(self, F, x):
        """Causal self-attention that also returns the per-head K/V
        (B, H, T, D), which prefill writes into the decode cache; inside a
        tp scope that splits it, on each rank's H/n heads
        (``tensor_parallel.attention``), K/V those of every rank's
        heads."""
        def attend(h, H):
            q, k, v = self._split_heads(F, h, H)
            out = F.scaled_dot_attention(q, k, v, causal=True)
            return self._merge_heads(F, out), k, v

        out, kvs = tp.attention(x, self.qkv, self.attn_out, self._heads,
                                attend)
        if self.dropout is not None:
            out = self.dropout(out)
        k, v = (t[0] if len(t) == 1 else F.concat(*t, dim=1)
                for t in zip(*kvs))
        return out, k, v

    def hybrid_forward(self, F, x):
        return self.forward_kv(F, x)[0]

    def step_cached(self, F, x, k_cache, v_cache, start):
        """Decode against the fixed-capacity cache: ``x`` (B, T, C) holds
        the next T tokens, whose K/V are written in place at time offset
        ``start`` (an int, or a (B,) tensor of per-slot positions);
        attention masks to the live prefix ``pos <= start + row``, an
        arbitrary mask, so it takes the dense path. Returns (out (B, T, C),
        k_cache, v_cache)."""
        q, k_new, v_new = self._qkv_heads(F, x)
        k_cache = F.cache_write(k_cache, k_new, start)
        v_cache = F.cache_write(v_cache, v_new, start)
        mask = self._live_mask(F, x, k_cache.shape[2], start)
        out = F.scaled_dot_attention(q, k_cache, v_cache, mask)
        return self.attn_out(self._merge_heads(F, out)), k_cache, v_cache

    @staticmethod
    def _live_mask(F, x, cap, start):
        """(B or 1, 1, T, cap) mask of the live prefix ``pos <= start +
        row`` for the T rows of ``x`` written at ``start``."""
        T = x.shape[1]
        pos = F.reshape(F.arange(0, cap, dtype="int32", ctx=x.device),
                        shape=(1, 1, 1, cap))
        rows = F.reshape(F.arange(0, T, dtype="int32", ctx=x.device),
                         shape=(1, 1, T, 1))
        if isinstance(start, int):
            limit = rows + start
        else:  # (B,) per-slot positions
            limit = rows + F.reshape(start, shape=(-1, 1, 1, 1))
        return F.lesser_equal(pos, limit)

    def step_cached_quant(self, F, x, k_cache, k_scale, v_cache, v_scale,
                          start):
        """:meth:`step_cached` against int8 KV pages: the new K/V are
        quantized on write and the fused write and read
        (``F.quant_cache_write_read``, running per-page-per-head scale)
        hands attention the fp32 pages from the values it wrote, with no
        separate int8 to fp32 pass. Pages and scales are written in place.
        Returns (out, k_cache, k_scale, v_cache, v_scale)."""
        q, k_new, v_new = self._qkv_heads(F, x)
        k_cache, k_scale, k_deq = F.quant_cache_write_read(
            k_cache, k_scale, k_new, start)
        v_cache, v_scale, v_deq = F.quant_cache_write_read(
            v_cache, v_scale, v_new, start)
        mask = self._live_mask(F, x, k_cache.shape[2], start)
        out = F.scaled_dot_attention(q, k_deq, v_deq, mask)
        return (self.attn_out(self._merge_heads(F, out)),
                k_cache, k_scale, v_cache, v_scale)


class _GPTBlock(HybridBlock):
    """Pre-LN residual block (GPT-2 layout, unlike BERT's post-LN)."""

    def __init__(self, units, hidden, heads, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.attn = _CausalSelfAttention(units, heads, dropout,
                                             prefix="attn_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.ffn_1 = nn.Dense(hidden, flatten=False, in_units=units,
                                  prefix="ffn_1_")
            self.act = nn.Activation("gelu")
            self.ffn_2 = nn.Dense(units, flatten=False, in_units=hidden,
                                  prefix="ffn_2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def _ffn(self, x):
        h = tp.ffn(self.ln2(x), self.ffn_1, self.act, self.ffn_2)
        if self.dropout is not None:
            h = self.dropout(h)
        return x + h

    def forward_kv(self, F, x):
        a, k, v = self.attn.forward_kv(F, self.ln1(x))
        return self._ffn(x + a), k, v

    def hybrid_forward(self, F, x):
        return self.forward_kv(F, x)[0]

    def step_cached(self, F, x, k_cache, v_cache, start):
        a, k_cache, v_cache = self.attn.step_cached(F, self.ln1(x), k_cache,
                                                    v_cache, start)
        return self._ffn(x + a), k_cache, v_cache

    def step_cached_quant(self, F, x, k_cache, k_scale, v_cache, v_scale,
                          start):
        a, k_cache, k_scale, v_cache, v_scale = self.attn.step_cached_quant(
            F, self.ln1(x), k_cache, k_scale, v_cache, v_scale, start)
        return self._ffn(x + a), k_cache, k_scale, v_cache, v_scale


class GPTModel(HybridBlock):
    """tokens (B, T) int -> logits (B, T, V); the LM head is tied to the
    token embedding (one matmul against the table, the GPT-2 convention)."""

    def __init__(self, vocab_size=50257, units=768, num_layers=12,
                 num_heads=12, max_length=1024, hidden=None, dropout=0.1,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_len = max_length
        hidden = hidden or 4 * units
        with self.name_scope():
            self.word_embed = nn.Embedding(
                vocab_size, units, weight_initializer=init_mod.Normal(0.02),
                prefix="word_embed_")
            self.pos_embed = nn.Embedding(
                max_length, units, weight_initializer=init_mod.Normal(0.01),
                prefix="pos_embed_")
            self.drop = nn.Dropout(dropout) if dropout else None
            self.blocks = nn.HybridSequential(prefix="layers_")
            for i in range(num_layers):
                self.blocks.add(_GPTBlock(units, hidden, num_heads, dropout,
                                          prefix="layer%d_" % i))
            self.ln_f = nn.LayerNorm(in_channels=units, prefix="ln_f_")

    def _check_len(self, end):
        if end > self._max_len:
            raise ValueError(
                "sequence length %d exceeds max_length=%d (the positional "
                "embedding table)" % (end, self._max_len))

    def _embed(self, F, tokens, position0=0):
        T = tokens.shape[1]
        self._check_len(position0 + T)
        w = param_block(self.word_embed.weight)
        scope = tp.split_scope(lambda: [(w, tp.COLUMN)])
        x = self.word_embed(tokens) if scope is None else \
            scope.embed(F, tokens, w)
        pw = param_value(self.pos_embed.weight)
        x = x + F.slice_axis(pw, axis=0, begin=position0,
                             end=position0 + T)
        if self.drop is not None:
            x = self.drop(x)
        return x

    def _lm_logits(self, F, x):
        x = self.ln_f(x)
        blk = param_block(self.word_embed.weight)
        scope = tp.split_scope(lambda: [(blk, tp.COLUMN)])
        if scope is not None:  # column-parallel over the vocabulary
            return scope.vocab_logits(F, x, blk)
        w = param_value(self.word_embed.weight)  # (V, C), the tied head
        B, T, C = x.shape
        logits = F.dot(F.reshape(x, shape=(B * T, C)), F.transpose(w))
        return F.reshape(logits, shape=(B, T, -1))

    def hybrid_forward(self, F, tokens):
        x = self._embed(F, tokens)
        x = self.blocks(x)
        return self._lm_logits(F, x)

    # --------------------------------------------------- fixed-cap caches
    def decode_state_spec(self):
        """The cache contract for decode schedulers (serve.GenerativeServer):
        per layer, K/V buffers are (slots, heads, capacity, head_dim) of
        ``dtype`` on ``device``; the logits are ``vocab_size`` wide."""
        H = self.blocks[0].attn._heads
        w = self.word_embed.weight._tensor()
        return {"layers": len(self.blocks), "heads": H,
                "head_dim": self._units // H, "max_length": self._max_len,
                "vocab_size": w.shape[0], "dtype": w.dtype,
                "device": w.device}

    def init_cache(self, batch_size, capacity=None, dtype=None):
        """Fixed-capacity decode cache on the parameters' device: per layer
        ``(k, v, n)`` with k/v (B, H, capacity, D) zero buffers, written in
        place by ``prefill`` and ``step``, and ``n`` the live length.
        ``capacity`` defaults to ``max_length``, ``dtype`` to the parameter
        dtype (a bf16 model caches in bf16)."""
        cap = int(capacity if capacity is not None else self._max_len)
        self._check_len(cap)
        spec = self.decode_state_spec()
        dtype = spec["dtype"] if dtype is None else dtype
        shape = (batch_size, spec["heads"], cap, spec["head_dim"])
        return [(torch.zeros(shape, dtype=dtype, device=spec["device"]),
                 torch.zeros(shape, dtype=dtype, device=spec["device"]), 0)
                for _ in range(len(self.blocks))]

    def forward_collect_kv(self, F, tokens):
        """Forward pass that also returns every layer's K/V: the prefill
        primitive, one whole-prompt forward giving the logits and the
        complete cache contents."""
        x = self._embed(F, tokens)
        kvs = []
        for blk in self.blocks:
            x, k, v = blk.forward_kv(F, x)
            kvs.append((k, v))
        return self._lm_logits(F, x), kvs

    def prefill(self, tokens, caches):
        """Whole-prompt cache fill: one forward computes every position's
        K/V and writes them into the caches at offset 0. Returns
        (last-position logits (B, V), caches)."""
        B, T = tokens.shape
        self._check_len(T)
        with torch.no_grad():
            logits, kvs = self.forward_collect_kv(nd, tokens)
            new = [(nd.cache_write(kc, k, 0), nd.cache_write(vc, v, 0), T)
                   for (k, v), (kc, vc, _n) in zip(kvs, caches)]
        return logits[:, T - 1], new

    def step(self, tokens, caches, position):
        """One decode step: tokens (B, 1) -> logits (B, V), caches written
        in place at ``position`` of the capacity axis."""
        self._check_len(position + 1)
        with torch.no_grad():
            x = self.word_embed(tokens)
            pw = param_value(self.pos_embed.weight)
            x = x + nd.slice_axis(pw, axis=0, begin=position,
                                  end=position + 1)
            new_caches = []
            for blk, (ks, vs, _n) in zip(self.blocks, caches):
                x, ks, vs = blk.step_cached(nd, x, ks, vs, position)
                new_caches.append((ks, vs, position + 1))
            x = self.ln_f(x)
            w = param_value(self.word_embed.weight)
            logits = nd.dot(nd.reshape(x, shape=(x.shape[0], self._units)),
                            nd.transpose(w))
        return logits, new_caches

    def decode_step_fixed(self, F, tokens, k_caches, v_caches, valid_len):
        """Continuous-batching decode step over per-slot positions: tokens
        (B,) int, each slot's current input token; ``k_caches``/
        ``v_caches`` per-layer (B, H, capacity, D); ``valid_len`` (B,), the
        tokens each slot has cached (this token's position). Each slot's
        K/V are written in place at its own position and it attends to its
        own live prefix. Returns (logits (B, V), k_caches, v_caches)."""
        x = self.word_embed(F.reshape(tokens, shape=(-1, 1)))  # (B, 1, C)
        pw = param_value(self.pos_embed.weight)
        x = x + F.expand_dims(F.take(pw, valid_len), axis=1)
        nk, nv = [], []
        for blk, kc, vc in zip(self.blocks, k_caches, v_caches):
            x, kc, vc = blk.step_cached(F, x, kc, vc, valid_len)
            nk.append(kc)
            nv.append(vc)
        x = self.ln_f(x)
        w = param_value(self.word_embed.weight)
        logits = F.dot(F.reshape(x, shape=(x.shape[0], self._units)),
                       F.transpose(w))
        return logits, nk, nv

    def decode_step_fixed_quant(self, F, tokens, k_caches, k_scales,
                                v_caches, v_scales, valid_len):
        """:meth:`decode_step_fixed` over int8 KV pages with
        per-page-per-head scales (``k_scales``/``v_scales`` per layer
        (B, H, 1, 1) fp32), pages and scales written in place. Returns
        (logits, k_caches, k_scales, v_caches, v_scales)."""
        x = self.word_embed(F.reshape(tokens, shape=(-1, 1)))  # (B, 1, C)
        pw = param_value(self.pos_embed.weight)
        x = x + F.expand_dims(F.take(pw, valid_len), axis=1)
        for blk, kc, ks, vc, vs in zip(self.blocks, k_caches, k_scales,
                                       v_caches, v_scales):
            x = blk.step_cached_quant(F, x, kc, ks, vc, vs, valid_len)[0]
        x = self.ln_f(x)
        w = param_value(self.word_embed.weight)
        logits = F.dot(F.reshape(x, shape=(x.shape[0], self._units)),
                       F.transpose(w))
        return logits, k_caches, k_scales, v_caches, v_scales

    def _window_embed(self, F, tokens, valid_len):
        """(B, K) tokens embedded at positions ``valid_len + j``, row j."""
        K = tokens.shape[1]
        x = self.word_embed(tokens)                        # (B, K, C)
        pw = param_value(self.pos_embed.weight)
        pos = (F.reshape(valid_len, shape=(-1, 1))
               + F.reshape(F.arange(0, K, dtype="int32", ctx=tokens.device),
                           shape=(1, -1)))
        return x + F.take(pw, pos)

    def _window_logits(self, F, x):
        B, K, _ = x.shape
        x = self.ln_f(x)
        w = param_value(self.word_embed.weight)
        logits = F.dot(F.reshape(x, shape=(B * K, self._units)),
                       F.transpose(w))
        return F.reshape(logits, shape=(B, K, -1))

    def decode_step_speculative(self, F, tokens, k_caches, v_caches,
                                valid_len):
        """Speculative verify step: tokens (B, K) int, each slot's current
        input token followed by K - 1 drafted tokens, at positions
        ``valid_len .. valid_len + K - 1`` of that slot's page. Row j's K/V
        are written in place at ``valid_len + j`` and it attends to
        ``pos <= valid_len + j`` (the live prefix and the drafts before
        it). Returns (logits (B, K, V), k_caches, v_caches); logits[:, j]
        score the token at position ``valid_len + j + 1``. K = 1 is
        :meth:`decode_step_fixed` bit for bit. Rejected rows need no
        rollback: the caller advances ``valid_len`` past the accepted ones
        only, and the next window overwrites the rest."""
        x = self._window_embed(F, tokens, valid_len)
        for blk, kc, vc in zip(self.blocks, k_caches, v_caches):
            x = blk.step_cached(F, x, kc, vc, valid_len)[0]
        return self._window_logits(F, x), k_caches, v_caches

    def decode_step_speculative_quant(self, F, tokens, k_caches, k_scales,
                                      v_caches, v_scales, valid_len):
        """:meth:`decode_step_speculative` over int8 KV pages (the scales of
        :meth:`decode_step_fixed_quant`), pages and scales written in
        place. Returns (logits (B, K, V), k_caches, k_scales, v_caches,
        v_scales)."""
        x = self._window_embed(F, tokens, valid_len)
        for blk, kc, ks, vc, vs in zip(self.blocks, k_caches, k_scales,
                                       v_caches, v_scales):
            x = blk.step_cached_quant(F, x, kc, ks, vc, vs, valid_len)[0]
        return (self._window_logits(F, x), k_caches, k_scales, v_caches,
                v_scales)

    def generate(self, prompt, max_new_tokens=16, use_cache=True,
                 device=None):
        """Greedy decode: prompt (B, T0) int -> (B, T0 + max_new) int64, on
        ``device`` (default: the current CUDA device; the parameters must
        be there). The cached path prefills the whole prompt in one forward
        and keeps the argmax on the device between steps;
        ``use_cache=False`` runs the whole sequence again every step (the
        O(T^2) oracle the cached path is held against)."""
        device = resolve_device(device)
        if self.decode_state_spec()["device"] != device:
            raise ValueError("generate on %s, but the parameters are on %s"
                             % (device, self.decode_state_spec()["device"]))
        prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
        toks = prompt
        with torch.no_grad():
            if use_cache:
                B, T0 = prompt.shape
                self._check_len(T0 + max_new_tokens)
                cap = min(self._max_len, next_pow2(T0 + max_new_tokens))
                caches = self.init_cache(B, capacity=cap)
                logits, caches = self.prefill(prompt, caches)
                new = []
                for i in range(max_new_tokens):
                    nxt = nd.reshape(nd.argmax(logits, axis=-1),
                                     shape=(-1, 1)).to(prompt.dtype)
                    new.append(nxt)
                    if i + 1 < max_new_tokens:
                        logits, caches = self.step(nxt, caches, T0 + i)
                return nd.concat(toks, *new, dim=1)
            for _ in range(max_new_tokens):
                logits = self(toks)
                nxt = nd.reshape(nd.argmax(logits[:, -1], axis=-1),
                                 shape=(-1, 1)).to(prompt.dtype)
                toks = nd.concat(toks, nxt, dim=1)
        return toks


def gpt2_small(vocab_size=50257, **kwargs):
    """GPT-2 124M (12 x 768, 12 heads, context 1024)."""
    return GPTModel(vocab_size=vocab_size, units=768, num_layers=12,
                    num_heads=12, max_length=1024, **kwargs)


def gpt_nano(vocab_size=256, **kwargs):
    """Test-scale config."""
    kwargs.setdefault("dropout", 0.0)
    return GPTModel(vocab_size=vocab_size, units=64, num_layers=2,
                    num_heads=2, max_length=64, **kwargs)
