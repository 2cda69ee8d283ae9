"""Draft proposers for speculative decode (counterpart of
``mxnet_tpu/serve/speculative.py``).

A draft proposes ``spec_k - 1`` tokens a slot, the target scores the whole
window in one verify step (``decode_step_speculative``), and each slot
keeps the longest prefix of drafts that equals the target's own samples,
plus the sample at the first mismatch. For a deterministic draft the
proposal is one-hot, so "sample y from p, keep it where it equals the
draft, else emit y" is the rejection-sampling rule: greedy streams are the
plain greedy streams, and sampled streams take the same token at each
(seed, position) as plain decode.

Both drafts write their proposals into the server's static (slots,
spec_k - 1) ``_drafts`` buffer, which the verify program reads, so the
verify graph never sees a new address.

- ``NGramDraft``: a host-side order-n pattern matcher over each stream's
  own prompt and generated tokens; no device work besides the copy of its
  proposals into the buffer.
- ``ModelDraft``: a smaller model of the same decode protocol with its own
  ``PagedKVCache``, mirroring the target's slots and capacity. Its round is
  k greedy ``decode_step_fixed`` steps in one replayable program (its own
  ``StepPrograms``, keyed ``("draft", capacity)``), at the positions of the
  target's ``valid`` and from the target's current tokens; the k-th step
  only writes the last proposal's K/V (without it a full accept would leave
  a hole at ``valid + k - 1``). Rejected positions need no rollback: the
  shared ``valid`` masks them and the next round overwrites them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import next_pow2
from ..ops import functional as F
from .batcher import ServeError
from .kv_cache import PagedKVCache
from .step_graph import StepPrograms

__all__ = ["NGramDraft", "ModelDraft", "ngram_propose"]


def ngram_propose(history, n, order=3):
    """``n`` continuation tokens for one stream by suffix matching: the
    most recent earlier occurrence of the last ``m`` tokens (the longest
    ``m <= order`` first) proposes the token that followed it, and the
    proposal extends the history for the next one. With no match it repeats
    the last token: a wrong proposal costs accept rate, never correctness.
    (The JAX package's loop over start positions, with numpy comparisons
    over all of them at once: a prompt of 900 tokens costs microseconds.)"""
    h = np.asarray(history, np.int64).reshape(-1)
    out = []
    for _ in range(n):
        L, nxt = h.size, None
        for m in range(min(order, L - 1), 0, -1):
            # starts i in [0, L - m - 1] with h[i:i + m] == h[L - m:]
            hit = np.ones(L - m, bool)
            for j in range(m):
                hit &= h[j:L - m + j] == h[L - m + j]
            starts = np.flatnonzero(hit)
            if starts.size:
                nxt = int(h[starts[-1] + m])
                break
        if nxt is None:
            nxt = int(h[-1]) if L else 0
        out.append(nxt)
        h = np.append(h, nxt)
    return out


class NGramDraft:
    """Host-side n-gram draft over each stream's own history (prompt and
    generated tokens, which end with the slot's current input token)."""

    needs_history = True

    def __init__(self, order=3):
        self.order = int(order)
        self._server = None

    def bind(self, server):
        self._server = server

    def ensure_capacity(self):
        pass

    def join(self, slot, prompt):
        pass

    def warm(self, tp_buckets=()):
        pass

    def export_executables(self):
        """No programs: the proposals are made on the host."""
        return []

    def preload_executable(self, kind, tp, capacity):
        raise ServeError("NGramDraft has no programs (kind %r)" % kind)

    def propose(self, histories, k):
        """(slots, k - 1) int32 host proposals, copied into the server's
        drafts buffer; a row without history (a slot not decoding)
        proposes zeros, which the verify step masks."""
        srv = self._server
        out = np.zeros((len(histories), max(0, k - 1)), np.int32)
        if k > 1:
            for s, h in enumerate(histories):
                if h:
                    out[s] = ngram_propose(h, k - 1, self.order)
            srv._drafts.copy_(torch.from_numpy(out))
        return out


class ModelDraft:
    """Device draft: a smaller model of the same fixed-capacity decode
    protocol (``decode_state_spec``, ``forward_collect_kv``,
    ``decode_step_fixed``) with its own slot-paged KV cache. It must share
    the target's vocabulary and cover its ``max_length``."""

    needs_history = False

    def __init__(self, model):
        self.model = model
        self._server = None
        self.cache = None
        self._steps = None
        self._plist = None
        self._fills = set()   # (tp, capacity) of the fills run

    def bind(self, server):
        spec = self.model.decode_state_spec()
        if spec["max_length"] < server.cache.max_capacity:
            raise ServeError(
                "draft max_length=%d < target max_length=%d: the draft must "
                "cover every position it speculates at"
                % (spec["max_length"], server.cache.max_capacity))
        self._server = server
        self.model.collect_params().reset_device(server.device)
        self._plist = list(self.model.collect_params().values())
        self.cache = PagedKVCache(
            spec["layers"], spec["heads"], spec["head_dim"], server.slots,
            server.cache.max_capacity, dtype=spec["dtype"],
            device=server.device)
        self._steps = StepPrograms(server.device)

    def ensure_capacity(self):
        """Mirror the target cache's capacity bucket (the same pow2, so the
        draft migrates when the target does)."""
        self.cache.ensure_capacity(self._server.cache.capacity)

    def join(self, slot, prompt):
        """Fill the draft's page for a joining stream: the whole prompt
        through one forward at its pow2 bucket, run eagerly like the
        target's prefill. The draft keeps no prefix cache, so a target
        prefix hit or a chunked prefill still takes this fill. A slot's
        page needs no release: the next join's fill overwrites it, and
        ``valid`` masks what is stale."""
        self.ensure_capacity()
        n = int(prompt.size)
        tp = min(next_pow2(n), self.cache.capacity)
        padded = np.zeros((1, tp), np.int64)
        padded[0, :n] = prompt
        self._fill(slot, torch.from_numpy(padded).to(self._server.device))

    def _fill(self, slot, tokens):
        with torch.no_grad(), torch.profiler.record_function(
                "mxnet_tpu_torch::draft_fill"):
            _, kvs = self.model.forward_collect_kv(F, tokens)
            tp = tokens.shape[1]
            for kc, vc, (k, v) in zip(self.cache.k, self.cache.v, kvs):
                kc[slot, :, :tp].copy_(k[0])
                vc[slot, :, :tp].copy_(v[0])
        self._fills.add((tp, self.cache.capacity))

    # ------------------------------------------------------ the round
    def _state(self):
        srv = self._server
        return {"tok": srv._tok, "valid": srv.cache.valid,
                "drafts": srv._drafts, "k": self.cache.k,
                "v": self.cache.v}

    def _body(self, k):
        model = self.model

        def body(st):
            # k greedy steps: 0..k-2 propose d_1..d_{k-1}, step k-1
            # decodes d_{k-1} only to write its K/V at valid + k - 1
            x, valid, props = st["tok"], st["valid"], []
            for j in range(k):
                logits = model.decode_step_fixed(F, x, st["k"], st["v"],
                                                 valid + j)[0]
                x = torch.argmax(logits, dim=-1).to(torch.int32)
                if j < k - 1:
                    props.append(x)
            if props:
                st["drafts"].copy_(torch.stack(props, dim=1))
            return logits

        return body

    def propose(self, histories, k, eager=False):
        """One draft round into the server's drafts buffer, through the
        program of ``("draft", capacity)`` (``eager`` runs it without).
        Returns the last step's logits (slots, V), which the program's
        next replay overwrites."""
        with torch.no_grad(), torch.profiler.record_function(
                "mxnet_tpu_torch::draft_step"):
            return self._steps.run(
                ("draft", self.cache.capacity), self._body(k), self._state(),
                params=[p._tensor() for p in self._plist], eager=eager)

    # ----------------------------------------------- snapshot interface
    def export_executables(self):
        """The draft's programs for a snapshot manifest, under the JAX
        package's keys: its live round programs (``draftstep@c<capacity>``)
        and the prompt buckets its fill has served
        (``draftfill@t<bucket>c<capacity>``)."""
        out = [{"key": "draftstep@c%d" % key[1], "kind": "draftstep",
                "tp": 0, "capacity": int(key[1])}
               for key in self._steps.keys()]
        out += [{"key": "draftfill@t%dc%d" % (tp, cap), "kind": "draftfill",
                 "tp": int(tp), "capacity": int(cap)}
                for tp, cap in sorted(self._fills)]
        return out

    def preload_executable(self, kind, tp, capacity):
        """Make one snapshot entry's program before traffic: the round's
        program at ``capacity``, captured on slot 0 (a throwaway page, as
        in :meth:`warm`). A fill (``draftfill``) is eager and has nothing to
        make: it is only kept, so that the next snapshot lists it again."""
        if kind not in ("draftstep", "draftfill"):
            raise ServeError("unknown draft program kind %r" % kind)
        self.ensure_capacity()
        if self.cache.capacity != capacity:
            raise ServeError("a draft program at capacity %d, but the "
                             "draft's cache is at %d"
                             % (capacity, self.cache.capacity))
        if kind == "draftfill":
            self._fills.add((int(tp), int(capacity)))
        else:
            self.propose(None, self._server.spec_k)

    def warm(self, tp_buckets=()):
        """Before traffic: a fill at each prompt bucket and the round's
        program at the current capacity, on slot 0 (a throwaway page: the
        target's warmup holds it free)."""
        self.ensure_capacity()
        for tp in tp_buckets:
            self._fill(0, torch.zeros((1, int(tp)), dtype=torch.int64,
                                      device=self._server.device))
        self.propose(None, self._server.spec_k)
