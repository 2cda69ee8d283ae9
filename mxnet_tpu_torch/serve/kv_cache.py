"""Paged KV-cache state for continuous-batching generative decode
(counterpart of ``mxnet_tpu/serve/kv_cache.py``).

Every in-flight request shares per-layer ``(slots, heads, capacity,
head_dim)`` buffers on the device. A request owns one slot page; its K/V are
written in place at its own ``valid`` position (``F.cache_write``) and
attention masks to the live prefix, so no buffer changes shape from one
decode step to the next and a step allocates no page.

Capacity is bucketed in powers of two: a request that needs more room than
the current bucket grows the buffers to the next one (zero-padded along the
time axis, one copy per layer), a rare migration. A migration replaces the
page tensors, so whatever holds their storage (a captured decode step) is
stale after it.

With ``quantize=True`` the pages are int8 with a per-page-per-head fp32
scale (``k_scale``/``v_scale``, (slots, H, 1, 1) per layer): about half the
bf16 bytes.

``PrefixCache`` is the prompt cache: a finished prefill is kept under its
prompt's tokens, and a later identical prompt copies the stored pages into
its slot instead of running the whole-prompt forward.
"""
from __future__ import annotations

import threading

import torch

from ..base import next_pow2, resolve_device

__all__ = ["CacheError", "PagedKVCache", "PrefixCache"]


class CacheError(RuntimeError):
    """Misuse of the paged cache (capacity or slot exhaustion)."""


class PagedKVCache:
    """Slot-paged fixed-capacity KV cache shared by all in-flight requests.

    Holds the decode loop's device state (per-layer K/V buffers and the
    per-slot ``valid`` lengths, int32) and the host's slot bookkeeping
    (which request owns which page). Prefill, prefix inject and the decode
    step write these tensors in place.

    Parameters
    ----------
    layers, heads, head_dim : int
        Per-layer buffer geometry (``model.decode_state_spec()``).
    slots : int
        Number of request pages: the padded decode batch size.
    max_capacity : int
        Ceiling of the time axis (the model's ``max_length``).
    dtype : torch.dtype
        K/V element dtype (the model's parameter dtype).
    device : torch.device, optional
        Where the buffers live: the current CUDA device unless another is
        given (``base.resolve_device``).
    quantize : bool
        Keep the pages as int8 with per-page-per-head fp32 scales
        (``k_scale``/``v_scale``); they quantize on write with a running-max
        scale (``F.quant_cache_write``) and dequantize on read in the decode
        step. The scales do not depend on the capacity: they are made with
        the first pages and carried, unchanged, through every migration.
    """

    def __init__(self, layers, heads, head_dim, slots, max_capacity,
                 dtype=torch.float32, device=None, quantize=False):
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.slots = int(slots)
        self.max_capacity = int(max_capacity)
        self.quantize = bool(quantize)
        self.dtype = torch.int8 if self.quantize else dtype
        # the element size an unquantized cache of the model's dtype would
        # take: the denominator of the bytes-saved ratio
        self._ref_itemsize = torch.empty((), dtype=dtype).element_size()
        self.device = resolve_device(device)
        self.capacity = 0
        self.k = None     # list[L] of (slots, H, capacity, D) tensors
        self.v = None
        self.k_scale = None  # list[L] of (slots, H, 1, 1) fp32 (quantized)
        self.v_scale = None
        self.valid = torch.zeros((self.slots,), dtype=torch.int32,
                                 device=self.device)
        self._free = list(range(self.slots))
        self._owner = [None] * self.slots
        self.migrations = 0  # capacity-bucket growths

    # ---------------------------------------------------------- capacity
    def capacity_bucket(self, need):
        """Pow2 capacity bucket for ``need`` tokens, clamped to the model's
        max length (positions beyond it have no embedding)."""
        if need > self.max_capacity:
            raise CacheError(
                "request needs %d cache positions but the model's "
                "max_length is %d" % (need, self.max_capacity))
        return min(self.max_capacity, next_pow2(need))

    def ensure_capacity(self, need):
        """Grow the buffers to the bucket that fits ``need`` (zero-padding
        the time axis). Returns True when the buffers were made or grown;
        they never shrink."""
        cap = self.capacity_bucket(need)
        if cap <= self.capacity and self.k is not None:
            return False
        shape = (self.slots, self.heads, cap, self.head_dim)

        def grown(old):
            new = torch.zeros(shape, dtype=self.dtype, device=self.device)
            if old is not None:
                new[:, :, :self.capacity].copy_(old)
            return new

        if self.k is None:
            self.k = [grown(None) for _ in range(self.layers)]
            self.v = [grown(None) for _ in range(self.layers)]
            if self.quantize:
                sshape = (self.slots, self.heads, 1, 1)
                self.k_scale = [torch.zeros(sshape, dtype=torch.float32,
                                            device=self.device)
                                for _ in range(self.layers)]
                self.v_scale = [torch.zeros(sshape, dtype=torch.float32,
                                            device=self.device)
                                for _ in range(self.layers)]
        else:
            self.k = [grown(k) for k in self.k]
            self.v = [grown(v) for v in self.v]
            self.migrations += 1
        self.capacity = cap
        return True

    # ------------------------------------------------------------- slots
    def acquire(self, owner):
        """Claim a free page for ``owner``; None when every page is taken
        (the request stays in the admission queue)."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        self._owner[slot] = owner
        return slot

    def release(self, slot):
        """Free a page. Host bookkeeping only: the next prefill overwrites
        the page from offset 0 and ``valid`` masks what is stale."""
        self._owner[slot] = None
        self._free.append(slot)

    def owner(self, slot):
        return self._owner[slot]

    @property
    def active_slots(self):
        return [i for i, o in enumerate(self._owner) if o is not None]

    @property
    def num_active(self):
        return self.slots - len(self._free)

    def active_mask(self):
        """(slots,) bool list of the pages in use: free slots sample
        nothing and their ``valid`` holds."""
        return [o is not None for o in self._owner]

    def nbytes(self):
        """Bytes of the K and V buffers (and their scales)."""
        if self.k is None:
            return 0
        bufs = self.k + self.v
        if self.quantize:
            bufs = bufs + self.k_scale + self.v_scale
        return sum(t.numel() * t.element_size() for t in bufs)

    def nbytes_unquantized(self, itemsize=None):
        """What the same geometry would take unquantized: ``itemsize``
        bytes an element (default: the model dtype's; 2 compares with a
        bf16 cache)."""
        if self.k is None:
            return 0
        elems = 2 * self.layers * self.slots * self.heads \
            * self.capacity * self.head_dim
        return elems * (self._ref_itemsize if itemsize is None else itemsize)


class _BoundedStore(dict):
    """A dict capped at ``cap`` entries; the oldest goes on insert."""

    def __init__(self, cap):
        super().__init__()
        self.cap = max(int(cap), 1)
        self._lock = threading.Lock()

    def __setitem__(self, key, value):
        with self._lock:
            if len(self) >= self.cap and key not in self:
                del self[next(iter(self))]
            dict.__setitem__(self, key, value)


class PrefixCache:
    """Prompt cache: the prompt's tokens -> its finished prefill state.

    Entries are ``(k_stack, v_stack, prompt_len, last_logits)`` with
    ``k_stack``/``v_stack`` of shape (layers, heads, padded_prompt_len,
    head_dim) in the cache's dtype (fp32 for a quantized cache: its pages
    are stored dequantized and requantized on inject, as in JAX). The
    server keeps them on its device (the JAX package keeps host copies);
    ``export_prefixes`` hands out CPU copies. A hit skips the whole-prompt
    forward: the stored pages are copied into the request's slot and the
    first token is sampled from the stored logits with the request's own
    seed and temperature.

    Bounded at ``cap`` prompts, the oldest entry out first.
    """

    def __init__(self, cap=32):
        self._store = _BoundedStore(cap)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(tokens):
        return tuple(int(t) for t in tokens)

    def get(self, tokens):
        ent = self._store.get(self.key(tokens))
        if ent is None:
            self.misses += 1
        else:
            self.hits += 1
        return ent

    def put(self, tokens, k_stack, v_stack, prompt_len, last_logits):
        self._store[self.key(tokens)] = (k_stack, v_stack, int(prompt_len),
                                         last_logits)

    def clear(self):
        self._store.clear()

    def __len__(self):
        return len(self._store)
