"""GenerativeServer: token-level continuous batching over a paged KV cache
(counterpart of ``mxnet_tpu/serve/decoder.py``).

Instead of coalescing whole forward passes, the scheduler coalesces token
steps. Requests join and leave between steps by slot assignment into a
padded batch, and every step runs the whole in-flight batch at once: embed,
N transformer blocks (each writing its slots' K/V in place at their own
positions), logits and sampling, all on the device; the host reads back
one (slots,) token tensor a step.

The JAX package traces each step into one fused XLA program; here each
step is one CUDA graph, captured at the first step of its key (capacity,
greedy or sampled) and replayed after (``step_graph.py``).
Prefill is apart from decode: a joining request's whole prompt runs
through one forward at its pow2 prompt-length bucket, which writes its
cache page and gives the first token. An identical prompt hits the
``PrefixCache`` instead: the stored pages are copied into the slot and the
forward is skipped.

With ``quantize="int8"`` (or ``"e4m3"``/``"e5m2"``) the model's Dense
layers are quantized in place and the KV cache keeps int8 pages with
per-page-per-head scales (``decode_step_fixed_quant``); prefix entries keep
fp pages, dequantized on extract and requantized on inject, as in JAX.

Admission goes through ``DynamicBatcher``'s bounded queue, with its
priority classes and preemptive shedding; a request's deadline keeps
running while it waits for a slot and while it generates. Tokens stream
back through per-request iterators (``GenerationStream``).

    m = gpt2_small(); m.initialize(); amp.convert_hybrid_block(m)
    srv = GenerativeServer(m, slots=8, top_k=40)
    with srv:
        s = srv.submit([1, 2, 3], max_new_tokens=16, temperature=0.8)
        for tok in s:          # streams as decode steps complete
            print(tok)

Sampling keeps the JAX invariant: a request's sampled tokens depend only on
its seed and each token's position, never on the other requests in flight.
JAX folds the position into a threefry key; here the noise of a Gumbel-max
draw is a counter-based integer hash of (seed, position, token id), made on
the device with torch integer ops, so the streams are reproducible but not
the JAX package's.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import next_pow2, resolve_device
from ..checkpoint import validate_swap
from ..ops import functional as F
from ..ops.attention import quantize_page
from ..quantization import quantize_model
from .batcher import DynamicBatcher, ServeError, ServeTimeout
from .kv_cache import PagedKVCache, PrefixCache
from .metrics import GenerativeMetrics
from .step_graph import StepPrograms

__all__ = ["sample_tokens", "GenerationStream", "GenerativeServer"]

_DONE = object()
_M32 = 0xFFFFFFFF
# what the slice does not carry: option -> the ROADMAP.md item it waits for
_NOT_PORTED = {
    "draft": "A.8 (serve/speculative.py, speculative decode)",
    "prefill_chunk": "A.8 (chunked prefill)",
    "metrics_port": "A.16 (observability, the /metrics endpoint)",
}


def _mix32(h):
    """A 32-bit integer finalizer on int64 tensors holding values below
    2**32; the multipliers are below 2**31, so no product overflows."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def gumbel_noise(seeds, positions, vocab):
    """(S, vocab) float32 Gumbel noise, element (s, t) a function of
    (seeds[s], positions[s], t) only."""
    row = _mix32(_mix32(seeds.to(torch.int64) & _M32)
                 ^ (positions.to(torch.int64) & _M32))
    ids = torch.arange(vocab, device=row.device, dtype=torch.int64)
    h = _mix32(_mix32(row[:, None] ^ ids[None, :]) + 0x632BE5AB)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits, seeds, positions, temps, top_k, sampling=True):
    """Tokens (S,) int32 from logits (S, V): greedy argmax (the first index
    on ties) where ``temps[s] <= 0``, else a Gumbel-max draw from
    softmax(logits / temp) after a static top-k filter (0 = none), its
    noise a function of (seeds[s], positions[s]) only. ``sampling=False``
    says every temperature is 0 (the caller knows it on the host), and the
    draw is skipped, as ``lax.cond`` skips it in the JAX package."""
    lg = logits.to(torch.float32)
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    if not sampling:
        return greedy
    if top_k and top_k > 0:
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
    drawn = torch.argmax(scaled + gumbel_noise(seeds, positions,
                                               lg.shape[1]),
                         dim=-1).to(torch.int32)
    return torch.where(temps > 0, drawn, greedy)


class GenerationStream:
    """Per-request streaming handle: iterate generated token ids as decode
    steps complete, or block for the whole sequence with ``result()``.
    Failures in the queue (shed by priority admission, queue timeout) and
    mid-stream (deadline, server stop) surface as the typed serve
    exceptions on the consumer side."""

    def __init__(self, prompt, max_new_tokens, temperature, seed, priority):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ServeError("empty prompt")
        self.max_new_tokens = max(1, int(max_new_tokens))
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.priority = int(priority)
        self.tokens = []          # generated ids, in order
        self._q = queue.Queue()
        self._done = threading.Event()
        self._error = None
        self._admission = None    # the batcher's request handle

    # ------------------------------------------------------- producer side
    def _push(self, tok):
        self.tokens.append(int(tok))
        self._q.put(int(tok))

    def _finish(self, error=None):
        if self._done.is_set():
            return False
        self._error = error
        self._done.set()
        self._q.put(_DONE)
        return True

    # ------------------------------------------------------- consumer side
    def _check_admission(self):
        # the batcher fails a queued request (timeout sweep, preemptive
        # shed) on its own handle: mirror that failure onto the stream
        a = self._admission
        if a is not None and a.done() and a._error is not None:
            self._finish(a._error)

    def __iter__(self):
        while True:
            self._check_admission()
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is _DONE:
                break
            yield item
        if self._error is not None:
            raise self._error

    def done(self):
        return self._done.is_set()

    def result(self, timeout_s=None):
        """Block until generation completes; returns the generated token
        ids (prompt excluded). Raises the typed failure if the request was
        shed, timed out or failed."""
        deadline = (time.perf_counter() + timeout_s) if timeout_s else None
        while not self._done.wait(0.05):
            self._check_admission()
            if deadline is not None and time.perf_counter() > deadline:
                raise ServeTimeout("no completion within %.1fs" % timeout_s)
        if self._error is not None:
            raise self._error
        return list(self.tokens)


class GenerativeServer:
    """Continuous-batching generative decode scheduler.

    Parameters
    ----------
    model : block with the fixed-capacity decode protocol
        ``decode_state_spec()``, ``forward_collect_kv(F, tokens)`` and
        ``decode_step_fixed(F, tokens, k_caches, v_caches, valid_len)``
        (``decode_step_fixed_quant`` too when quantized;
        ``models.gpt.GPTModel``). Initialized; its parameters move to
        ``device`` and their dtype is the cache's.
    slots : int
        In-flight request pages: the padded decode batch. One step serves
        all of them; free slots are masked.
    top_k : int
        Static top-k filter of the sampler (0 = off). Temperature is per
        request (0 = greedy).
    eos_id : int or None
        Token id that completes a request early.
    max_wait_ms / max_queue / timeout_ms
        Admission queue knobs, as in ModelServer; ``max_queue`` counts
        requests.
    prefix_cache : bool
        Keep finished prefills under their prompt's tokens; a repeated
        prompt copies the stored pages instead of running the forward.
    device : str | torch.device | Context | None
        Where the model runs; None is the current CUDA device (and raises
        ``DeviceError`` without one).
    quantize : None or 'int8' / 'e4m3' / 'e5m2'
        Quantized serving: ``quantization.quantize_model`` quantizes the
        model's Dense layers in place, and the KV cache keeps int8 pages
        with per-page-per-head scales. fp8 modes need
        ``quantization.fp8_supported``.
    draft, prefill_chunk, metrics_port
        Not ported yet: any value but None raises ``ServeError`` naming
        the ROADMAP.md item.
    """

    def __init__(self, model, slots=8, top_k=0, eos_id=None,
                 max_wait_ms=1.0, max_queue=64, timeout_ms=30000.0,
                 prefix_cache=True, name=None, device=None,
                 metrics_port=None, quantize=None, draft=None,
                 prefill_chunk=None):
        for option, value in (("draft", draft),
                              ("prefill_chunk", prefill_chunk),
                              ("metrics_port", metrics_port)):
            if value is not None:
                raise ServeError("%s= is not ported yet (ROADMAP.md %s)"
                                 % (option, _NOT_PORTED[option]))
        self._quantize = quantize or None
        if self._quantize is not None \
                and not hasattr(model, "decode_step_fixed_quant"):
            raise ServeError("quantize=%r: model %s has no "
                             "decode_step_fixed_quant (the int8 paged-KV "
                             "decode protocol of models.gpt.GPTModel)"
                             % (quantize, type(model).__name__))
        self.device = resolve_device(device)
        model.collect_params().reset_device(self.device)
        if self._quantize is not None:
            # before anything reads the parameter list; a quantized model
            # keeps its quantized layers
            quantize_model(model, mode=self._quantize)
        spec = model.decode_state_spec()
        self.model = model
        self.name = name or ("generate:%s" % type(model).__name__.lower())
        self.slots = int(slots)
        self.top_k = int(top_k)
        self.eos_id = eos_id
        self.timeout_ms = float(timeout_ms)
        # a dispatch reads the weights under this lock and swap_parameters
        # writes them under it: a step sees all-old or all-new weights
        self._params_lock = threading.Lock()
        self._swap_epoch = 0
        self._plist = list(model.collect_params().values())
        self.cache = PagedKVCache(
            spec["layers"], spec["heads"], spec["head_dim"], self.slots,
            spec["max_length"], dtype=spec["dtype"], device=self.device,
            quantize=self._quantize is not None)
        self.prefix = PrefixCache() if prefix_cache else None
        self.metrics = GenerativeMetrics(self.name)
        # device state beside the cache, static buffers the step programs
        # read and write in place: each slot's current input token (the
        # step writes the next one there), and the sampling controls (host
        # copies, copied in when they change)
        dev = self.device
        self._tok = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        self._seeds = np.zeros((self.slots,), np.int64)
        self._temps = np.zeros((self.slots,), np.float32)
        self._dev_seeds = torch.zeros((self.slots,), dtype=torch.int64,
                                      device=dev)
        self._dev_temps = torch.zeros((self.slots,), dtype=torch.float32,
                                      device=dev)
        self._dev_active = torch.zeros((self.slots,), dtype=torch.bool,
                                       device=dev)
        self._dev_active_i32 = torch.zeros((self.slots,), dtype=torch.int32,
                                           device=dev)
        self._sampling = False    # any live slot with a temperature > 0
        self._ctl_dirty = True
        self._steps = StepPrograms(dev)
        self._warm = False
        # host bookkeeping per slot
        self._slot_req = [None] * self.slots   # admission handle (deadline)
        self._remaining = [0] * self.slots     # tokens left to generate
        self._join_q = deque()
        self._join_cond = threading.Condition()
        self._batcher = DynamicBatcher(
            self._admit_batch, max_batch=self.slots, max_wait_ms=max_wait_ms,
            max_queue=max_queue, num_dispatchers=1, metrics=self.metrics)
        self._loop_thread = None
        self._stop_flag = False

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the scheduler loop (admit, one decode step, stream tokens,
        over and over) on a background thread. Tests drive the same tick
        synchronously with :meth:`step`."""
        self._batcher.start()
        if self._loop_thread is None or not self._loop_thread.is_alive():
            self._stop_flag = False
            self._loop_thread = threading.Thread(
                target=self._loop, daemon=True, name="serve-decode")
            self._loop_thread.start()
        return self

    def stop(self, timeout_s=5.0, reason="server stopped"):
        """Stop the loop, reject everything queued or in flight with
        ``ServeError(reason)``, and tear the dispatcher down. Slots are
        retired only after the loop has joined, so the slot tables keep one
        writer. Idempotent; start() after stop() starts afresh."""
        self._stop_flag = True
        with self._join_cond:
            self._join_cond.notify_all()
        loop, self._loop_thread = self._loop_thread, None
        if loop is not None:
            loop.join(timeout=timeout_s)
        self._batcher.stop(drain=False, timeout_s=timeout_s, reason=reason)
        for slot in self.cache.active_slots:
            self._retire(slot, error=ServeError(reason))
        with self._join_cond:
            pending = list(self._join_q)
            self._join_q.clear()
        for req in pending:
            err = ServeError(reason)
            if req.finish(error=err):
                req.inputs._finish(err)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()

    # ------------------------------------------------------------ hot swap
    def swap_parameters(self, params_file):
        """Weight hot-swap: the file is checked against the live model
        (``checkpoint.validate_swap``: missing, extra, reshaped or
        another dtype raises ``SwapError`` and the old weights keep
        serving), copied to the device, then copied into the live
        parameter tensors in place under the dispatch lock, so the
        captured step programs, which hold those tensors' storage, serve
        the new weights. The prefix cache is flushed, since its pages came
        from the old weights; streams in flight keep the pages they have
        and finish. Returns the new swap epoch."""
        picked = validate_swap(self.model, params_file)
        params = self.model._collect_params_with_prefix()
        staged = {n: a.to(self.device) for n, a in picked.items()}
        with self._params_lock:
            for name, arr in staged.items():
                params[name].copy_data(arr)
            self._swap_epoch += 1
            if self.prefix is not None:
                self.prefix.clear()
        return self._swap_epoch

    # ------------------------------------------------------------ gauges
    def tokens_in_flight(self):
        """Tokens still owed to the live slots."""
        return int(sum(self._remaining[s] for s in self.cache.active_slots))

    def health(self):
        """Cheap liveness payload: warm flag and load gauges."""
        tif = self.tokens_in_flight()
        self.metrics.record_tokens_in_flight(tif)
        return {"warm": self._warm,
                "running": (self._loop_thread is not None
                            and self._loop_thread.is_alive()),
                "kind": "generative",
                "queue_depth": self._batcher.queue_depth(),
                "in_flight": self.cache.num_active,
                "tokens_in_flight": tif,
                "swap_epoch": self._swap_epoch}

    def export_prefixes(self):
        """The prefix cache as CPU copies, to move to another server:
        [(tokens int32, k_stack, v_stack, prompt_len, last_logits)]."""
        if self.prefix is None:
            return []
        entries = list(self.prefix._store.items())
        return [(np.asarray(key, np.int32), k.cpu(), v.cpu(), int(plen),
                 last.cpu()) for key, (k, v, plen, last) in entries]

    def import_prefixes(self, entries):
        """Adopt entries :meth:`export_prefixes` gave; the next hit copies
        them into its slot. Returns how many were taken."""
        if self.prefix is None:
            return 0
        n = 0
        for tokens, k_stack, v_stack, plen, last in entries:
            self.prefix.put(tokens, k_stack, v_stack, plen, last)
            n += 1
        return n

    # ------------------------------------------------------------ admission
    def submit(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
               priority=0, timeout_ms=None):
        """Enqueue one generation request; returns a ``GenerationStream``.
        A request longer than the model's max_length raises ``CacheError``
        here. A full admission queue sheds with ``ServerBusy`` (unless
        ``priority`` preempts a lower class, see ``DynamicBatcher.submit``);
        the deadline covers the queue wait, prefill and generation."""
        stream = GenerationStream(prompt, max_new_tokens, temperature, seed,
                                  priority)
        tmo = self.timeout_ms if timeout_ms is None else float(timeout_ms)
        self.cache.capacity_bucket(stream.prompt.size + stream.max_new_tokens)
        self._batcher.start()
        req = self._batcher.submit(stream, 1, timeout_ms=tmo,
                                   priority=priority)
        stream._admission = req
        return stream

    def generate(self, prompt, **kwargs):
        """Synchronous: submit and wait; returns the generated ids."""
        tmo = kwargs.get("timeout_ms", self.timeout_ms)
        return self.submit(prompt, **kwargs).result(timeout_s=tmo / 1e3 + 5.0)

    def _admit_batch(self, requests, rows):
        """Batcher dispatch callback: hand admitted requests to the decode
        loop. Blocks while the handover buffer is full, so saturation backs
        up into the bounded admission queue (where shedding and timeouts
        live)."""
        for req in requests:
            with self._join_cond:
                while (not self._stop_flag
                       and len(self._join_q) >= self.slots):
                    self._join_cond.wait(0.05)
                    if req.expired():
                        break
                if self._stop_flag:
                    err = ServeError("server stopped")
                    if req.finish(error=err):
                        req.inputs._finish(err)
                    continue
                self._join_q.append(req)

    # ------------------------------------------------------------ scheduler
    def step(self):
        """One scheduler tick: admit pending joins (a prefill or a prefix
        inject each), then one decode step for the whole in-flight batch,
        and deliver each live slot's token. Returns the number of slots
        that advanced (0 = idle)."""
        self._admit_pending()
        return self._decode_once()

    def _loop(self):
        while not self._stop_flag:
            try:
                idle = self.step() == 0
            except Exception as e:  # keep serving: fail the slots in flight
                self.metrics.record_error()
                for slot in self.cache.active_slots:
                    self._retire(slot, error=e)
                idle = False
            if idle:
                time.sleep(0.001)

    # ------------------------------------------------------------- joining
    def _admit_pending(self):
        while self.cache._free:
            with self._join_cond:
                req = self._join_q.popleft() if self._join_q else None
                self._join_cond.notify_all()
            if req is None:
                return
            stream = req.inputs
            now = time.perf_counter()
            if req.done():      # the queue sweep got it first
                continue
            if req.expired(now):
                err = ServeTimeout("timed out after %.1fms waiting for a "
                                   "slot" % ((now - req.t_submit) * 1e3))
                if req.finish(error=err):
                    stream._finish(err)
                    self.metrics.record_timeout()
                continue
            try:
                self._join(req, stream)
            except Exception as e:   # cache exhaustion, model error
                self.metrics.record_error()
                if req.finish(error=e):
                    stream._finish(e)

    def _sample_one(self, last, seed, position, temperature):
        """The first token of a slot, from its prompt's last logits (V,),
        sampled at ``position`` (the prompt length)."""
        dev = self.device
        return sample_tokens(
            last[None], torch.tensor([seed], device=dev),
            torch.tensor([position], device=dev),
            torch.tensor([temperature], dtype=torch.float32, device=dev),
            self.top_k, sampling=temperature > 0)

    def _prefill(self, slot, prompt, seed, temperature):
        """The whole prompt through one forward at its pow2 bucket ``tp``:
        its K/V into the slot's page, ``valid[slot]`` to its length and the
        first token into ``_tok[slot]``. Returns (first token (1,) on the
        device, the last position's logits (V,), tp)."""
        n = int(prompt.size)
        tp = min(next_pow2(n), self.cache.capacity)
        padded = np.zeros((1, tp), np.int64)
        padded[0, :n] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        with self._params_lock, torch.no_grad(), \
                torch.profiler.record_function("mxnet_tpu_torch::prefill"):
            logits, kvs = self.model.forward_collect_kv(F, tokens)
            self._write_pages(slot, [k for k, _ in kvs],
                              [v for _, v in kvs], n, tp)
            self.cache.valid[slot] = n
            last = logits[0, n - 1]
            first = self._sample_one(last, seed, n, temperature)
            self._tok[slot] = first[0]
        return first, last, tp

    def _inject(self, slot, hit, seed, temperature):
        """A prefix hit: the stored pages into the slot's page (copies, no
        forward), ``valid[slot]`` to the prompt length, and the first token
        sampled from the stored logits. Returns the first token (1,)."""
        k_stack, v_stack, plen, last = hit
        n = min(k_stack.shape[2], self.cache.capacity)
        with torch.no_grad(), torch.profiler.record_function(
                "mxnet_tpu_torch::prefix_inject"):
            dev = self.device
            self._write_pages(slot,
                              [ks[None, :, :n].to(dev) for ks in k_stack],
                              [vs[None, :, :n].to(dev) for vs in v_stack],
                              plen, n)
            self.cache.valid[slot] = plen
            first = self._sample_one(last.to(self.device), seed, plen,
                                     temperature)
            self._tok[slot] = first[0]
        return first

    def _write_pages(self, slot, ks, vs, plen, tp):
        """Per layer, K and V (1, H, tp, D) into the slot's first ``tp``
        positions; quantized, as int8 with a fresh per-head scale from the
        first ``plen`` positions."""
        c = self.cache
        if not c.quantize:
            for kc, vc, k, v in zip(c.k, c.v, ks, vs):
                kc[slot, :, :tp].copy_(k[0])
                vc[slot, :, :tp].copy_(v[0])
            return
        for pages, scales, new in ((c.k, c.k_scale, ks), (c.v, c.v_scale, vs)):
            for page, scale, a in zip(pages, scales, new):
                q, sc = quantize_page(a, plen)
                page[slot, :, :tp].copy_(q[0])
                scale[slot].copy_(sc[0])

    def _extract(self, slot, tp):
        """Copies of the slot's first ``tp`` positions, (L, H, tp, D)
        each for K and V; a quantized cache's pages dequantized to fp32
        (inject requantizes them exactly: the largest element gives the
        same scale again)."""
        c = self.cache

        def page(p, scales, i):
            if not c.quantize:
                return p[slot, :, :tp]
            return p[slot, :, :tp].to(torch.float32) * scales[i][slot]

        with torch.no_grad():
            return (torch.stack([page(p, c.k_scale, i)
                                 for i, p in enumerate(c.k)]),
                    torch.stack([page(p, c.v_scale, i)
                                 for i, p in enumerate(c.v)]))

    def _join(self, req, stream):
        n = int(stream.prompt.size)
        self.cache.ensure_capacity(n + stream.max_new_tokens)
        slot = self.cache.acquire(stream)
        try:
            hit = self.prefix.get(stream.prompt) \
                if self.prefix is not None else None
            if hit is not None:
                first = self._inject(slot, hit, stream.seed,
                                     stream.temperature)
            else:
                epoch = self._swap_epoch
                first, last, tp = self._prefill(slot, stream.prompt,
                                                stream.seed,
                                                stream.temperature)
                self.metrics.record_prefill()
                if self.prefix is not None:
                    ks, vs = self._extract(slot, tp)
                    with self._params_lock:
                        # pages of weights a swap has replaced since are
                        # not kept
                        if self._swap_epoch == epoch:
                            self.prefix.put(stream.prompt, ks, vs, n,
                                            last.clone())
            first = int(first[0])   # the first token's host readback
        except BaseException:
            self.cache.release(slot)
            raise
        self._warm = True
        now = time.perf_counter()
        if not req.finish(result=stream):
            # timed out in the instant admission landed: roll back
            self.cache.release(slot)
            return
        self._slot_req[slot] = req
        self._remaining[slot] = stream.max_new_tokens
        self._seeds[slot] = stream.seed
        self._temps[slot] = stream.temperature
        self._ctl_dirty = True
        self.metrics.record_first_token((now - req.t_submit) * 1e3, n)
        self._deliver(slot, first)

    # ------------------------------------------------------------- decoding
    def _upload_controls(self):
        """The host's slot controls into the static device buffers, in
        place (outside any step program)."""
        self._dev_active.copy_(torch.tensor(self.cache.active_mask()))
        self._dev_active_i32.copy_(self._dev_active)
        self._dev_seeds.copy_(torch.from_numpy(self._seeds))
        self._dev_temps.copy_(torch.from_numpy(self._temps))
        self._sampling = bool((self._temps > 0).any())
        self._ctl_dirty = False

    def _step_state(self):
        """The tensors a decode step reads and writes in place."""
        c = self.cache
        state = {"tok": self._tok, "valid": c.valid,
                 "active": self._dev_active,
                 "active_i32": self._dev_active_i32,
                 "seeds": self._dev_seeds, "temps": self._dev_temps,
                 "k": c.k, "v": c.v}
        if c.quantize:
            state.update(k_scale=c.k_scale, v_scale=c.v_scale)
        return state

    def _step_body(self, sampling):
        """The decode step over a state dict (:meth:`_step_state`): every
        slot writes its K/V at its position and samples its next token
        into ``tok``; only live slots advance ``valid``, so a free slot's
        page holds what it held. Returns the logits (slots, V)."""
        model, top_k = self.model, self.top_k

        def body(st):
            valid = st["valid"]
            if "k_scale" in st:
                logits = model.decode_step_fixed_quant(
                    F, st["tok"], st["k"], st["k_scale"], st["v"],
                    st["v_scale"], valid)[0]
            else:
                logits = model.decode_step_fixed(F, st["tok"], st["k"],
                                                 st["v"], valid)[0]
            # the generated token's position is valid + 1 (prefill used the
            # prompt length for the first token)
            nxt = sample_tokens(logits, st["seeds"], valid + 1, st["temps"],
                                top_k, sampling)
            valid += st["active_i32"]
            st["tok"].copy_(torch.where(st["active"], nxt, 0))
            return logits

        return body

    def _run_step(self, eager=False):
        """One decode step for every slot through the step program of its
        key (capacity, sampling); ``eager`` runs the same step
        without the program (a check compares the two). Returns the logits
        (slots, V); the next tokens are in ``_tok``."""
        if self._ctl_dirty:
            self._upload_controls()
        key = (self.cache.capacity, self._sampling)
        with self._params_lock, torch.no_grad(), \
                torch.profiler.record_function(
                    "mxnet_tpu_torch::decode_step"):
            return self._steps.run(
                key, self._step_body(self._sampling), self._step_state(),
                params=[p.data() for p in self._plist], eager=eager)

    def _decode_once(self):
        active = self.cache.active_mask()
        n_active = sum(active)
        if n_active == 0:
            return 0
        t0 = time.perf_counter()
        self._run_step()
        nxt_host = self._tok.cpu().numpy()   # the one host readback a step
        dt = time.perf_counter() - t0
        self._warm = True
        self.metrics.record_step(dt, n_active, n_active, self.slots)
        now = time.perf_counter()
        for slot in np.flatnonzero(active):
            self._deliver(int(slot), int(nxt_host[slot]), now)
        return n_active

    def _deliver(self, slot, tok, now=None):
        """Hand one token to a slot's stream; retire the request when it
        completes (EOS or budget) or has passed its deadline."""
        stream = self.cache.owner(slot)
        req = self._slot_req[slot]
        stream._push(tok)
        self._remaining[slot] -= 1
        if (self.eos_id is not None and tok == self.eos_id) \
                or self._remaining[slot] <= 0:
            self._retire(slot)
            return
        if req is not None and req.expired(now):
            self._retire(slot, error=ServeTimeout(
                "deadline passed mid-generation (after %d tokens)"
                % len(stream.tokens)))
            self.metrics.record_timeout()

    def _retire(self, slot, error=None):
        stream = self.cache.owner(slot)
        req = self._slot_req[slot]
        if stream is not None:
            stream._finish(error)
            if error is None and req is not None:
                self.metrics.record_latency(
                    (time.perf_counter() - req.t_submit) * 1e3)
        self._slot_req[slot] = None
        self._temps[slot] = 0.0
        self._ctl_dirty = True
        self.cache.release(slot)
        with self._join_cond:
            self._join_cond.notify_all()

    # ------------------------------------------------------------ warmup
    def warmup(self, prompt_buckets=(), max_tokens=None):
        """Run each path once before traffic (and before :meth:`start`:
        it drives the slots itself), on throwaway slots: a prefill
        (and with the prefix cache, its page extract and inject) for each
        prompt-length bucket, and a greedy and a sampled decode step, which
        capture the two step programs at the capacity that fits
        ``max_tokens``."""
        need = max(int(max_tokens or 0),
                   max([int(b) for b in prompt_buckets], default=1) + 1)
        self.cache.ensure_capacity(need)
        for b in prompt_buckets:
            dummy = GenerationStream([1] * int(b), 1, 0.0, 0, 0)
            slot = self.cache.acquire(dummy)
            if slot is None:
                break
            _, last, tp = self._prefill(slot, np.zeros(int(b), np.int32), 0,
                                        0.0)
            if self.prefix is not None:
                ks, vs = self._extract(slot, tp)
                self._inject(slot, (ks, vs, int(b), last), 0, 0.0)
            self.cache.release(slot)
        dummy = GenerationStream([1], 2, 0.0, 0, 0)
        slot = self.cache.acquire(dummy)
        if slot is not None:
            self._remaining[slot] = 2
            for temperature in (0.0, 1.0):
                self._temps[slot] = temperature
                self._ctl_dirty = True
                self._decode_once()
            if self.cache.owner(slot) is dummy:
                self._retire(slot)
        return self

    # ------------------------------------------------------------- stats
    def stats(self):
        """Generative counters on top of the queue and latency metrics."""
        snap = self.metrics.snapshot()
        snap.update(
            slots=self.slots,
            capacity=self.cache.capacity,
            in_flight=self.cache.num_active,
            tokens_in_flight=self.tokens_in_flight(),
            swap_epoch=self._swap_epoch,
            cache_migrations=self.cache.migrations,
            prefix_hits=self.prefix.hits if self.prefix is not None else None,
            prefix_misses=(self.prefix.misses if self.prefix is not None
                           else None),
            prefix_entries=(len(self.prefix) if self.prefix is not None
                            else None),
            kv_cache_bytes=self.cache.nbytes(),
            kv_cache_bytes_unquantized=self.cache.nbytes_unquantized(),
            quantize=self._quantize,
            step_programs=len(self._steps.keys()),
            step_captures=self._steps.captures,
            step_replays=self._steps.replays,
            device=str(self.device),
            running=(self._loop_thread is not None
                     and self._loop_thread.is_alive()),
        )
        return snap
