"""GenerativeServer: token-level continuous batching over a paged KV cache
(counterpart of ``mxnet_tpu/serve/decoder.py``).

Instead of coalescing whole forward passes, the scheduler coalesces token
steps. Requests join and leave between steps by slot assignment into a
padded batch, and every step runs the whole in-flight batch at once: embed,
N transformer blocks (each writing its slots' K/V in place at their own
positions), logits and sampling, all on the device; the host reads back
one (slots,) token tensor a step.

The JAX package traces each step into one fused XLA program; here each
step is one CUDA graph, captured at the first step of its key (the kind of
step, its shape, greedy or sampled) and replayed after
(``step_graph.py``). Prefill is apart from decode: a joining request's
whole prompt runs through one forward at its pow2 prompt-length bucket,
which writes its cache page and gives the first token. An identical prompt
hits the ``PrefixCache`` instead: the stored pages are copied into the slot
and the forward is skipped.

Speculative decode (``draft=``): each tick a draft (``NGramDraft`` on the
host, or ``ModelDraft``, a smaller model, in one program of its own)
proposes ``spec_k - 1`` tokens a slot into a static drafts buffer, and one
verify step (``decode_step_speculative``) scores every slot's window of
the current token and its drafts; each slot emits its accepted drafts and
the target's sample at the first mismatch, 1 to ``spec_k`` tokens, read
back with one copy. Chunked prefill (``prefill_chunk=``): a prompt longer
than the chunk owns its slot at once but fills its page one chunk a tick
through the same wide step, before that tick's decode step, so the streams
in flight wait for one chunk at most, never for a whole prompt.

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

from .. import profiler
from ..base import next_pow2, resolve_device
from ..observability import MetricsHTTPServer, new_trace
from ..checkpoint import validate_swap
from ..ops import functional as F
from ..ops.attention import quantize_page
from ..quantization import quantize_model
from .batcher import DynamicBatcher, ServeError, ServeTimeout
from .kv_cache import PagedKVCache, PrefixCache
from .metrics import GenerativeMetrics
from .speculative import ModelDraft
from .step_graph import StepPrograms

__all__ = ["sample_tokens", "GenerationStream", "GenerativeServer"]

_DONE = object()
_M32 = 0xFFFFFFFF


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
        # observability.RequestTrace: queue, pad and dispatch spans at the
        # join, then the decode steps, one aggregate span at retire
        self.trace = None
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
    draft : None, a draft object or a model
        Speculative decode: ``serve.NGramDraft()`` (host-side pattern
        matcher), ``serve.ModelDraft(m)`` or a bare model (wrapped in
        ``ModelDraft``; it must cover the target's ``max_length``). Each
        tick the draft proposes ``spec_k - 1`` tokens a slot and one verify
        step scores them all; greedy streams are the plain greedy streams,
        sampled streams take the same token at each (seed, position) as
        plain decode. The model needs ``decode_step_speculative``
        (``decode_step_speculative_quant`` too when quantized).
    spec_k : int
        The verify window a slot (tokens scored a verify step) when a
        ``draft`` is set; 1 is plain decode through the verify step.
    prefill_chunk : None or int
        Chunked prefill: a prompt longer than ``next_pow2(max(8, n))``
        tokens fills its page one chunk of that many positions a tick,
        before the tick's decode step, and bypasses the prefix cache. At
        least ``spec_k`` when a draft is set (a verify window of a slot
        waiting for its chunks must land where the next chunk writes).
    metrics_port : int or None
        Serve the observability endpoint (``/metrics``, ``/snapshot``,
        ``/health``) on this loopback port while the server runs (0: a free
        one, read back from ``srv.metrics_http.port``).
    """

    def __init__(self, model, slots=8, top_k=0, eos_id=None,
                 max_wait_ms=1.0, max_queue=64, timeout_ms=30000.0,
                 prefix_cache=True, name=None, device=None,
                 metrics_port=None, quantize=None, draft=None, spec_k=4,
                 prefill_chunk=None):
        self._quantize = quantize or None
        if self._quantize is not None \
                and not hasattr(model, "decode_step_fixed_quant"):
            raise ServeError("quantize=%r: model %s has no "
                             "decode_step_fixed_quant (the int8 paged-KV "
                             "decode protocol of models.gpt.GPTModel)"
                             % (quantize, type(model).__name__))
        if draft is not None and not hasattr(draft, "propose"):
            draft = ModelDraft(draft)   # a bare model
        wide = "decode_step_speculative" + (
            "_quant" if self._quantize is not None else "")
        for option, value in (("draft", draft),
                              ("prefill_chunk", prefill_chunk)):
            if value is not None and not hasattr(model, wide):
                raise ServeError("%s=: model %s has no %s (the wide-window "
                                 "step of models.gpt.GPTModel)"
                                 % (option, type(model).__name__, wide))
        self.spec_k = max(1, int(spec_k))
        self._prefill_chunk = None
        if prefill_chunk is not None:
            self._prefill_chunk = next_pow2(max(8, int(prefill_chunk)))
            if draft is not None and self._prefill_chunk < self.spec_k:
                raise ServeError(
                    "prefill_chunk=%d < spec_k=%d: a verify window must fit "
                    "behind the chunk frontier"
                    % (self._prefill_chunk, self.spec_k))
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
        # speculative decode: the drafts a verify step reads (the draft
        # writes them in place) and its output, each slot's emitted tokens
        # with their count in the last column (one readback a round); a
        # window writes K/V through valid + spec_k - 1, a margin the
        # capacity keeps past the generation budget
        self._draft = draft
        self._spec_margin = self.spec_k - 1 if draft is not None else 0
        self._drafts = torch.zeros((self.slots, self.spec_k - 1),
                                   dtype=torch.int32, device=dev)
        self._emit = torch.zeros((self.slots, self.spec_k + 1),
                                 dtype=torch.int32, device=dev)
        # chunked prefill: slot -> job, in arrival order; a slot in the
        # middle of its chunks is owned but masked out of decode. A chunk
        # step reads its tokens and (slot, pos0, prompt length, seed,
        # temperature) from these buffers
        self._chunk_jobs = {}
        tc = self._prefill_chunk or 1
        self._chunk_tokens = torch.zeros((1, tc), dtype=torch.int64,
                                         device=dev)
        self._chunk_ctl = torch.zeros((4,), dtype=torch.int64, device=dev)
        self._chunk_temp = torch.zeros((1,), dtype=torch.float32,
                                       device=dev)
        if draft is not None:
            draft.bind(self)
        # the eager paths' buckets served or listed by a loaded snapshot,
        # (kind, tp, capacity): what a snapshot lists beside the step
        # programs; and the step programs a snapshot's load captured
        self._eager_served = set()
        self._snapshot_programs = 0
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
        self._metrics_port = metrics_port
        self.metrics_http = None
        from . import _register

        _register(self)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Start the scheduler loop (admit, one decode step, stream tokens,
        over and over) on a background thread. Tests drive the same tick
        synchronously with :meth:`step`."""
        self._batcher.start()
        if self._metrics_port is not None and self.metrics_http is None:
            self.metrics_http = MetricsHTTPServer(self._metrics_port,
                                                  health_fn=self.health)
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
        if self.metrics_http is not None:
            self.metrics_http.close()
            self.metrics_http = None

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
        # an impossible request fails here, not after a queue wait
        self.cache.capacity_bucket(stream.prompt.size + stream.max_new_tokens
                                   + self._spec_margin)
        self._batcher.start()
        stream.trace = new_trace(self.name)
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
        inject each, or a chunk job for a long prompt), at most one
        prefill chunk, then one decode (or verify) step for the whole
        in-flight batch, and deliver each live slot's tokens. Returns the
        number of slots that advanced plus the chunks run (0 = idle)."""
        self._admit_pending()
        chunked = self._chunk_once()
        return self._decode_once() + chunked

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
        with self._params_lock, torch.no_grad(), profiler.decode_scope(
                "prefill%d" % tp, self.slots, 1,
                torch_name="mxnet_tpu_torch::prefill"):
            logits, kvs = self.model.forward_collect_kv(F, tokens)
            self._write_pages(slot, [k for k, _ in kvs],
                              [v for _, v in kvs], n, tp)
            self.cache.valid[slot] = n
            last = logits[0, n - 1]
            first = self._sample_one(last, seed, n, temperature)
            self._tok[slot] = first[0]
        self._eager_served.add(("prefill", tp, self.cache.capacity))
        return first, last, tp

    def _inject(self, slot, hit, seed, temperature):
        """A prefix hit: the stored pages into the slot's page (copies, no
        forward), ``valid[slot]`` to the prompt length, and the first token
        sampled from the stored logits. Returns the first token (1,)."""
        k_stack, v_stack, plen, last = hit
        n = min(k_stack.shape[2], self.cache.capacity)
        with torch.no_grad(), profiler.scope(
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
        self._eager_served.add(("inject", n, self.cache.capacity))
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
        self._eager_served.add(("extract", tp, c.capacity))

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
        t_join = time.perf_counter()
        tr = stream.trace
        if tr is not None:
            tr.add_span("queue", req.t_submit, t_join)
        n = int(stream.prompt.size)
        self.cache.ensure_capacity(n + stream.max_new_tokens
                                   + self._spec_margin)
        if self._draft is not None:
            self._draft.ensure_capacity()
        slot = self.cache.acquire(stream)
        if self._prefill_chunk is not None and n > self._prefill_chunk:
            # chunked: the slot is owned now and filled one chunk a tick
            # (_chunk_once), masked out of decode until its final chunk
            # samples the first token. Partial pages are never stored, so
            # the prefix cache is bypassed
            self._chunk_jobs[slot] = {"req": req, "stream": stream, "pos": 0}
            self._ctl_dirty = True
            return
        try:
            hit = self.prefix.get(stream.prompt) \
                if self.prefix is not None else None
            t_disp0 = time.perf_counter()
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
        if tr is not None:
            tr.add_span("pad", t_join, t_disp0)
            tr.add_span("dispatch", t_disp0, time.perf_counter(),
                        prefix_hit=hit is not None)
        self._activate(slot, req, stream, first)

    def _activate(self, slot, req, stream, first):
        """A slot whose prompt is in its page and whose first token is
        sampled joins decode: the draft fills its own page, the slot's
        controls are set and the first token is delivered."""
        self._warm = True
        now = time.perf_counter()
        if not req.finish(result=stream):
            # timed out in the instant admission landed: roll back
            self.cache.release(slot)
            self._ctl_dirty = True
            return
        if self._draft is not None:
            self._draft.join(slot, stream.prompt)
        self._slot_req[slot] = req
        self._remaining[slot] = stream.max_new_tokens
        self._seeds[slot] = stream.seed
        self._temps[slot] = stream.temperature
        self._ctl_dirty = True
        self.metrics.record_first_token((now - req.t_submit) * 1e3,
                                        int(stream.prompt.size))
        self._deliver(slot, first)

    # ------------------------------------------------------------- decoding
    def _active_mask(self):
        """(slots,) bool list of the slots that decode: owned, and not in
        the middle of a chunked prefill."""
        return [live and s not in self._chunk_jobs
                for s, live in enumerate(self.cache.active_mask())]

    def _upload_controls(self):
        """The host's slot controls into the static device buffers, in
        place (outside any step program)."""
        self._dev_active.copy_(torch.tensor(self._active_mask()))
        self._dev_active_i32.copy_(self._dev_active)
        self._dev_seeds.copy_(torch.from_numpy(self._seeds))
        self._dev_temps.copy_(torch.from_numpy(self._temps))
        self._sampling = bool((self._temps > 0).any())
        self._ctl_dirty = False

    def _step_state(self, kind="decode"):
        """The tensors a step of ``kind`` reads and writes in place."""
        c = self.cache
        state = {"tok": self._tok, "valid": c.valid,
                 "active": self._dev_active,
                 "active_i32": self._dev_active_i32,
                 "seeds": self._dev_seeds, "temps": self._dev_temps,
                 "k": c.k, "v": c.v}
        if c.quantize:
            state.update(k_scale=c.k_scale, v_scale=c.v_scale)
        if kind == "verify":
            state.update(drafts=self._drafts, emit=self._emit)
        elif kind == "chunk":
            state.update(chunk_tokens=self._chunk_tokens,
                         chunk_ctl=self._chunk_ctl,
                         chunk_temp=self._chunk_temp)
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

    def _wide(self, pages, tokens, valid):
        """The model's wide-window step (``decode_step_speculative``, or
        its int8 form) over ``pages`` (a dict with ``k``, ``v`` and, when
        quantized, their scales), written in place: logits (B, K, V)."""
        if "k_scale" in pages:
            return self.model.decode_step_speculative_quant(
                F, tokens, pages["k"], pages["k_scale"], pages["v"],
                pages["v_scale"], valid)[0]
        return self.model.decode_step_speculative(F, tokens, pages["k"],
                                                  pages["v"], valid)[0]

    def _verify_body(self, sampling):
        """The verify step: each slot's window [current token, drafts]
        through the wide step at ``valid``; row j sampled at position
        ``valid + 1 + j`` (where plain decode samples that token); the
        accepted length ``al`` is the run of samples equal to their
        drafts, a live slot emits ``al + 1`` tokens (its accepted drafts
        and the sample after them), advances ``valid`` by as many and
        takes the sample at row ``al`` as its next input. The emitted
        tokens and their count go to ``emit`` (slots, spec_k + 1). Returns
        the logits (slots, spec_k, V)."""
        top_k, K = self.top_k, self.spec_k

        def body(st):
            tok, valid, drafts, act = (st["tok"], st["valid"], st["drafts"],
                                       st["active"])
            logits = self._wide(st, torch.cat([tok[:, None], drafts], dim=1),
                                valid)
            S, _, V = logits.shape
            rows = torch.arange(K, dtype=torch.int32, device=valid.device)
            pos = valid[:, None] + 1 + rows[None]
            y = sample_tokens(logits.reshape(S * K, V),
                              st["seeds"].repeat_interleave(K),
                              pos.reshape(-1),
                              st["temps"].repeat_interleave(K), top_k,
                              sampling).reshape(S, K)
            if K > 1:
                match = (y[:, :K - 1] == drafts).to(torch.int32)
                al = torch.cumprod(match, dim=1).sum(dim=1,
                                                     dtype=torch.int32)
            else:
                al = torch.zeros_like(valid)
            n_emit = torch.where(act, al + 1, 0)
            st["emit"][:, :K].copy_(
                torch.where((rows[None] <= al[:, None]) & act[:, None], y, 0))
            st["emit"][:, K].copy_(n_emit)
            valid += n_emit
            tok.copy_(torch.where(act, y.gather(1, al[:, None].long())[:, 0],
                                  0))
            return logits

        return body

    def _chunk_body(self, sampling):
        """One prefill chunk: the page of the slot ``chunk_ctl`` names
        (gathered from the pages by a device index, so one program serves
        every slot) through the wide step at offset ``pos0``, the chunk's
        rows attending to the positions before them, and scattered back.
        ``valid[slot]`` goes to ``min(pos0 + tc, plen)``: a chunk that is
        not the last parks it at the chunk frontier, where a decode step's
        write for the masked slot is overwritten by the next chunk. Every
        chunk samples a first token at position ``plen`` from row
        ``clip(plen - 1 - pos0, 0, tc - 1)`` into ``tok[slot]``; the final
        chunk's is the prompt's last position. Returns the logits
        (1, tc, V)."""
        tc, top_k = self._prefill_chunk, self.top_k

        def body(st):
            ctl = st["chunk_ctl"]
            slot, plen, seed = ctl[0:1], ctl[2:3], ctl[3:4]
            pos0 = ctl[1:2].to(torch.int32)
            names = ("k", "v") + (("k_scale", "v_scale") if "k_scale" in st
                                  else ())
            page = {n: [t.index_select(0, slot) for t in st[n]]
                    for n in names}
            if "k_scale" in st:
                # a fresh scale on the first chunk: a reused slot must not
                # keep the last stream's running max
                fresh = (pos0 == 0).reshape(1, 1, 1, 1)
                for n in ("k_scale", "v_scale"):
                    page[n] = [torch.where(fresh, 0.0, t) for t in page[n]]
            logits = self._wide(page, st["chunk_tokens"], pos0)
            for n in names:
                for dst, src in zip(st[n], page[n]):
                    dst.index_copy_(0, slot, src)
            st["valid"].index_copy_(
                0, slot, torch.minimum(pos0 + tc, plen.to(torch.int32)))
            row = torch.clamp(plen - 1 - pos0, 0, tc - 1)
            first = sample_tokens(logits[0].index_select(0, row), seed, plen,
                                  st["chunk_temp"], top_k, sampling)
            st["tok"].index_copy_(0, slot, first)
            return logits

        return body

    def _run(self, kind, key, body, eager):
        with self._params_lock, torch.no_grad(), profiler.decode_scope(
                kind, self.slots, len(self.cache.active_slots),
                torch_name="mxnet_tpu_torch::%s_step" % kind):
            return self._steps.run(
                key, body, self._step_state(kind),
                params=[p._tensor() for p in self._plist], eager=eager)

    def _run_step(self, eager=False):
        """One decode step for every slot through the step program of its
        key ("decode", capacity, sampling); ``eager`` runs the same step
        without the program (a check compares the two). Returns the logits
        (slots, V); the next tokens are in ``_tok``."""
        if self._ctl_dirty:
            self._upload_controls()
        return self._run("decode", ("decode", self.cache.capacity,
                                    self._sampling),
                         self._step_body(self._sampling), eager)

    def _run_verify(self, eager=False):
        """One verify step over the drafts in ``_drafts``, through the
        program of ("verify", capacity, spec_k, sampling). Returns the
        logits (slots, spec_k, V); the emitted tokens are in ``_emit``."""
        if self._ctl_dirty:
            self._upload_controls()
        return self._run("verify", ("verify", self.cache.capacity,
                                    self.spec_k, self._sampling),
                         self._verify_body(self._sampling), eager)

    def _run_chunk(self, sampling, eager=False):
        """One prefill chunk from the chunk buffers, through the program
        of ("chunk", tc, capacity, sampling). Returns the logits."""
        return self._run("chunk", ("chunk", self._prefill_chunk,
                                   self.cache.capacity, sampling),
                         self._chunk_body(sampling), eager)

    def _decode_once(self):
        active = self._active_mask()
        n_active = sum(active)
        if n_active == 0:
            return 0
        if self._draft is not None:
            return self._speculate_once(active, n_active)
        t0 = time.perf_counter()
        self._run_step()
        nxt_host = self._tok.cpu().numpy()   # the one host readback a step
        dt = time.perf_counter() - t0
        self._warm = True
        self.metrics.record_step(dt, n_active, n_active, self.slots,
                                 under_prefill=bool(self._chunk_jobs))
        now = time.perf_counter()
        for slot in np.flatnonzero(active):
            tr = self.cache.owner(int(slot)).trace
            if tr is not None:
                tr.note_decode_step(dt, now)
            self._deliver(int(slot), int(nxt_host[slot]), now)
        return n_active

    def _propose(self, active):
        """The draft's proposals for the live slots into ``_drafts``."""
        draft = self._draft
        hists = None
        if draft.needs_history:
            hists = []
            for s, live in enumerate(active):
                o = self.cache.owner(s) if live else None
                hists.append(o.prompt.tolist() + o.tokens if o is not None
                             else [])
        with self._params_lock:
            draft.propose(hists, self.spec_k)

    def _speculate_once(self, active, n_active):
        """One speculation round: the draft proposes spec_k - 1 tokens a
        slot, one verify step scores every window, and each live slot
        receives its accepted drafts and the sample after them (1 to
        spec_k tokens), read back in one copy. Rejected positions need no
        scrub: ``valid`` advances past the accepted tokens only, and the
        next window overwrites the rest."""
        k = self.spec_k
        self._propose(active)
        t0 = time.perf_counter()
        self._run_verify()
        out = self._emit.cpu().numpy()   # the one host readback a round
        dt = time.perf_counter() - t0
        emit, n_emit = out[:, :k], out[:, k]
        emitted = int(n_emit.sum())
        self._warm = True
        self.metrics.record_step(dt, emitted, n_active, self.slots,
                                 under_prefill=bool(self._chunk_jobs))
        self.metrics.record_spec_round(n_active * (k - 1),
                                       emitted - n_active)
        now = time.perf_counter()
        for slot in np.flatnonzero(active):
            slot = int(slot)
            stream = self.cache.owner(slot)
            for tok in emit[slot, :n_emit[slot]]:
                if self.cache.owner(slot) is not stream:
                    break   # retired in the middle of its window
                self._deliver(slot, int(tok), now)
        return n_active

    def _chunk_once(self):
        """At most one prefill chunk, first in first out across the jobs:
        ``prefill_chunk`` prompt positions of the oldest job into its page
        (:meth:`_chunk_body`). The final chunk's first token activates the
        slot; a job whose deadline passed releases it."""
        if not self._chunk_jobs:
            return 0
        slot, job = next(iter(self._chunk_jobs.items()))
        req, stream = job["req"], job["stream"]
        now = time.perf_counter()
        if req.done() or req.expired(now):
            del self._chunk_jobs[slot]
            self.cache.release(slot)
            self._ctl_dirty = True
            err = ServeTimeout("timed out after %.1fms mid-prefill"
                               % ((now - req.t_submit) * 1e3))
            if req.finish(error=err):
                stream._finish(err)
                self.metrics.record_timeout()
            with self._join_cond:
                self._join_cond.notify_all()
            return 1
        tc = self._prefill_chunk
        plen = int(stream.prompt.size)
        pos0 = job["pos"]
        chunk = np.zeros((1, tc), np.int64)
        seg = stream.prompt[pos0:pos0 + tc]
        chunk[0, :seg.size] = seg
        self._chunk_tokens.copy_(torch.from_numpy(chunk))
        self._chunk_ctl.copy_(torch.tensor([slot, pos0, plen, stream.seed]))
        self._chunk_temp.fill_(stream.temperature)
        self._run_chunk(stream.temperature > 0)
        self.metrics.record_chunk()
        job["pos"] = pos0 + tc
        if job["pos"] < plen:
            return 1
        del self._chunk_jobs[slot]
        first = int(self._tok[slot])   # the first token's host readback
        self.metrics.record_prefill()
        self._activate(slot, req, stream, first)
        with self._join_cond:
            self._join_cond.notify_all()
        return 1

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
            if stream.trace is not None:
                stream.trace.close_decode()
            stream._finish(error)
            if error is None and req is not None:
                self.metrics.record_latency(
                    (time.perf_counter() - req.t_submit) * 1e3)
        job = self._chunk_jobs.pop(slot, None)
        if job is not None and error is not None:
            job["req"].finish(error=error)
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
        ``max_tokens``. With a draft, the draft's fills and its round, and
        the verify programs instead of the decode ones; with chunked
        prefill, a greedy and a sampled chunk. Steady state then captures
        nothing."""
        need = max(int(max_tokens or 0),
                   max([int(b) for b in prompt_buckets], default=1) + 1)
        self.cache.ensure_capacity(need + self._spec_margin)
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
        if self._draft is not None:
            self._draft.warm([min(next_pow2(int(b)), self.cache.capacity)
                              for b in prompt_buckets])
        if self._prefill_chunk is not None \
                and self.cache.capacity >= self._prefill_chunk:
            self._warm_chunk()
        dummy = GenerationStream([1], 2, 0.0, 0, 0)
        slot = self.cache.acquire(dummy)
        if slot is not None:
            # a verify round may emit several tokens: the budget outlasts
            # the two steps
            self._remaining[slot] = 2 * self.spec_k
            for temperature in (0.0, 1.0):
                self._temps[slot] = temperature
                self._ctl_dirty = True
                self._decode_once()
            if self.cache.owner(slot) is dummy:
                self._retire(slot)
        return self

    def _warm_chunk(self):
        """A greedy and a sampled chunk on a throwaway slot (a single final
        chunk: pos0 0, a prompt of one chunk), which capture the two chunk
        programs at the current capacity."""
        tc = self._prefill_chunk
        slot = self.cache.acquire(GenerationStream([1] * tc, 1, 0.0, 0, 0))
        if slot is None:
            return
        self._chunk_tokens.zero_()
        self._chunk_ctl.copy_(torch.tensor([slot, 0, tc, 0]))
        for temperature in (0.0, 1.0):
            self._chunk_temp.fill_(temperature)
            self._run_chunk(temperature > 0)
        self.cache.release(slot)

    # ------------------------------------------------ snapshot interface
    def export_executables(self):
        """The server's programs for a snapshot manifest, under the JAX
        package's keys: [{key, kind, tp, capacity, sampling}]. The live step
        programs (``decode@c<capacity>``, ``verify@c<capacity>``,
        ``chunk@t<chunk>c<capacity>``; ``sampling`` lists which of the
        greedy and the sampled program is live), the prompt buckets the
        eager paths have served (``prefill``, ``inject``, ``extract`` at
        ``@t<bucket>c<capacity>``) and the draft's. No entry carries a
        compiled program: a CUDA graph cannot leave its process, so load
        captures each listed program again."""
        out = {}
        for key in self._steps.keys():
            kind, sampling = key[0], key[-1]
            if kind == "chunk":
                tp, cap = key[1], key[2]
                name = "chunk@t%dc%d" % (tp, cap)
            else:
                tp, cap = 0, key[1]
                name = "%s@c%d" % (kind, cap)
            e = out.setdefault(name, {"key": name, "kind": kind,
                                      "tp": int(tp), "capacity": int(cap),
                                      "sampling": []})
            e["sampling"] = sorted(e["sampling"] + [bool(sampling)])
        for kind, tp, cap in sorted(self._eager_served):
            name = "%s@t%dc%d" % (kind, tp, cap)
            out[name] = {"key": name, "kind": kind, "tp": int(tp),
                         "capacity": int(cap)}
        if self._draft is not None:
            out.update((e["key"], e) for e in self._draft.export_executables())
        return [out[k] for k in sorted(out)]

    def preload_executable(self, kind, tp, capacity, compiled=None,
                           sampling=None):
        """Make the program of one snapshot entry before traffic, on a
        throwaway slot, as :meth:`warmup` does: a step program (``decode``,
        ``verify``, ``chunk``) is captured for each of ``sampling``
        (default both greedy and sampled); ``draftstep`` goes to the draft.
        An eager entry (``prefill``, ``inject``, ``extract``,
        ``draftfill``) has nothing to compile or capture: it is only kept,
        so that this server's own snapshot lists it again. ``compiled`` is
        the JAX package's serialized executable, which the port cannot take
        (a CUDA graph holds one process's device addresses): it must be
        None."""
        if compiled is not None:
            raise ServeError("preload_executable(%r): the port captures its "
                             "programs and takes no serialized executable"
                             % kind)
        if kind in ("draftstep", "draftfill", "verify") \
                and self._draft is None:
            raise ServeError("snapshot carries %r programs but this server "
                             "has no draft configured" % kind)
        if kind in ("draftstep", "draftfill"):
            self._draft.preload_executable(kind, tp, capacity)
            if kind == "draftstep":
                self._snapshot_programs += 1
            return
        if kind in ("prefill", "inject", "extract"):
            self._eager_served.add((kind, tp, capacity))
            return
        if kind not in ("decode", "verify", "chunk"):
            raise ServeError("unknown snapshot program kind %r" % kind)
        if kind == "chunk" and tp != self._prefill_chunk:
            raise ServeError("chunk program of %d positions, but this "
                             "server's prefill_chunk is %r"
                             % (tp, self._prefill_chunk))
        self.cache.ensure_capacity(capacity)
        if self.cache.capacity != capacity:
            raise ServeError("a program at capacity %d, but the cache is at "
                             "%d" % (capacity, self.cache.capacity))
        slot = self.cache.acquire(GenerationStream([1] * max(1, tp), 1, 0.0,
                                                   0, 0))
        if slot is None:
            raise ServeError("no free slot to make the %r program on: "
                             "preload before traffic" % kind)
        try:
            if kind == "chunk":
                self._chunk_tokens.zero_()
                self._chunk_ctl.copy_(torch.tensor([slot, 0, tp, 0]))
            for s in (False, True) if sampling is None else sampling:
                if kind == "chunk":
                    self._chunk_temp.fill_(1.0 if s else 0.0)
                    self._run_chunk(bool(s))
                    continue
                self._temps[slot] = 1.0 if s else 0.0
                self._ctl_dirty = True
                if kind == "decode":
                    self._run_step()
                else:
                    self._run_verify()
        finally:
            self._temps[slot] = 0.0
            self._ctl_dirty = True
            self.cache.release(slot)
        self._snapshot_programs += 1

    def snapshot(self, prefix, epoch=0):
        """Write this server's serving artifact (checkpoint, config and the
        list of its programs); see ``serve.snapshot`` and
        ``mxnet_tpu_torch.cache.snapshot``. Returns the manifest path."""
        from ..cache.snapshot import save_snapshot

        return save_snapshot(self, prefix, epoch=epoch)

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
            spec_k=self.spec_k if self._draft is not None else None,
            draft=(type(self._draft).__name__ if self._draft is not None
                   else None),
            prefill_chunk=self._prefill_chunk,
            chunk_queue_depth=len(self._chunk_jobs),
            step_programs=len(self._steps.keys()),
            snapshot_programs=self._snapshot_programs,
            step_captures=self._steps.captures,
            step_replays=self._steps.replays,
            draft_step_captures=(self._draft._steps.captures
                                 if isinstance(self._draft, ModelDraft)
                                 else None),
            draft_step_replays=(self._draft._steps.replays
                                if isinstance(self._draft, ModelDraft)
                                else None),
            device=str(self.device),
            running=(self._loop_thread is not None
                     and self._loop_thread.is_alive()),
        )
        return snap
