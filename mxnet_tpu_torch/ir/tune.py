"""mxnet_tpu_torch.ir.tune — searched schedules over the typed IR
(counterpart of ``mxnet_tpu/ir/tune.py``).

The knobs that decide a step's time become candidate spaces this module
searches with two instruments the port already has:

* the cost ledger (``observability.costs``): each candidate is run once
  under a flop counter and an op recorder (:func:`costs.measure`), and its
  flops and bytes prune the dominated ones before anything is timed;
* paired-step timing: the objective interleaves one step per arm and
  takes the median of the pairs, so contention hits both sides of every
  pair; on the card each step synchronizes.

The spaces: the ``PassManager`` config of one canonical graph
(:func:`search`, parity-gated at 1e-6 against ``DEFAULT_PASSES``; ``quant``
only with ``include_quant=True``), a server's bucket set
(:func:`tune_buckets` over :func:`fit_buckets`), the bulk window's
watermark (:func:`tune_bulk_watermark`: a reading, the default stays 0)
and the flash forward's fp32 split (:func:`tune_flash_blocks`). The bf16
flash tiles are not searched: they are template constants of the kernel,
one instance a head dim (``csrc/flash_attention_fwd.cu``), with no
runtime knob. The fp32 form's ``(splits, chunk)`` is one:
``flash_f32_splits`` reads an installed winner before its cost model.

Winners persist in a JSON store (``MXNET_TUNE_STORE``, or
``<MXNET_COMP_CACHE_DIR>/tuned.json``, else in memory) keyed
``graph:<canonical key>``, ``serve:buckets:<name>``,
``engine:bulk_size`` and ``flash:f32:<B*H>:<Tq>:<Tk>:<causal>:<D>``;
``ir.lower.prepare`` consults :func:`pass_manager_for` on each entry
build, so a fresh process reloads a winner with no search. A malformed
store reads as empty with a warning; a stale record warns and lowers with
the defaults.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings

import numpy as np
import torch

from .. import base
from . import graph as _g
from . import passes as _p

__all__ = ["search", "candidate_configs", "rank_candidates",
           "paired_step_ms", "pass_manager_for", "install", "lookup",
           "fit_buckets", "tune_buckets", "tune_bulk_watermark",
           "tune_flash_blocks", "flash_block_candidates", "flash_split",
           "store_path", "get_store", "reset_store", "stats", "reset_stats",
           "TunedStore", "config_key", "example_leaves", "TUNED_BY"]

TUNED_BY = "mxnet_tpu_torch.ir.tune"

_STATS = {
    "searches": 0,          # search() calls this process
    "candidates": 0,        # configs probed (run once, counted)
    "pruned": 0,            # dominated by the cost ledger, never timed
    "timed": 0,             # survivors timed in paired steps
    "parity_rejects": 0,    # candidates off the default's outputs
    "installs": 0,          # winners written to the store
    "store_hits": 0,        # entry builds that found a tuned config
    "store_misses": 0,      # entry builds that took DEFAULT_PASSES
    "stale_records": 0,     # tuned records that did not rebuild
    "last_search": None,    # a summary of the last search()
}

_lock = threading.Lock()


def _utcnow():
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _backend_name():
    return "cuda" if torch.cuda.is_available() else "cpu"


# ------------------------------------------------------------------ store


def store_path():
    """The store's path, or None (in memory): ``MXNET_TUNE_STORE``, else
    ``tuned.json`` in ``MXNET_COMP_CACHE_DIR`` (tuned configs travel with
    the compile store)."""
    p = os.environ.get("MXNET_TUNE_STORE")
    if p:
        return p
    cc = os.environ.get("MXNET_COMP_CACHE_DIR")
    return os.path.join(cc, "tuned.json") if cc else None


class TunedStore:
    """A persistent ``key -> record`` map of tuning winners. Every record
    carries ``tuned_by`` / ``swept_at`` / ``backend`` beside its
    ``config``. Writes are atomic (``cache.atomic_write``); the file is
    read once, lazily, and a malformed one reads as empty with a
    warning."""

    VERSION = 1

    def __init__(self, path=None):
        self.path = path
        self._entries = None
        self._lock = threading.Lock()

    def _load(self):
        if self._entries is not None:
            return self._entries
        entries = {}
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    raw = json.load(f)
                entries = dict(raw["entries"])
            except (OSError, ValueError, KeyError, TypeError) as e:
                warnings.warn("ignoring malformed tuned-config store %s "
                              "(%s: %s); starting empty"
                              % (self.path, type(e).__name__, e),
                              RuntimeWarning, stacklevel=3)
        self._entries = entries
        return entries

    def _save(self):
        if not self.path:
            return
        from ..cache import atomic_write

        data = json.dumps({"version": self.VERSION,
                           "entries": self._entries}, indent=1,
                          sort_keys=True) + "\n"
        atomic_write(self.path, data.encode())

    def get(self, key):
        with self._lock:
            return self._load().get(key)

    def put(self, key, record):
        with self._lock:
            self._load()[key] = record
            self._save()

    def keys(self):
        with self._lock:
            return sorted(self._load())

    def __len__(self):
        with self._lock:
            return len(self._load())


_store = None


def get_store():
    global _store
    with _lock:
        if _store is None:
            _store = TunedStore(store_path())
        return _store


def reset_store():
    """Drop the store handle so the next access resolves the path again
    (after ``MXNET_TUNE_STORE`` changed)."""
    global _store
    with _lock:
        _store = None


def reset_stats():
    with _lock:
        for k in _STATS:
            _STATS[k] = None if k == "last_search" else 0


def stats():
    """The observability "tune" section and the diagnose tool's
    payload."""
    with _lock:
        out = dict(_STATS)
    st = get_store()
    out["store"] = {"path": st.path, "entries": len(st),
                    "keys": st.keys()[:16]}
    return out


# ------------------------------------------------- lower-path integration


def lookup(key):
    """The store's record for canonical graph ``key``, or None."""
    return get_store().get("graph:" + key)


def pass_manager_for(key):
    """The tuned ``PassManager`` for canonical graph ``key``, or None for
    ``DEFAULT_PASSES`` (``ir.lower.prepare`` asks on every entry build). A
    record that does not rebuild (a pass this port does not have, a
    malformed config) warns and gives None."""
    rec = lookup(key)
    with _lock:
        _STATS["store_misses" if rec is None else "store_hits"] += 1
    if rec is None:
        return None
    try:
        return _p.PassManager.from_config(rec["config"])
    except (KeyError, TypeError, ValueError) as e:
        with _lock:
            _STATS["stale_records"] += 1
        warnings.warn("tuned config for graph %s does not rebuild (%s: %s);"
                      " lowering with DEFAULT_PASSES"
                      % (key[:16], type(e).__name__, e), RuntimeWarning,
                      stacklevel=2)
        return None


def install(key, config, objective=None, cost=None, tuned_by=None):
    """Persist a winning config for canonical graph ``key`` and evict the
    live entry, so the next lowering of this graph builds with it (one
    build at install, none after)."""
    rec = {"config": dict(config),
           "tuned_by": tuned_by or (TUNED_BY + ".search"),
           "swept_at": _utcnow(), "backend": _backend_name()}
    if objective:
        rec["objective"] = objective
    if cost:
        rec["cost"] = cost
    get_store().put("graph:" + key, rec)
    base._IR_CACHE.pop(key, None)
    with _lock:
        _STATS["installs"] += 1
    return rec


# -------------------------------------------------------- candidate space


def candidate_configs(include_quant=False):
    """The deterministic candidate list over the ``PassManager`` surface:
    the JAX package's orderings less ``donation`` (not applicable here; the
    JAX list's "donation off" arm then equals the default and is not
    repeated), each at three fold caps. ``quant`` only on request: it
    changes numbers on purpose, and the parity gate rejects it wherever
    it fires."""
    orderings = [
        ("cse", "fold", "cast_sink", "dce"),
        ("fold", "cse", "cast_sink", "dce"),
        ("cse", "cast_sink", "fold", "dce"),
        ("cse", "fold", "dce"),                  # cast_sink off
    ]
    if include_quant:
        orderings.append(("cse", "fold", "cast_sink", "dce", "quant"))
    out = []
    for cap in (None, 262144, 1048576):  # None: MXNET_IR_FOLD_MAX_ELEMS
        for o in orderings:
            cfg = {"passes": list(o)}
            if cap is not None:
                cfg["fold_max_elems"] = cap
            out.append(cfg)
    return out


def config_key(cfg):
    """A config's stable string identity (ranking tiebreak)."""
    return json.dumps(cfg, sort_keys=True)


def example_leaves(cgraph, seed=0, device="cpu"):
    """Deterministic inputs for a canonical graph's leaves, the JAX
    package's draws (``RandomState(seed)``: integers in [0, 8), booleans,
    else standard normals) in each leaf's dtype and layout. Array leaves
    only."""
    rs = np.random.RandomState(seed)
    vals = []
    for sid in cgraph.leaf_sigs:
        sig = None if sid is None else _g.sig_value(sid)
        if type(sig) is not tuple:
            raise ValueError("tune.search needs tensor-typed leaves (got "
                             "%r)" % (sig,))
        dt, shape, strides = sig
        if dt == torch.bool:
            a = torch.from_numpy(rs.rand(*shape) > 0.5)
        elif not dt.is_floating_point:
            a = torch.from_numpy(rs.randint(0, 8, size=shape)).to(dt)
        else:
            a = torch.from_numpy(rs.standard_normal(shape).astype(
                np.float32)).to(dt)
        t = torch.empty_strided(shape, strides, dtype=dt, device=device)
        t.copy_(a.to(device))
        vals.append(t)
    return vals


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Probe:
    """One candidate: its optimized graph run once under the cost
    instruments (the parity evidence and the cost columns); on the card
    captured at its first timed step (only the survivors are)."""

    __slots__ = ("config", "cost", "outputs", "n_nodes", "_run", "_args",
                 "_device", "_replay")

    def __init__(self, cgraph, pm, leaves, config, device):
        from ..observability import costs

        final, leaf_sel, _ = _p.optimize(cgraph, pm, device)
        self._run = _g.build_runner(final, device)
        self._args = [leaves[li] for li in leaf_sel]
        self._device = device
        self._replay = None
        with torch.no_grad():
            outs, cost = costs.measure(
                lambda: list(self._run(self._args)), device)
        self.config = config
        self.cost = {"flops": cost["flops"], "bytes_accessed": cost["bytes"],
                     "peak_hbm_bytes": cost["peak_bytes"] or 0}
        self.outputs = [o.detach().to("cpu") for o in outs]
        self.n_nodes = final.n_nodes

    def _fwd(self):
        with torch.no_grad():
            return list(self._run(self._args))

    def step(self):
        """One step: a CUDA-graph replay and a sync on the card, the
        runner on the CPU."""
        if self._device.type != "cuda":
            self._fwd()
            return
        if self._replay is None:
            from ..capture import capture_graph

            self._replay = capture_graph(
                self._fwd, self._device, torch.cuda.graph_pool_handle())
        self._replay.replay()
        _sync(self._device)


def _parity_ok(base_outs, cand_outs, tol=1e-6):
    if len(base_outs) != len(cand_outs):
        return False
    for a, b in zip(base_outs, cand_outs):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if not torch.allclose(a.to(torch.float64), b.to(torch.float64),
                              rtol=tol, atol=tol, equal_nan=True):
            return False
    return True


def rank_candidates(rows):
    """Ascending (bytes accessed, flops, peak bytes), config-key
    tiebreak: the same columns give the same order in any process."""
    return sorted(rows, key=lambda r: (
        float(r["cost"]["bytes_accessed"]), float(r["cost"]["flops"]),
        float(r["cost"]["peak_hbm_bytes"]), r["config_key"]))


def _cost_plausible(cand, base_cost):
    """Worth a stopwatch only if it improves a first-order column."""
    return (cand["bytes_accessed"] < base_cost["bytes_accessed"]
            or cand["flops"] < base_cost["flops"]
            or cand["peak_hbm_bytes"] < base_cost["peak_hbm_bytes"])


# ------------------------------------------------------------- the search


def paired_step_ms(fn_a, fn_b, pairs=5):
    """Interleave one step per arm (warm both first); the median step of
    each arm and the median pair delta (a - b), in ms, unrounded."""
    deltas, a_ms, b_ms = [], [], []
    for _ in range(max(1, int(pairs))):
        t0 = time.perf_counter()
        fn_a()
        t1 = time.perf_counter()
        fn_b()
        t2 = time.perf_counter()
        a, b = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        a_ms.append(a)
        b_ms.append(b)
        deltas.append(a - b)

    def med(v):
        return sorted(v)[len(v) // 2]

    return {"a_ms": med(a_ms), "b_ms": med(b_ms), "delta_ms": med(deltas)}


def search(raw_graph, pairs=5, top_k=3, include_quant=False,
           install_winner=True, configs=None, device=None, parity_tol=1e-6):
    """Search the ``PassManager`` space for one graph: canonicalize, probe
    ``DEFAULT_PASSES`` (the baseline) and each candidate (outputs
    parity-gated at ``parity_tol``), prune what the cost ledger says cannot
    be faster, time the ``top_k`` best against the baseline in paired
    steps, install the fastest strict improvement (wall and ledger) under
    ``graph:<key>``. ``report["winner"]`` is None when nothing beat the
    default (the store is left as it was)."""
    device = torch.device(device) if device is not None else \
        base.resolve_device(None)
    canon = _g.canonicalize(raw_graph)
    cgraph = canon.graph
    key = _g.canonical_key(cgraph)
    leaves = example_leaves(cgraph, device=device)
    baseline = _Probe(cgraph, _p.PassManager(), leaves,
                      {"passes": list(_p.DEFAULT_PASSES)}, device)
    rows, parity_rejects = [], 0
    for cfg in (list(configs) if configs is not None
                else candidate_configs(include_quant)):
        probe = _Probe(cgraph, _p.PassManager.from_config(cfg), leaves,
                       cfg, device)
        if not _parity_ok(baseline.outputs, probe.outputs, parity_tol):
            parity_rejects += 1
            continue
        rows.append({"config": cfg, "config_key": config_key(cfg),
                     "cost": probe.cost, "probe": probe,
                     "n_nodes": probe.n_nodes})
    plausible = [r for r in rows if _cost_plausible(r["cost"],
                                                    baseline.cost)]
    timed = rank_candidates(plausible)[:max(0, int(top_k))]
    pruned = len(rows) - len(timed)
    baseline.step()
    results = []
    for r in timed:
        r["probe"].step()
        t = paired_step_ms(baseline.step, r["probe"].step, pairs=pairs)
        results.append({
            "config": r["config"], "config_key": r["config_key"],
            "cost": dict(r["cost"]), "baseline_step_ms": t["a_ms"],
            "tuned_step_ms": t["b_ms"], "delta_ms": t["delta_ms"]})
    winner = None
    for res in sorted(results, key=lambda r: (-r["delta_ms"],
                                              r["config_key"])):
        cc = res["cost"]
        if res["delta_ms"] > 0 and (
                cc["bytes_accessed"] < baseline.cost["bytes_accessed"]
                or cc["peak_hbm_bytes"] < baseline.cost["peak_hbm_bytes"]):
            winner = res
            break
    report = {"key": key, "baseline_cost": dict(baseline.cost),
              "candidates": len(rows) + parity_rejects,
              "parity_rejects": parity_rejects, "pruned": pruned,
              "timed": results, "pairs": pairs, "winner": winner,
              "device": str(device)}
    with _lock:
        _STATS["searches"] += 1
        _STATS["candidates"] += len(rows) + parity_rejects
        _STATS["pruned"] += pruned
        _STATS["timed"] += len(results)
        _STATS["parity_rejects"] += parity_rejects
        _STATS["last_search"] = {
            "key": key[:16], "candidates": report["candidates"],
            "pruned": pruned, "timed": len(results), "pairs": pairs,
            "winner": None if winner is None else winner["config_key"]}
    if winner is not None and install_winner:
        install(key, winner["config"],
                objective={"baseline_step_ms": winner["baseline_step_ms"],
                           "tuned_step_ms": winner["tuned_step_ms"],
                           "delta_ms": winner["delta_ms"], "pairs": pairs},
                cost={"baseline": report["baseline_cost"],
                      "tuned": winner["cost"]})
    return report


# -------------------------------------------------------- serve buckets


def fit_buckets(size_counts, max_buckets=6, max_size=None):
    """The bucket set, at most ``max_buckets`` of the observed sizes, that
    minimises the pad rows of a measured request-size histogram
    ``{rows: count}`` (what ``ServeMetrics.request_rows`` gives). A
    deterministic dynamic program: the same histogram gives the same
    buckets in any process. ``max_size`` (the current largest bucket) is
    always covered, so a retune never shrinks what may be admitted. Ties
    go to fewer buckets."""
    counts = {int(s): int(c) for s, c in dict(size_counts).items()
              if int(s) > 0 and int(c) > 0}
    if max_size is not None:
        counts.setdefault(int(max_size), 0)
    if not counts:
        raise ValueError("fit_buckets needs a non-empty size histogram")
    sizes = sorted(counts)
    n = len(sizes)
    k = min(max(1, int(max_buckets)), n)
    # prefix sums: covering sizes[j..i] with bucket sizes[i] pads
    # (sizes[i] - s) rows for each request of size s
    pc = [0] * (n + 1)
    psc = [0] * (n + 1)
    for i, s in enumerate(sizes):
        pc[i + 1] = pc[i] + counts[s]
        psc[i + 1] = psc[i] + counts[s] * s

    def seg(j, i):
        return sizes[i] * (pc[i + 1] - pc[j]) - (psc[i + 1] - psc[j])

    inf = float("inf")
    dp = [[inf] * (k + 1) for _ in range(n)]
    back = [[-1] * (k + 1) for _ in range(n)]
    for i in range(n):
        dp[i][1] = seg(0, i)
        for b in range(2, k + 1):
            for j in range(1, i + 1):
                c = dp[j - 1][b - 1]
                if c == inf:
                    continue
                c += seg(j, i)
                if c < dp[i][b]:
                    dp[i][b] = c
                    back[i][b] = j - 1
    best_b = min(range(1, k + 1), key=lambda b: (dp[n - 1][b], b))
    buckets = []
    i, b = n - 1, best_b
    while i >= 0 and b >= 1:
        buckets.append(sizes[i])
        i, b = back[i][b], b - 1
    return tuple(sorted(buckets))


def _pad_rows(hist, buckets):
    bs = sorted(buckets)
    total = 0
    for s, c in hist.items():
        b = next((x for x in bs if x >= s), bs[-1])
        total += max(0, b - s) * c
    return total


def tune_buckets(server, max_buckets=6, apply=True, install_record=True):
    """Fit a bucket set to a live server's measured request sizes
    (``ServeMetrics``), optionally rebuild the server on it
    (``ModelServer.retune_buckets``) and persist it under
    ``serve:buckets:<name>``."""
    hist = server.metrics.request_rows()
    if not hist:
        raise ValueError(
            "no request-size history on %r: serve traffic before tuning "
            "buckets" % server.name)
    buckets = fit_buckets(hist, max_buckets=max_buckets,
                          max_size=server.buckets[-1])
    before = tuple(server.buckets)
    pad_before = _pad_rows(hist, before)
    pad_after = _pad_rows(hist, buckets)
    if install_record:
        get_store().put("serve:buckets:" + server.name, {
            "config": {"buckets": list(buckets)},
            "tuned_by": TUNED_BY + ".tune_buckets",
            "swept_at": _utcnow(), "backend": _backend_name(),
            "objective": {"pad_rows_before": pad_before,
                          "pad_rows_after": pad_after,
                          "requests": sum(hist.values())}})
    if apply and buckets != before:
        server.retune_buckets(buckets)
    return {"buckets": buckets, "before": before,
            "pad_rows_before": pad_before, "pad_rows_after": pad_after}


# ------------------------------------------------------- bulk watermark


def tune_bulk_watermark(candidates=(0, 5, 15, 30, 60), rounds=8, chain=24,
                        shape=(64, 64), apply=False, install_record=True,
                        device=None):
    """Time the bulk window's watermark (``MXNET_ENGINE_BULK_SIZE``) on a
    fusible ``nd`` chain of ``chain`` multiply-adds at ``shape``: one step
    per candidate per round, a host read ending each, the median per
    candidate. The winner is recorded under ``engine:bulk_size``; only
    ``apply=True`` sets it (the default stays 0, ROADMAP C.2)."""
    from .. import engine
    from .. import ndarray as nd
    from ..context import context_from_device

    device = torch.device(device) if device is not None else \
        base.resolve_device(None)
    ctx = context_from_device(device)
    candidates = tuple(dict.fromkeys(int(c) for c in candidates))

    def step(size):
        prev = engine.set_bulk_size(size)
        try:
            x = nd.ones(shape, ctx=ctx)
            for _ in range(chain):
                x = x * 1.0009765625 + 0.5
            x.wait_to_read()
            _sync(device)
        finally:
            engine.set_bulk_size(prev)

    for c in candidates:  # warm: build each watermark's programs
        step(c)
    walls = {c: [] for c in candidates}
    for _ in range(max(1, int(rounds))):
        for c in candidates:
            t0 = time.perf_counter()
            step(c)
            walls[c].append((time.perf_counter() - t0) * 1e3)
    medians = {c: sorted(v)[len(v) // 2] for c, v in walls.items()}
    winner = min(candidates, key=lambda c: (medians[c], c))
    if install_record:
        get_store().put("engine:bulk_size", {
            "config": {"bulk_size": winner},
            "tuned_by": TUNED_BY + ".tune_bulk_watermark",
            "swept_at": _utcnow(), "backend": _backend_name(),
            "objective": {"medians_ms": {str(c): medians[c]
                                         for c in candidates},
                          "rounds": rounds, "chain": chain,
                          "shape": list(shape)}})
    if apply:
        engine.set_bulk_size(winner)
    return {"winner": winner, "medians_ms": medians}


# ------------------------------------------------ the fp32 flash split

# the split's workspace (splits * B*H * Tq * (D + 2) floats) beyond which a
# candidate is pruned before it runs
_WORKSPACE_BUDGET_BYTES = 256 * 2 ** 20


def _flash_key(batch_heads, tq, tk, causal, head_dim):
    return "flash:f32:%d:%d:%d:%d:%d" % (batch_heads, tq, tk, int(causal),
                                         head_dim)


def flash_block_candidates(batch_heads, tq, tk, causal, head_dim=64,
                           tile=None,
                           workspace_budget=_WORKSPACE_BUDGET_BYTES):
    """The fp32 form's ``(splits, chunk)`` candidates at one shape: each
    split count whose chunk of key tiles (the shared-memory tile
    ``F32_TILES[head_dim]`` sets how many there are) gives exactly that
    many splits, pruned by the workspace's bytes. Deterministic; no card
    needed."""
    from ..ops.cuda import flash_attention as fa

    tile = tuple(tile or fa.F32_TILES[head_dim])
    tiles = fa.f32_key_tiles(tq, tk, bool(causal), tile)
    most = max(tiles + [1])
    out = []
    for s in range(1, min(most, fa.F32_MAX_SPLITS) + 1):
        chunk = -(-most // s)
        if -(-most // chunk) != s:
            continue
        work = 0 if s == 1 else s * batch_heads * tq * (head_dim + 2) * 4
        if work > workspace_budget:
            continue
        out.append((s, chunk))
    return out


def flash_split(batch_heads, tq, tk, causal, head_dim, tile):
    """The installed ``(splits, chunk)`` for this shape, or None (the cost
    model decides). A record that no longer fits the tile is ignored."""
    rec = get_store().get(_flash_key(batch_heads, tq, tk, causal, head_dim))
    if rec is None:
        return None
    from ..ops.cuda import flash_attention as fa

    splits, chunk = (int(x) for x in rec["config"]["split"])
    most = max(fa.f32_key_tiles(tq, tk, bool(causal), tuple(tile)) + [1])
    if splits < 1 or chunk < 1 or -(-most // chunk) != splits:
        return None
    return splits, chunk


def tune_flash_blocks(shapes=((1, 12, 512, 64, True, None),), pairs=5,
                      tol=(1e-5, 1e-5), apply=False, device=None, seed=0,
                      within=None):
    """Search the fp32 flash form's ``(splits, chunk)`` at each ``(B, H, T,
    D, causal, kv_valid_len)``: every candidate of
    :func:`flash_block_candidates` runs on the card, its output held to
    the plain version within ``tol`` = (atol, rtol), or by ``within(out,
    ref, q, k, v, scale, causal)`` when given (a candidate outside it is
    rejected), and is timed in paired steps against the incumbent (the
    best so far); the fastest wins. ``apply=True`` installs each
    winner, which ``flash_f32_splits`` then reads before its cost model.
    The kernel runs only on the card: without one this raises."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "flash split tuning needs a CUDA card: the fp32 flash kernel "
            "runs only there, and host timings of the plain version are no "
            "evidence of its schedule")
    from ..ops.cuda import flash_attention as fa

    device = torch.device(device) if device is not None else \
        base.resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, winners = [], {}
    for B, H, T, D, causal, vl in shapes:
        q, k, v = (torch.randn((B, H, T, D), generator=gen, device=device,
                               dtype=torch.float32) for _ in range(3))
        kv = None if vl is None else torch.tensor(
            vl, dtype=torch.int32, device=device)
        scale = 1.0 / (D ** 0.5)
        ref = fa.flash_attention_plain(q, k, v, kv, scale, causal)
        tile = fa.f32_tile(D)
        model = fa._f32_splits(B * H, T, T, bool(causal), fa._sms(device),
                               tuple(tile))
        best = None
        for split in flash_block_candidates(B * H, T, T, causal, D, tile):
            def step(split=split):
                fa.flash_attention_f32_split(q, k, v, split, scale, causal,
                                             kv)
                _sync(device)

            out = fa.flash_attention_f32_split(q, k, v, split, scale, causal,
                                               kv)
            err = float((out - ref).abs().max())
            ok = bool(within(out, ref, q, k, v, scale, causal)) \
                if within is not None else bool(torch.all(
                    (out - ref).abs() <= tol[0] + tol[1] * ref.abs()))
            step()
            faster = False
            if best is None:
                t0 = time.perf_counter()
                step()
                ms = (time.perf_counter() - t0) * 1e3
            else:
                t = paired_step_ms(best["step"], step, pairs)
                ms, best["ms"] = t["b_ms"], t["a_ms"]
                faster = t["delta_ms"] > 0  # the incumbent was slower
            rows.append({"shape": [B, H, T, D], "causal": bool(causal),
                         "kv_valid_len": vl, "split": list(split),
                         "ms": ms, "max_abs_err": err, "within_tol": ok,
                         "cost_model": list(model) == list(split)})
            if ok and (best is None or faster):
                best = {"split": split, "ms": ms, "step": step}
        if best is None:
            raise RuntimeError("no fp32 flash split within %s at %s"
                               % (tol, (B, H, T, D)))
        key = _flash_key(B * H, T, T, causal, D)
        winners[key] = {"split": list(best["split"]), "ms": best["ms"],
                        "cost_model_split": list(model)}
        if apply:
            get_store().put(key, {
                "config": {"split": list(best["split"])},
                "tuned_by": TUNED_BY + ".tune_flash_blocks",
                "swept_at": _utcnow(), "backend": _backend_name(),
                "objective": {"ms": best["ms"], "pairs": pairs,
                              "cost_model_split": list(model)}})
    return {"winners": winners, "rows": rows}
