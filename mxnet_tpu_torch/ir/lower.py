"""mxnet_tpu_torch.ir.lower — one program per canonical graph (counterpart
of ``mxnet_tpu/ir/lower.py``).

The bulk window, ``Symbol.eval``, the ``Executor``'s inference forward and
``SymbolBlock`` land here with a typed Graph; lowering canonicalizes it,
looks its key up in ONE shared cache (``base._IR_CACHE``,
``MXNET_IR_CACHE_CAP``), runs the pass pipeline on a miss (the tuned
config from ``ir.tune`` when one is installed for the key, else
``DEFAULT_PASSES``), and builds the program the optimized graph denotes:

* on a CUDA device, ``capture.capture_graph`` of the optimized graph run
  op by op over static inputs, counted by ``observability.costs`` on its
  first warm-up. Not Inductor: a lowered program must give the op-by-op
  chain's bits, and Inductor fuses bf16 chains in fp32;
* on the CPU, the same runner eagerly, with the same keys and counts.

Only a real build bumps the owning capture's counter
(``engine.bulk_compile_counter`` / ``symbol_compile_counter``) with the
canonical key as the watchdog's note; a hit from another capture bumps
nothing ("2 captures, 1 build"). The tape has no forward region to share
(ops under ``record()`` run one by one): its backward reaches the IR at
compiled autograd's compiler hook, where :func:`tape_program` files the
compiled backward under the FX graph's canonical key.

Every captured program of a device shares one memory pool, and one entry
may serve several captures from several threads: copy-in, replay and
copy-out run under one lock (``_run_lock``), so a replay's outputs are
copied out before any other replay.
"""
from __future__ import annotations

import threading

import torch

from .. import base
from . import graph as _g
from . import passes as _p

__all__ = ["IREntry", "lower_forward", "prepare", "tape_program",
           "runner_for", "live", "program_count", "stats", "reset_stats"]

# entry and program publication (never held over a build)
_lock = threading.Lock()
# copy-in, replay and copy-out of every captured program
_run_lock = threading.Lock()
_pools = {}

# fixed keys (GL006): tools/torch_diagnose.py and the "ir" section
_BUILD_STATS = {"graph_builds": 0, "program_builds": 0,
                "tuned_builds": 0, "last_build": None}


class IREntry:
    """One canonical graph's cache entry: the pass-optimized graph, the
    capture maps and every program lowered from it (by kind and
    device)."""

    __slots__ = ("key", "graph", "leaf_sel", "slot_fwd", "programs",
                 "runners", "config", "nodes_canonical", "nodes_final",
                 "edges_canonical", "edges_final")

    def __init__(self, key, cgraph, pm=None, device=None):
        pm = pm or _p.PassManager()
        final, leaf_sel, slot_fwd = _p.optimize(cgraph, pm, device)
        self.key = key
        self.graph = final
        self.leaf_sel = leaf_sel      # program arg j -> canonical leaf
        self.slot_fwd = slot_fwd      # canonical slot -> final spec / None
        self.programs = {}
        self.runners = {}
        self.config = pm.config()
        self.nodes_canonical = cgraph.n_nodes
        self.nodes_final = final.n_nodes
        self.edges_canonical = cgraph.n_edges
        self.edges_final = final.n_edges


def _tuned_pm(key):
    from . import tune

    return tune.pass_manager_for(key)


def _counter(kind):
    from .. import engine

    return {"bulk": engine.bulk_compile_counter,
            "tape": engine.tape_compile_counter,
            "symbol": engine.symbol_compile_counter}[kind]


def prepare(raw_graph, device=None, passes=True):
    """(canonical, entry): canonicalize a capture's graph and get (or build)
    its shared entry; the passes run once a canonical key. ``passes=False``
    keeps the canonical graph as it is (the tape's FX graphs)."""
    canon = _g.canonicalize(raw_graph)
    key = _g.canonical_key(canon.graph)
    ent = base._IR_CACHE.get(key)
    if ent is None:
        with _lock:
            ent = base._IR_CACHE.get(key)
            if ent is None:
                pm = _tuned_pm(key) if passes else _p.PassManager(())
                tuned = passes and pm is not None
                ent = base._IR_CACHE[key] = IREntry(key, canon.graph, pm,
                                                    device)
                _BUILD_STATS["graph_builds"] += 1
                _BUILD_STATS["tuned_builds"] += int(tuned)
                _BUILD_STATS["last_build"] = {
                    "key": key[:16], "tuned": tuned,
                    "nodes_captured": raw_graph.n_nodes,
                    "nodes_canonical": ent.nodes_canonical,
                    "nodes_final": ent.nodes_final,
                    "edges_canonical": ent.edges_canonical,
                    "edges_final": ent.edges_final}
    return canon, ent


class _CapturedProgram:
    """A lowered forward on the card: the optimized graph captured as one
    CUDA graph over static inputs (a Python scalar leaf becomes a 0-d
    tensor, which the registry ops treat as they treat the scalar)."""

    def __init__(self, ent, args, device, meter):
        from ..capture import capture_graph

        self.entry = ent
        with torch.no_grad():
            self.static = [a.detach().clone() if isinstance(a, torch.Tensor)
                           else torch.tensor(a, device=device) for a in args]
        if device.index not in _pools:
            _pools[device.index] = torch.cuda.graph_pool_handle()
        run = _g.build_runner(ent.graph, device)
        static = self.static

        def fwd():
            with torch.no_grad():
                return list(run(static))

        self.graph = capture_graph(fwd, device, _pools[device.index],
                                   meter=meter)

    def __call__(self, args):
        with _run_lock, torch.no_grad():
            for s, a in zip(self.static, args):
                if isinstance(a, torch.Tensor):
                    s.copy_(a)
                else:
                    s.fill_(a)
            return [o.clone() for o in self.graph.replay()]


class _EagerProgram:
    """A lowered forward on the CPU: the optimized graph run op by op, its
    first run counted."""

    def __init__(self, ent, device, meter):
        self.entry = ent
        self.run = _g.build_runner(ent.graph, device)
        self.meter = meter

    def __call__(self, args):
        from ..observability import costs

        with torch.no_grad():
            if self.meter is not None and not self.meter.done:
                outs = list(costs.run_counted(self.meter,
                                              lambda: self.run(args)))
            else:
                outs = list(self.run(args))
            # outputs CSE merged are one tensor here, two in the op-by-op
            # chain: each caller gets its own
            seen = set()
            for i, o in enumerate(outs):
                if id(o) in seen:
                    outs[i] = o.clone()
                seen.add(id(o))
            return outs


def lower_forward(raw_graph, kind, args, hint=None, device=None):
    """``(prog, arg_sel)`` of a forward capture: ``prog(values)`` runs the
    optimized program (shared across captures through the canonical key)
    and returns the outputs, ``arg_sel[j]`` is the capture's leaf to pass
    as argument ``j``. ``args`` are the capture's leaf values (a captured
    program copies them into its static inputs). Only a real build bumps
    ``kind``'s counter."""
    from ..observability import costs

    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), torch.device("cpu"))
    canon, ent = prepare(raw_graph, device)
    sel = tuple(canon.leaf_perm[c] for c in ent.leaf_sel)
    pkey = ("fwd", str(device))
    prog = ent.programs.get(pkey)
    if prog is None:
        note = "%s:%s" % (kind, ent.key[:16])
        meter = costs.meter(kind + "_compile", hint or note, device)
        # built outside the lock (GL013: a capture takes a while); the
        # double-checked publish keeps one winner, the only build counted
        fresh = _CapturedProgram(ent, [args[i] for i in sel], device,
                                 meter) if device.type == "cuda" \
            else _EagerProgram(ent, device, meter)
        with _lock:
            prog = ent.programs.get(pkey)
            if prog is None:
                _counter(kind).bump(note=note)
                prog = ent.programs[pkey] = fresh
                _BUILD_STATS["program_builds"] += 1
    return prog, sel


def live(prog):
    """Is ``prog``'s entry still the canonical cache's? (A front memo over
    the cache lowers again when not: an eviction, or a tuned config
    installed since.)"""
    ent = prog.entry
    return base._IR_CACHE.get(ent.key) is ent


def runner_for(raw_graph, device=None):
    """``(run, arg_sel)``: the optimized graph's op-by-op runner, built
    into no program of its own: ``SymbolBlock`` runs it inside the
    caller's capture (a served bucket's, a hybridized key's)."""
    canon, ent = prepare(raw_graph, device)
    sel = tuple(canon.leaf_perm[c] for c in ent.leaf_sel)
    rkey = str(device)
    run = ent.runners.get(rkey)
    if run is None:
        run = ent.runners[rkey] = _g.build_runner(ent.graph, device)
    return run, sel


def tape_program(ent, variant_key, builder, hint="tape"):
    """The tape program ``builder()`` makes for an entry (the tape's
    backward: ``torch.compile`` of the FX graph compiled autograd hands
    its hook), once per ``variant_key``. A real build bumps
    ``engine.tape_compile_counter`` with the canonical key as the note and
    records an uncounted cost profile under that key."""
    from ..observability import costs

    pkey = ("tape", variant_key)
    prog = ent.programs.get(pkey)
    if prog is None:
        fresh = builder()
        with _lock:
            prog = ent.programs.get(pkey)
            if prog is None:
                _counter("tape").bump(note="tape:%s" % ent.key[:16])
                costs.note_uncounted(
                    "tape_compile", hint, ent.key,
                    "built by torch.compile from the backward it runs, "
                    "which that run consumes: there is no eager first run "
                    "to count, and a FlopCounterMode over a compiled "
                    "callable sees none of its ops", key=ent.key[:16])
                prog = ent.programs[pkey] = fresh
                _BUILD_STATS["program_builds"] += 1
    return prog


def program_count():
    """Live programs across all entries: what the cross-capture test pins
    to 1."""
    return sum(len(e.programs) for e in list(base._IR_CACHE.values())
               if isinstance(e, IREntry))


def stats():
    """The observability "ir" section and the diagnose tool's payload."""
    c = base._IR_CACHE
    return {
        "cache": {"entries": len(c), "cap": c.cap,
                  "evictions": c.evictions, "programs": program_count()},
        "interner": _g.interner_stats(),
        "builds": dict(_BUILD_STATS),
        "passes": _p.pass_stats(),
    }


def reset_stats():
    """Zero the build tallies (the cache stays warm)."""
    _BUILD_STATS["graph_builds"] = 0
    _BUILD_STATS["program_builds"] = 0
    _BUILD_STATS["tuned_builds"] = 0
    _BUILD_STATS["last_build"] = None
