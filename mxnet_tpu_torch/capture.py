"""CUDA-graph capture shared by the servers' step programs
(``serve/step_graph.py``, ``serve/executor_pool.py``), hybridized Gluon
blocks (``gluon/hybrid.py``) and the optimizer's fused step
(``optimizer.StepProgram``): the counterpart of the JAX package's one
compiled program per key.

Three problems meet every capture here, and each has one solution:

- Addresses. A graph reads and writes the tensors it was captured on, at
  their addresses. :class:`AddressBook` remembers the address last seen
  under each name (a state buffer, a parameter); when one moves (a
  parameter given a new tensor by ``set_data``, a cache migrated), the
  owner drops every program and captures each key again at its next use.
  A write into the live tensor (``copy_data``, a weight swap) keeps them.
- Warm-up. A graph needs eager runs before capture (lazy library set-up,
  on a side stream). :func:`capture_graph` runs them before capturing;
  callers hand it a warm-up that works on clones of the state it would
  change, so the live buffers are only read, and capture itself executes
  nothing.
- Launch counts. The kernels' launch counters are host integers, which a
  replay does not tick. The counts at capture are recorded per graph
  (:attr:`Graph.deltas`; the warm-up's and the capture's own are taken
  out) and added back at every :meth:`Graph.replay`, so a replay counts
  its kernels as the eager run does.

Random draws. A graph replays its kernels with the philox offsets of the
generators registered with it (``register_generator_state``), advanced at
every replay, so two replays draw different numbers; a generator handed
to :func:`capture_graph` is registered and its state put back as it was
before the warm-up, so the first replay draws what the eager run would
have drawn.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from .ops.cuda import launch_counters

__all__ = ["Graph", "AddressBook", "capture_graph", "collector_paused",
           "capture_counter", "clone_state", "WARMUP_RUNS"]

WARMUP_RUNS = 2


class _Counter:
    """Step programs made in this process (``serve.stats()`` reads it)."""

    count = 0


capture_counter = _Counter()


@contextlib.contextmanager
def collector_paused():
    """No cyclic garbage collection inside the block. A collection during a
    capture may free a dead server's CUDA graph (a server and its batcher
    hold each other), and destroying a graph while a stream captures
    invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def counters():
    """{name: the wrapper counting that kernel's launches}; a wrapper
    swapped for its plain version (a check that runs a model without the
    kernels) counts nothing and is left out."""
    return {name: fn for name, fn in launch_counters().items()
            if hasattr(fn, "launches")}


def clone_state(state):
    """A dict of tensors or lists of tensors, cloned."""
    return {k: v.clone() if isinstance(v, torch.Tensor)
            else [t.clone() for t in v] for k, v in state.items()}


class AddressBook:
    """The address last seen under each name. :meth:`moved` records the
    given ones and says whether any name's address changed."""

    def __init__(self):
        self._seen = {}

    def moved(self, addresses):
        seen = self._seen
        changed = any(seen.get(n, a) != a for n, a in addresses.items())
        if changed:
            seen.clear()
        seen.update(addresses)
        return changed

    def clear(self):
        self._seen.clear()


class Graph:
    """A captured graph, what its capture returned (``out``) and the
    launches it makes a replay (``deltas``)."""

    __slots__ = ("graph", "out", "deltas")

    def __init__(self, graph=None, out=None, deltas=None):
        self.graph = graph
        self.out = out
        self.deltas = deltas or {}

    def replay(self):
        self.graph.replay()
        add_launches(self.deltas)
        return self.out


def add_launches(deltas):
    found = counters()
    for name, n in deltas.items():
        if name in found:
            found[name].launches += n


def capture_graph(fn, device, pool, warmup=None, generators=(),
                  error_mode="thread_local", meter=None):
    """``fn()`` captured into a new ``torch.cuda.CUDAGraph`` in memory pool
    ``pool``, after ``warmup()`` (default ``fn``) ran :data:`WARMUP_RUNS`
    times on a side stream. ``generators`` are registered with the graph
    (graph-safe philox state) and put back as they were before the
    warm-up. ``meter`` (``observability.costs.meter``): the first warm-up
    run is counted into the program's cost profile (never the capture).
    The launch counters are left as they were. Returns a :class:`Graph`;
    the host seconds it took go to ``observability.note_compile``."""
    from .observability import costs, note_compile

    t0 = time.perf_counter()
    found = counters()
    before = {name: f.launches for name, f in found.items()}
    states = [g.get_state() for g in generators]
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_RUNS):
            costs.run_counted(meter, warmup or fn)
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for g, st in zip(generators, states):
        g.set_state(st)
        graph.register_generator_state(g)
    mid = {name: f.launches for name, f in found.items()}
    with collector_paused(), torch.cuda.graph(
            graph, pool=pool, capture_error_mode=error_mode):
        out = fn()
    deltas = {name: f.launches - mid[name] for name, f in found.items()
              if f.launches != mid[name]}
    for name, f in found.items():
        f.launches = before[name]
    note_compile(time.perf_counter() - t0)
    return Graph(graph, out, deltas)
