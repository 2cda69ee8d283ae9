"""Failure detection and resume (counterpart of
``mxnet_tpu/parallel/resilience.py``; ref: ps-lite's heartbeats).

A lost rank ends its group's collectives, so resilience is periodic
checkpoints and a resume that repeats the same math: :class:`ResumableLoop`
and :func:`run_resilient` checkpoint every N steps through
``checkpoint.save_sharded`` and restart from the latest one;
:class:`Heartbeat` times a tiny round trip on the device from a thread
and calls ``on_stall`` when one takes longer than ``timeout_s`` (a hung
collective); :class:`SimulatedFailure` is the drills' injected fault.
"""
from __future__ import annotations

import threading
import time

import torch

from .. import checkpoint as ckpt

__all__ = ["Heartbeat", "ResumableLoop", "SimulatedFailure",
           "run_resilient", "counters"]

# resilience events by name (stalls, checkpoint saves and restores)
counters = {}


def _note(name):
    counters[name] = counters.get(name, 0) + 1


class Heartbeat:
    """Watchdog: every ``interval_s`` a trivial computation on ``device``
    (default: this rank's, else the CPU) is timed; over ``timeout_s`` calls
    ``on_stall(elapsed)`` (default: print)."""

    def __init__(self, interval_s=30.0, timeout_s=120.0, on_stall=None,
                 device=None):
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.on_stall = on_stall or self._default_stall
        self.device = device
        self._stop = threading.Event()
        self._thread = None
        self.last_ok = time.time()

    def _default_stall(self, elapsed):
        print("[mxnet_tpu_torch.resilience] device heartbeat stalled %.1fs"
              % elapsed)

    def _tick(self):
        from . import distributed

        dev = self.device or distributed.device() or torch.device("cpu")
        t0 = time.time()
        x = torch.zeros((), device=dev) + 1
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.time() - t0

    def _run(self, stop_evt):
        while not stop_evt.wait(self.interval_s):
            elapsed = self._tick()
            if stop_evt.is_set():
                return
            if elapsed > self.timeout_s:
                _note("dist_heartbeat_stalls")
                self.on_stall(elapsed)
            else:
                self.last_ok = time.time()

    def start(self):
        # each start owns a fresh stop event, so a restart never revives or
        # doubles a watchdog; a live thread is signalled through its own
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(self._stop,),
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()


class ResumableLoop:
    """Checkpoint every N steps, resume from the latest."""

    def __init__(self, directory, every_steps=1000):
        self.directory = directory
        self.every = every_steps

    def latest(self):
        return ckpt.latest_step(self.directory)

    def maybe_save(self, step, pytree):
        if step % self.every == 0 and step > 0:
            ckpt.save_sharded(self.directory, pytree, step)
            self.note_save()
            return True
        return False

    def note_save(self):
        _note("dist_checkpoint_saves")

    def restore(self, like, step=None):
        """The ``step`` (default: latest) checkpoint on ``like``'s
        structure, dtypes and devices."""
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint in %s" % self.directory)
        state = ckpt.restore_sharded(self.directory, step, like=like)
        _note("dist_checkpoint_restores")
        return state


class SimulatedFailure(RuntimeError):
    """The drills' injected fault."""

    def __init__(self, step):
        super().__init__("simulated failure at step %d" % step)
        self.step = step


def run_resilient(step_fn, init_state, make_batch, num_steps, directory,
                  save_every=10, fail_at=None, heartbeat=None):
    """Train with a checkpoint every ``save_every`` steps, resuming from
    the latest one on (re)start. Exact resume needs ``step_fn(state,
    batch) -> state`` to carry everything that evolves in ``state`` and
    ``make_batch(step)`` to be a function of the global step. ``fail_at``
    raises :class:`SimulatedFailure` before that step. Returns (state,
    the step this run started from)."""
    start = 0
    last = ckpt.latest_step(directory)
    if last is not None:
        init_state = ckpt.restore_sharded(directory, last, like=init_state)
        _note("dist_checkpoint_restores")
        start = last
    state = init_state
    hb = heartbeat.start() if heartbeat is not None else None
    try:
        for step in range(start, num_steps):
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(step)
            state = step_fn(state, make_batch(step))
            done = step + 1
            if done % save_every == 0 or done == num_steps:
                ckpt.save_sharded(directory, state, done)
    finally:
        if hb is not None:
            hb.stop()
    return state, start
