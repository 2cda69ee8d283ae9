"""Elastic training: recovery drills over a shrinking group (counterpart
of ``mxnet_tpu/dist/elastic.py``).

A rank lost mid-run does not leave the others running one short: the
survivors form a smaller group (``make_mesh(..., devices=survivors)``, a
``new_group`` of them), restore the latest sharded checkpoint and rejoin
at its global step. :class:`ElasticTrainer` drives that loop; its drill
(``fail_at``) raises a :class:`~mxnet_tpu_torch.parallel.resilience.
SimulatedFailure` before a step on every rank, after which the ranks left
out of ``survivors`` stop (as a lost rank would) and the survivors go on.
The batch schedule is a function of the global step, so the recovered run
repeats the uninterrupted one's math; only the reduction's layout
changes. Each recovery is recorded in ``events``.
"""
from __future__ import annotations

import time

from .. import checkpoint as ckpt
from ..parallel.mesh import make_mesh
from ..parallel.resilience import ResumableLoop, SimulatedFailure

_EVENT_CAP = 64
events = []


def _record_event(evt):
    if len(events) >= _EVENT_CAP:
        del events[0]
    events.append(evt)


class ElasticRun:
    """One elastic run's result: the final state (None on a rank that
    left), the losses by global step, the recoveries, the last mesh and
    the step the run started from."""

    __slots__ = ("state", "losses", "recoveries", "mesh", "start_step",
                 "left")

    def __init__(self, state, losses, recoveries, mesh, start_step,
                 left=False):
        self.state = state
        self.losses = losses
        self.recoveries = recoveries
        self.mesh = mesh
        self.start_step = start_step
        self.left = left


class ElasticTrainer:
    """Checkpointed training that survives the loss of ranks.

    build_step(mesh) -> (step_fn, place_state):
        ``step_fn(state, batch) -> (state, loss)``, this rank's step over
        the mesh's group; ``place_state(state, mesh) -> state`` lays a
        restored or initial state out for that mesh. It is built again for
        every mesh: after a loss the group is smaller.
    make_batch(step):
        the global batch of ``step``, the same on every rank and for every
        mesh (the step function takes this rank's part of it).
    """

    def __init__(self, build_step, init_state, make_batch, directory,
                 save_every=5, heartbeat=None, axis="dp"):
        self.build_step = build_step
        self.init_state = init_state
        self.make_batch = make_batch
        self.directory = directory
        self.save_every = int(save_every)
        self.heartbeat = heartbeat
        self.axis = axis
        self.recoveries = []

    def _mesh(self, ranks):
        return make_mesh({self.axis: len(ranks)}, devices=ranks)

    def _restore_or_init(self, loop, mesh, place):
        last = loop.latest()
        if last is not None:
            return place(loop.restore(like=self.init_state), mesh), last
        return place(self.init_state, mesh), 0

    def _save(self, loop, mesh, state, step):
        """The mesh's first rank writes; the others wait for the file."""
        import torch.distributed as dist

        if mesh.local_rank(self.axis) == 0:
            ckpt.save_sharded(self.directory, state, step)
            loop.note_save()
        if mesh.size > 1:
            dist.barrier(group=mesh.group(self.axis))

    def run(self, num_steps, devices=None, fail_at=None, survivors=None):
        """Train to ``num_steps``. ``devices``: the ranks to start on
        (default: all). ``fail_at`` arms the drill: before that step the
        group shrinks to ``survivors`` (default: the first half), which
        restore the latest checkpoint and go on."""
        import torch.distributed as dist

        ranks = list(devices) if devices is not None else \
            list(range(dist.get_world_size()))
        loop = ResumableLoop(self.directory, self.save_every)
        mesh = self._mesh(ranks)
        step_fn, place = self.build_step(mesh)
        state, start = self._restore_or_init(loop, mesh, place)
        first_start = start
        losses = {}
        hb = self.heartbeat.start() if self.heartbeat is not None else None
        armed = fail_at
        try:
            step = start
            while step < num_steps:
                try:
                    if armed is not None and step == armed:
                        armed = None   # one failure a drill
                        raise SimulatedFailure(step)
                    state, loss = step_fn(state, self.make_batch(step))
                    losses[step] = float(loss)
                    step += 1
                    if step % self.save_every == 0 or step == num_steps:
                        self._save(loop, mesh, state, step)
                except SimulatedFailure as e:
                    ranks = list(survivors) if survivors is not None \
                        else ranks[:max(1, len(ranks) // 2)]
                    mesh = self._mesh(ranks)
                    if not mesh.is_member:
                        return ElasticRun(None, losses, list(self.recoveries),
                                          mesh, first_start, left=True)
                    step_fn, place = self.build_step(mesh)
                    state, resumed = self._restore_or_init(loop, mesh, place)
                    step = resumed
                    evt = {"event": "elastic_recovery",
                           "failed_step": e.step,
                           "survivors": len(ranks),
                           "resumed_from": resumed,
                           "ts": time.time()}
                    self.recoveries.append(evt)
                    _record_event(evt)
        finally:
            if hb is not None:
                hb.stop()
        return ElasticRun(state, losses, list(self.recoveries), mesh,
                          first_start)
