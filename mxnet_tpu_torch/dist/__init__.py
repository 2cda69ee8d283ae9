"""mxnet_tpu_torch.dist (counterpart of ``mxnet_tpu/dist``): the
overlapped, bucketed gradient exchange of data-parallel training, ZeRO
stages 1-3 and elastic recovery, over ``torch.distributed`` groups.

* :class:`GradientBucketer` / :class:`BackwardExchanger`: size-capped
  buckets in reverse-tape order, each launched as its last gradient lands
  in the backward (``register_post_accumulate_grad_hook``);
* :class:`HierarchicalAllreduce`: reduce-scatter in the fast group, the
  shard across the slow group (optionally fp16/int8/2-bit with error
  feedback, or through ``DistKVStore``), all-gather back;
  :class:`FlatAllreduce`, the one-level baseline;
* ZeRO (:mod:`.zero`): stage 1 shards the weight update and the optimizer
  state, 2 also the exchanged gradients, 3 also the weights between steps;
* :class:`ElasticTrainer` (:mod:`.elastic`): a lost rank's survivors form
  a smaller group and rejoin from the latest sharded checkpoint.

Wiring a trainer is one call, on every rank::

    mesh = parallel.make_mesh({"dp": world})
    handle = mxnet_tpu_torch.dist.attach(trainer, mesh, ici_axis="dp",
                                         average=True, zero=1)

after which ``autograd.backward`` launches the buckets as the gradients
land and ``trainer.step`` finishes the exchange
(``Trainer.allreduce_grads`` calls ``handle.finish()``). With ``zero=3``
call ``handle.gather_params()`` before each forward.
"""
from __future__ import annotations

from .hierarchical import HierarchicalAllreduce, FlatAllreduce  # noqa: F401
from .bucketer import (GradientBucketer, BackwardExchanger,  # noqa: F401
                       default_bucket_mb, bucket_counter, plan_counter)
from .zero import (Zero3ParamManager, shard_spec,  # noqa: F401
                   per_device_bytes, global_bytes)
from .elastic import ElasticTrainer, ElasticRun  # noqa: F401

__all__ = ["HierarchicalAllreduce", "FlatAllreduce", "GradientBucketer",
           "BackwardExchanger", "Zero3ParamManager", "ElasticTrainer",
           "ElasticRun", "attach", "detach", "stats", "shard_spec",
           "per_device_bytes", "global_bytes", "default_bucket_mb",
           "DistHandle"]

_EXCHANGERS = []


class DistHandle:
    """One trainer's attachment: the strategy, the bucketer, the backward
    exchanger and, at ZeRO-3, the parameter manager.
    ``Trainer.allreduce_grads`` calls :meth:`finish`; ZeRO-3 callers call
    :meth:`gather_params` before each forward."""

    def __init__(self, trainer, strategy, bucketer, exchanger, zero,
                 mesh, shard_axis, manager=None):
        self.trainer = trainer
        self.strategy = strategy
        self.bucketer = bucketer
        self.exchanger = exchanger
        self.zero = zero
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.manager = manager
        self.grad_shards = {}

    def finish(self):
        """Finish the step's exchange. At ZeRO-2 and 3 each gradient is then
        kept as this rank's block (``grad_shards``), its whole tensor
        released."""
        from .zero import block, shard_dim

        self.exchanger.register_params(self.trainer._params)
        done = self.exchanger.finish()
        self.grad_shards = {}
        if self.zero >= 2:
            n = int(self.mesh.shape[self.shard_axis])
            r = self.mesh.local_rank(self.shard_axis)
            for p, g in done:
                shape = self.manager.full_shapes[id(p)] \
                    if self.manager is not None else tuple(g.shape)
                d = shard_dim(shape, n)
                blk = g if d is None else block(g, d, r, n).clone()
                blk._full_shape = shape
                self.grad_shards[id(p)] = blk
                p._data.grad = None

    def gather_params(self):
        """ZeRO-3: rebuild the whole weights before a forward (no-op below
        stage 3)."""
        if self.manager is not None:
            self.manager.gather()

    def release_params(self):
        """ZeRO-3: back to this rank's blocks (no-op below stage 3)."""
        if self.manager is not None:
            self.manager.release()

    def detach(self):
        detach(self.trainer)


def attach(trainer, mesh, ici_axis="dp", dcn_axis=None, compression=None,
           zero=0, bucket_mb=None, average=False, dcn="jit",
           shard_axis=None, record_events=False):
    """Wire a gluon ``Trainer`` into the overlapped exchange, on every
    rank of ``mesh``. mesh/ici_axis/dcn_axis/compression/average/dcn
    configure the :class:`HierarchicalAllreduce`; ``zero`` picks the
    sharding stage (1: weight update and optimizer state, 2: + gradients,
    3: + weights), over ``shard_axis`` (default ``ici_axis``);
    ``bucket_mb`` overrides ``MXNET_DIST_BUCKET_MB``. Returns the
    :class:`DistHandle` (also ``trainer._dist``)."""
    strategy = HierarchicalAllreduce(mesh, ici_axis=ici_axis,
                                     dcn_axis=dcn_axis,
                                     compression=compression,
                                     average=average, dcn=dcn)
    shard_axis = shard_axis or ici_axis
    bucketer = GradientBucketer(strategy, bucket_mb=bucket_mb)
    exchanger = BackwardExchanger(bucketer, record_events=record_events)
    exchanger.register_params(trainer._params)
    manager = None
    if zero >= 3:
        manager = Zero3ParamManager(trainer._params, mesh,
                                    shard_axis=shard_axis,
                                    bucket_mb=bucket_mb)
    handle = DistHandle(trainer, strategy, bucketer, exchanger, zero, mesh,
                        shard_axis, manager)
    trainer._dist = handle
    trainer.set_weight_update_sharding(
        mesh, shard_axis if zero >= 1 else None)
    if manager is not None:
        manager.release()
    _EXCHANGERS.append(exchanger)
    return handle


def detach(trainer):
    """Undo :func:`attach`: the hooks go, the weights come back whole
    (ZeRO-3) and the weight update is no longer sharded."""
    handle = getattr(trainer, "_dist", None)
    if handle is None:
        return
    if handle.manager is not None and not handle.manager.gathered:
        handle.manager.gather()
    trainer.set_weight_update_sharding(None)
    trainer._dist = None
    handle.exchanger.remove_hooks()
    if handle.exchanger in _EXCHANGERS:
        _EXCHANGERS.remove(handle.exchanger)


def stats():
    """The exchange's state: attachments, bucket layouts and signatures,
    exchanges, the counters and the recorded elastic recoveries."""
    from . import elastic as _el

    agg = {"layouts": 0, "programs": 0, "exchanges": 0}
    windows = []
    for ex in _EXCHANGERS:
        s = ex.bucketer.stats()
        for k in agg:
            agg[k] += s[k]
        windows += ex.windows_ms
    return {
        "attached_trainers": len(_EXCHANGERS),
        "bucket_mb_default": default_bucket_mb(),
        "bucket_layouts": agg["layouts"],
        "bucket_programs": agg["programs"],
        "exchanges": agg["exchanges"],
        "bucket_launches": bucket_counter.count,
        "bucket_plans": plan_counter.count,
        "dist_overlap_window_ms": windows,
        "elastic_recoveries_recorded": len(_el.events),
        "last_recovery": _el.events[-1] if _el.events else None,
    }
