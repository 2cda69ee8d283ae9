"""``mx.executor`` (counterpart of ``mxnet_tpu/executor.py``; ref:
python/mxnet/executor.py): the upstream import location of
:class:`~mxnet_tpu_torch.symbol.Executor`, which lives in ``symbol.py``."""
from __future__ import annotations

from .symbol import Executor  # noqa: F401

__all__ = ["Executor"]
