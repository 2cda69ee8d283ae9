"""gluon.contrib (ref: python/mxnet/gluon/contrib; counterpart of
``mxnet_tpu/gluon/contrib``). Only ``nn.SyncBatchNorm`` is ported so
far; the rest of contrib is ROADMAP.md A.17."""
from . import nn  # noqa: F401
