"""Dynamic-batching inference serving of the port (counterpart of
``mxnet_tpu/serve``: ModelServer, DynamicBatcher, BucketedExecutor,
ServeMetrics)."""
from .batcher import (DynamicBatcher, ServeError, ServerBusy,  # noqa: F401
                      ServeTimeout)
from .executor_pool import BucketedExecutor, PoolError  # noqa: F401
from .metrics import ServeMetrics  # noqa: F401
from .server import DEFAULT_BUCKETS, ModelServer  # noqa: F401
