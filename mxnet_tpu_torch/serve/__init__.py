"""Serving of the port (counterpart of ``mxnet_tpu/serve``): the
dynamic-batching ModelServer (DynamicBatcher, BucketedExecutor,
ServeMetrics) and the continuous-batching GenerativeServer over a paged KV
cache (PagedKVCache, PrefixCache, GenerativeMetrics), with speculative
decode through a draft (NGramDraft, ModelDraft) and chunked prefill."""
from .batcher import (DynamicBatcher, ServeError, ServerBusy,  # noqa: F401
                      ServeTimeout)
from .decoder import (GenerationStream, GenerativeServer,  # noqa: F401
                      sample_tokens)
from .executor_pool import BucketedExecutor, PoolError  # noqa: F401
from .kv_cache import CacheError, PagedKVCache, PrefixCache  # noqa: F401
from .metrics import GenerativeMetrics, ServeMetrics  # noqa: F401
from .server import DEFAULT_BUCKETS, ModelServer  # noqa: F401
from .speculative import ModelDraft, NGramDraft  # noqa: F401
