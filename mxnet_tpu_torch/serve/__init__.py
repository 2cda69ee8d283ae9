"""Serving of the port (counterpart of ``mxnet_tpu/serve``): the
dynamic-batching ModelServer (DynamicBatcher, BucketedExecutor with one
CUDA graph per bucket, ServeMetrics; ``health``, ``swap_parameters`` and
``retune_buckets``) and the continuous-batching GenerativeServer over a paged KV
cache (PagedKVCache, PrefixCache, GenerativeMetrics), with speculative
decode through a draft (NGramDraft, ModelDraft) and chunked prefill;
``snapshot`` and ``load(snapshot=True)`` for a warm restart, ``stats()``
over the live servers."""
import weakref

from .batcher import (DynamicBatcher, ServeError, ServerBusy,  # noqa: F401
                      ServeTimeout)
from .decoder import (GenerationStream, GenerativeServer,  # noqa: F401
                      sample_tokens)
from .executor_pool import BucketedExecutor, PoolError  # noqa: F401
from .kv_cache import CacheError, PagedKVCache, PrefixCache  # noqa: F401
from .metrics import GenerativeMetrics, ServeMetrics  # noqa: F401
from .server import DEFAULT_BUCKETS, ModelServer  # noqa: F401
from .speculative import ModelDraft, NGramDraft  # noqa: F401

# live servers for the aggregate stats(); weak, so a dropped server never
# lingers
_SERVERS = weakref.WeakSet()


def _register(server):
    _SERVERS.add(server)


def load(prefix, epoch=0, input_names=("data",), ctx=None, snapshot=False,
         model=None, **server_kwargs):
    """Warm-start a served model.

    Default (``snapshot=False``): the export layout ``prefix-symbol.json``
    and ``prefix-NNNN.params`` (this package's or the JAX package's) as a
    ``SymbolBlock`` whose parameters carry the file's dtypes, on ``ctx``
    (``checkpoint.load_for_serving``), ready for ``ModelServer``, which
    captures the same bucket graphs as the exporting process's server.

    ``snapshot=True``: a ready server from an artifact ``serve.snapshot``
    wrote (either package's), every program it lists captured before the
    first request (``mxnet_tpu_torch.cache.snapshot``): a ``ModelServer``
    for a model artifact, a ``GenerativeServer`` for a generative one,
    which needs ``model=`` (the skeleton; the decode protocol is code).
    Extra kwargs reach the server's constructor."""
    if snapshot:
        from ..cache.snapshot import load_snapshot

        return load_snapshot(prefix, model=model, **server_kwargs)
    from ..checkpoint import load_for_serving

    return load_for_serving(prefix, epoch=epoch, input_names=input_names,
                            ctx=ctx)


def snapshot(server, prefix, input_names=None, epoch=0):
    """Write the serving artifact of a live, warmed server: for a
    ``ModelServer`` its export layout (``checkpoint.save_for_serving``)
    and config, for a ``GenerativeServer`` its checkpoint, config and the
    list of its programs (see ``load(prefix, snapshot=True)``)."""
    from ..cache.snapshot import save_snapshot

    return save_snapshot(server, prefix, input_names=input_names,
                         epoch=epoch)


def stats():
    """Every live server's ``stats()``, keyed by its name, and the
    process-wide count of step programs made (captured on the card), the
    port's counterpart of the JAX package's ``decode_compile_counter``."""
    from .step_graph import capture_counter

    return {"step_capture_counter": capture_counter.count,
            "servers": {s.name: s.stats() for s in list(_SERVERS)}}
