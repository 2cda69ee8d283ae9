"""Worker factories of the port's fleet (``mxnet_tpu_torch.serve.fleet``):
the twin of ``tools/fleet_factory.py``, whose factories have the same names
and the same crc32-seeded weights.

``python -m mxnet_tpu_torch.serve.worker --factory
tools/torch_fleet_factory.py:NAME`` resolves them by file path (``tools/``
is not a package). Each factory takes its device (``device="cuda"`` by
default); a worker process is given a factory that names its device, so the
CPU tests use the ``*_cpu`` factories. A worker inherits no ``with ctx:``.

Every parameter gets a draw seeded by crc32 of its name (stable across
processes, unlike ``hash()``), so all replicas of a pool serve the same
model, and a block built in a thread of its own (fresh block names) gets
the JAX factory's weights: a request retried on a sibling after a kill -9
returns what the dead worker would have.

``gpt2_small_server`` and ``bert_base_model`` are the card's: GPT-2 small
and BERT-base at their published widths, bf16, seeded by crc32 of each
parameter's structural name (``0.weight``-style, independent of block
numbering) at a std of 0.02.
"""
import functools
import zlib

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon

FEAT = 16
CLASSES = 10


def _set(p, a):
    p.set_data(torch.from_numpy(a).to(device=p.device, dtype=p.dtype))


def _det_weights(net, salt=0):
    """Every parameter a crc32(name)-seeded draw, as the JAX factory's."""
    for name, p in sorted(net.collect_params().items()):
        rng = np.random.default_rng(zlib.crc32(name.encode()) + salt)
        _set(p, rng.standard_normal(p.shape).astype(np.float32) * 0.1)


def _structural_weights(net, std, salt=0):
    """Every parameter a crc32(structural name)-seeded draw of ``std``;
    norm gammas one, biases and betas zero."""
    for name, p in sorted(net._collect_params_with_prefix().items()):
        if name.endswith(("gamma",)):
            a = np.ones(p.shape, np.float32)
        elif name.endswith(("bias", "beta")):
            a = np.zeros(p.shape, np.float32)
        else:
            rng = np.random.default_rng(zlib.crc32(name.encode()) + salt)
            a = rng.standard_normal(p.shape).astype(np.float32) * std
        _set(p, a)


def _mlp(device, salt=0):
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(24, activation="relu"))
        net.add(gluon.nn.Dense(CLASSES))
    net.initialize(device=device)
    net(torch.zeros((1, FEAT), device=device))  # materialize the shapes
    _det_weights(net, salt=salt)
    net.hybridize()
    return net


def model_server(device="cuda"):
    """Plain batch-serving replica: small buckets, roomy queue."""
    return mx.serve.ModelServer(_mlp(device), [((FEAT,), "float32")],
                                buckets=(1, 2, 4), max_wait_ms=1.0,
                                max_queue=64, timeout_ms=30000.0,
                                device=device)


def model_server_tiny_queue(device="cuda"):
    """One replica's ceiling: a 4-deep admission queue sheds under any
    real wave (what scale-out adds a sibling for)."""
    return mx.serve.ModelServer(_mlp(device), [((FEAT,), "float32")],
                                buckets=(1, 2, 4), max_wait_ms=1.0,
                                max_queue=4, timeout_ms=30000.0,
                                device=device)


def model_server_slow_tiny_queue(device="cuda"):
    """The tiny queue plus about 20 ms a batch of simulated device time,
    so a wave fills the queue on a small host."""
    import time

    srv = model_server_tiny_queue(device)
    orig = srv._batcher._dispatch_fn

    def slow(requests, total_rows):
        time.sleep(0.02)
        return orig(requests, total_rows)

    srv._batcher._dispatch_fn = slow
    return srv


def model_server_int8(device="cuda"):
    """int8 replica: its live parameters are qweight/w_scale pages, so an
    fp32 checkpoint pushed at it is refused (409)."""
    return mx.serve.ModelServer(_mlp(device), [((FEAT,), "float32")],
                                buckets=(1, 2, 4), max_wait_ms=1.0,
                                max_queue=64, timeout_ms=30000.0,
                                quantize="int8", device=device)


def model_server_v2(device="cuda"):
    """The same architecture with other weights: the hot swap's new
    build."""
    return mx.serve.ModelServer(_mlp(device, salt=1), [((FEAT,), "float32")],
                                buckets=(1, 2, 4), max_wait_ms=1.0,
                                max_queue=64, timeout_ms=30000.0,
                                device=device)


def generative_server(device="cuda"):
    """A tiny GPT decode replica (2 slots) with the prefix cache on: the
    session-affinity and prefix-migration scenarios."""
    from mxnet_tpu_torch.models.gpt import gpt_nano

    m = gpt_nano()
    m.initialize(device=device)
    _det_weights(m)
    return mx.serve.GenerativeServer(m, slots=2, max_wait_ms=1.0,
                                     timeout_ms=60000.0, device=device)


# the CPU tests' factories: a worker is given the device by its factory
model_server_cpu = functools.partial(model_server, "cpu")
model_server_tiny_queue_cpu = functools.partial(model_server_tiny_queue,
                                                "cpu")
model_server_slow_tiny_queue_cpu = functools.partial(
    model_server_slow_tiny_queue, "cpu")
model_server_int8_cpu = functools.partial(model_server_int8, "cpu")
model_server_v2_cpu = functools.partial(model_server_v2, "cpu")
generative_server_cpu = functools.partial(generative_server, "cpu")

# ------------------------------------------------------------- the card's
GPT2_SLOTS = 8
WEIGHT_STD = 0.02
# the fleet's GPT-2 worker is warmed for prompts of up to 128 tokens and
# streams of up to 256: the watchdog, armed at its ready line, sees no
# build in traffic
GPT2_PROMPT_BUCKETS = (64, 128)
GPT2_MAX_TOKENS = 256


def gpt2_small_model(device="cuda"):
    """GPT-2 small (12 x 768, 12 heads, vocab 50257, context 1024), bf16,
    crc32-seeded weights."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.gpt import gpt2_small

    m = gpt2_small(dropout=0.0)
    m.initialize(device=device)
    _structural_weights(m, WEIGHT_STD)
    amp.convert_hybrid_block(m, "bfloat16")
    return m


def gpt2_small_server(device="cuda"):
    """GPT-2 small's GenerativeServer: 8 slots, greedy-capable, prefix
    cache on."""
    return mx.serve.GenerativeServer(gpt2_small_model(device),
                                     slots=GPT2_SLOTS, max_wait_ms=1.0,
                                     timeout_ms=600000.0, device=device,
                                     prefix_cache=True,
                                     name="gen:gpt2_small")


def gpt2_small_fleet_server(device="cuda"):
    """:func:`gpt2_small_server`, warmed for the fleet's traffic."""
    srv = gpt2_small_server(device)
    srv.warmup(prompt_buckets=GPT2_PROMPT_BUCKETS,
               max_tokens=GPT2_MAX_TOKENS)
    return srv


def bert_base_model(device="cuda", max_length=512):
    """BERT-base (12 x 768, 12 heads, vocab 30522), bf16, crc32-seeded
    weights, dropout 0 (served rows are deterministic)."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.bert import bert_base

    m = bert_base(dropout=0.0, max_length=max_length)
    m.initialize(device=device)
    _structural_weights(m, WEIGHT_STD)
    amp.convert_hybrid_block(m, "bfloat16")
    return m
