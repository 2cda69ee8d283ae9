"""Shared pieces of the PyTorch port's parity tests (tests/test_torch_port_*).

Inputs are made from a seed with numpy and handed to both packages; the JAX
package runs on the CPU as its own tests run it. Tolerances follow
tests/test_kernels.py: fp32 1e-4, bf16 0.05 absolute.
"""
import jax
import jax._src.core as _jax_core
import numpy as np
import pytest
import torch

# the fifteen optimizers, each with settings that reach its every branch
from chip_smoke import OPTIMIZER_KW  # noqa: F401

# a small BERT: 2 layers, 128 units, 2 heads of 64, FFN 256
SMALL_BERT = dict(vocab_size=1000, units=128, hidden_size=256, num_layers=2,
                  num_heads=2, max_length=64)
SEQ = 64
# a small GPT: 2 layers, 128 units, 2 heads of 64, FFN 512, vocab 256
SMALL_GPT = dict(vocab_size=256, units=128, num_layers=2, num_heads=2,
                 max_length=512, dropout=0.0)
# the JAX package's fused_update donates one buffer twice for these fresh
# states (FTML's is one zeros array three times, fp32 DCASGD's holds the
# weight itself): a JAX Trainer stepping them takes its per-parameter path
JAX_DOUBLE_DONATION = ("ftml", "dcasgd")


def numpy_uniform(scale=0.07, seed=0):
    """The JAX package's default initializer, ``Uniform(0.07)``, drawn by
    numpy: weights uniform in +-``scale``; biases, betas and moving means
    0, gammas and moving variances 1, as ``Initializer`` sets them. It
    compiles no threefry draw or fill for each shape, which is most of a
    deep model's first forward in the JAX package on the CPU."""
    import mxnet_tpu as jmx

    class NumpyUniform(jmx.init.Initializer):
        def __init__(self):
            super().__init__(scale=scale)
            self._rng = np.random.default_rng(seed)

        def _init_zero(self, name, arr):
            self._set(arr, np.zeros(tuple(arr.shape), np.float32))

        def _init_one(self, name, arr):
            self._set(arr, np.ones(tuple(arr.shape), np.float32))

        def _init_weight(self, name, arr):
            self._set(arr, self._rng.uniform(-scale, scale, tuple(arr.shape))
                      .astype(np.float32))

    return NumpyUniform()


@pytest.fixture
def sgld_without_noise(monkeypatch):
    """SGLD's noise drawn as zeros in both packages (their streams, threefry
    and Philox, cannot match)."""
    import jax.numpy as jnp
    from mxnet_tpu_torch import optimizer as topt

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.zeros(shape, dtype))
    monkeypatch.setattr(topt.SGLD, "_noise",
                        lambda self, w: torch.zeros_like(w))


@pytest.fixture
def few_threads():
    """torch's CPU ops on 2 threads for the test, then the count it had:
    the suite runs one worker a core or so, and a worker's intra-op
    threads on every core contend with the others' (the vision files'
    small convolutions ran many times slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# The JAX package reads ``jax.core.trace_state_clean``, which newer jax
# releases keep only under ``jax._src.core``. It reads it on every op that
# compiles something new, so whether one of its tests meets the missing name
# depended on what the tests before it in the same process had compiled.
# Expose it once, for the whole session, as soon as this module is
# collected (the package itself is left as it is). The JAX package's tests
# that run in the same process get it too; a run of those files alone does
# not import this module and does not.
if not hasattr(jax.core, "trace_state_clean"):
    jax.core.trace_state_clean = _jax_core.trace_state_clean


@pytest.fixture
def jax_trace_state():
    """Kept for the tests that name it: the alias above is set at import."""


@pytest.fixture(scope="module")
def jax_trace_state_module():
    """``jax_trace_state`` for a module's shared fixtures."""


def bert_inputs(seed, batch, seq=SEQ, vocab=SMALL_BERT["vocab_size"]):
    """(tokens, token_types, valid_length) int32, valid lengths in [1, seq]."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    tt = rng.randint(0, 2, (batch, seq)).astype(np.int32)
    vl = rng.randint(1, seq + 1, (batch,)).astype(np.int32)
    vl[0] = seq
    return tok, tt, vl


def jax_bert(bf16):
    """The JAX package's small BERT, initialized, optionally bf16 via amp."""
    from mxnet_tpu import amp
    from mxnet_tpu.models.bert import BERTModel

    model = BERTModel(**SMALL_BERT)
    model.initialize()
    if bf16:
        amp.convert_hybrid_block(model, "bfloat16")
    return model


def jax_params(model):
    return {p.name: np.asarray(p.data()._data)
            for p in model.collect_params().values()}


def port_bert_from(jmodel):
    """The port's small BERT on the CPU, weights carried from ``jmodel``."""
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.bert import BERTModel

    return from_jax_params(BERTModel(**SMALL_BERT), jax_params(jmodel))


def assert_rows_close(a, b, vl, atol, rtol=0.0):
    """Compare (B, T, ...) outputs on each example's real rows only."""
    for i, n in enumerate(vl):
        np.testing.assert_allclose(np.asarray(b[i, :n], np.float32),
                                   np.asarray(a[i, :n], np.float32),
                                   atol=atol, rtol=rtol)


def jax_gpt(bf16=False, **overrides):
    """The JAX package's small GPT, initialized, optionally bf16 via amp."""
    from mxnet_tpu import amp
    from mxnet_tpu.models.gpt import GPTModel

    model = GPTModel(**dict(SMALL_GPT, **overrides))
    model.initialize()
    if bf16:
        amp.convert_hybrid_block(model, "bfloat16")
    return model


def port_gpt_from(jmodel, **overrides):
    """The port's small GPT on the CPU, weights carried from ``jmodel``."""
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.models.gpt import GPTModel

    return from_jax_params(GPTModel(**dict(SMALL_GPT, **overrides)),
                           jax_params(jmodel))


def f32(a):
    """A tensor, an NDArray or a jax array as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().copy()
    return np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a,
                      np.float32)


def rel_l2(a, b):
    """|a - b| / |b| in L2."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def local_params(model):
    """{name under the model's root prefix: Parameter}."""
    return {p.name[len(model.prefix):]: p
            for p in model.collect_params().values()}


def jax_class_step(model, trainer, x, y):
    """One JAX Gluon step of a classifier: ``SoftmaxCrossEntropyLoss`` of
    model(x) against int labels y inside ``record()``, ``backward``,
    ``trainer.step``; (per-sample loss, {name: gradient})."""
    import mxnet_tpu as mx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon

    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        loss = loss_fn(model(x), mx.nd.array(y, dtype="int32"))
    jag.backward(loss)
    grads = {n: f32(p.grad()) for n, p in local_params(model).items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    return f32(loss), grads


def port_class_step(model, trainer, x, y):
    """:func:`jax_class_step` through the port."""
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(model(x), torch.from_numpy(y))
    autograd.backward(loss)
    grads = {n: f32(p.grad()) for n, p in local_params(model).items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    return f32(loss), grads


@pytest.fixture(scope="module", autouse=False)
def jax_rng_kept():
    """Leave the JAX package's global random stream as the module found it:
    a later file in the same test worker that initializes a JAX model
    unseeded draws the weights it would have drawn without this module."""
    from mxnet_tpu import random as jrandom

    state = jrandom.get_state()
    yield
    jrandom.set_state(state)


# a group of the multi-rank workers starts and runs its cases in 19-28 s
# under the suite's six workers (the dist and example workers' are the
# longest): a stuck rank fails its module in about three times that, not
# at the suite's limit
RANK_TIMEOUT = 80


def run_ranks(worker, workdir, inp, world):
    """Write ``inp`` to ``workdir``/inputs.npz, run ``world`` processes of
    the multi-rank ``worker`` (``tests/torch_port_dist_worker.py``'s
    protocol: ``worker RANK WORLD WORKDIR``, a gloo group through a file
    store in ``workdir``) and return {case: [rank 0's results, ...]}; a
    rank that failed, or a case that raised on one, fails the caller."""
    return run_rank_groups([(worker, workdir, inp, world)])[0]


def run_rank_groups(groups, timeout=RANK_TIMEOUT, meanwhile=None):
    """:func:`run_ranks` for several ``(worker, workdir, inp, world)``
    groups at once, each in its own directory and store; every process
    gets ``timeout`` seconds from the start, then is killed and fails
    the caller. ``meanwhile()`` runs in this process while they do (a
    reference computation). Returns one result a group."""
    import os
    import subprocess
    import sys
    import time

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXNET_DIST", "JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "1"
    started = []
    for worker, workdir, inp, world in groups:
        np.savez(workdir / "inputs.npz", **inp)
        started.append([subprocess.Popen(
            [sys.executable, worker, str(r), str(world), str(workdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True) for r in range(world)])
    deadline = time.monotonic() + timeout
    logs = [[] for _ in groups]
    try:
        if meanwhile is not None:
            meanwhile()
        for g, procs in enumerate(started):
            for p in procs:
                try:
                    logs[g].append(p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs[g].append(p.communicate()[0] + "\n[killed after "
                                   "%d s]" % timeout)
    finally:
        for procs in started:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return [_rank_results(workdir, world, procs, log)
            for (_, workdir, _, world), procs, log in zip(groups, started,
                                                           logs)]


def _rank_results(workdir, world, procs, logs):
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, log[-4000:])
    res = [dict(np.load(workdir / ("rank%d.npz" % r))) for r in range(world)]
    out = {}
    for r, d in enumerate(res):
        for k, v in d.items():
            case, _, key = k.partition("/")
            if not key:
                out.setdefault("top", [{} for _ in range(world)])[r][case] = v
                continue
            out.setdefault(case, [{} for _ in range(world)])[r][key] = v
    for case, per in out.items():
        for r, d in enumerate(per):
            assert "error" not in d, "rank %d, case %s:\n%s" % (
                r, case, d["error"])
    return out


# A resize parts the port's uint8 pixels from ``jax.image.resize``'s where
# the two sums land on either side of an integer (truncation; XLA's fused
# weights differ from numpy's in the last bit at about 0.1% of them): held
# to at most this share of the pixels, each one level apart (measured: the
# fixture's ImageRecordIter batch 0.41% of its values,
# tools/gen_torch_image_fixture.py; a 37x53 crop of it resized 0.57-0.87%)
RESIZE_PARTED_SHARE = 0.01
# the same for outputs of 64 pixels or fewer a side, where a smooth
# region's flat pixels are a larger part (measured on 24x24 outputs of the
# fixture's crops: 1.0-6.6% of the pixels)
RESIZE_PARTED_SHARE_SMALL = 0.08
# where a flat fill covers much of the image (DetRandomPadAug's canvas, 127
# outside the picture): a flat region's exact value is an integer, which
# either float sum may land a hair under (measured: the detection batches
# of test_torch_port_image_iter.py 17-20% of the values; a 300x400 image
# two thirds flat, resized to 64-341 pixels a side, 5-39%)
RESIZE_PARTED_SHARE_FLAT = 0.4


def assert_resized_close(got, want, level=1.0, share=RESIZE_PARTED_SHARE,
                         per_pixel=False):
    """``got`` equal to ``want`` but for at most ``share`` of the values
    (of the HWC pixels with ``per_pixel``: a color mix spreads a pixel's
    one level over its channels), each within one uint8 level (``level``:
    a level in the output's units, e.g. 1/std after normalization) plus
    fp32 1e-4 relative."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = 1e-4 * np.maximum(1.0, np.abs(want))
    diff = np.abs(got - want)
    parted = diff > tol
    if per_pixel:
        parted = parted.any(axis=-1)
    assert parted.mean() <= share, parted.mean()
    assert (diff <= level * 1.0001 + tol).all(), diff.max()


@pytest.fixture
def keep_block_names():
    """Both packages' automatic block names (``hybridsequential0_``, ...)
    counted on after the test as if it had made no block: a test that
    builds blocks in one package only leaves the two counters as they
    were, so a later test in the same process that compares the names
    both packages give sees them in step."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    saved = [(m, dict(getattr(m._naming, "counters", {})))
             for m in (jblock, tblock)]
    yield
    for m, counters in saved:
        m._naming.counters = counters


@pytest.fixture
def same_block_names():
    """Both packages' automatic block names counted from zero for the test,
    then as they were: a test that compares the names both packages give
    does not depend on which tests ran before it in its process (the JAX
    package's own test files build JAX blocks only)."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    saved = [(m, dict(getattr(m._naming, "counters", {})))
             for m in (jblock, tblock)]
    for m, _ in saved:
        m._naming.counters = {}
    yield
    for m, counters in saved:
        m._naming.counters = counters
