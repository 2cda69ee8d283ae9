"""The port's bulk window (``engine.bulk``) against the cases of
tests/test_bulk_engine.py: a 15-op fusible chain is one dispatch and one
build, equal to the chain op by op and to the JAX package's chain on the
same numpy inputs (fp32 1e-5, bf16 0.05); the sync points flush (reading,
a scalar read, ``autograd.record`` entry, a non-fusible consumer, slice
assignment, ``+=``, ``waitall``, ``set_bulk_size``); ``out=`` runs
eagerly; a node keeps the value its input had when it was issued; an
identical chain, or one with new scalars, builds nothing; ``bulk(0)`` is
op by op; shape and dtype do not flush. On the CPU a window runs its
nodes eagerly, with the counts of the card's one-graph program."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import autograd, engine, nd
from torch_port_helpers import jax_trace_state  # noqa: F401

CPU = "cpu"


def _chain15(x, a):
    y = x
    for _ in range(5):
        y = y * a
        y = y + 0.5
        y = y.tanh()
    return y


X = np.linspace(-2.0, 2.0, 24, dtype=np.float32).reshape(4, 6)
A = np.full((4, 6), 1.1, np.float32)


@pytest.fixture
def xa():
    return nd.array(X, ctx=CPU), nd.array(A, ctx=CPU)


def _jax_chain(dtype="float32"):
    x, a = jnd.array(X), jnd.array(A)
    if dtype != "float32":
        x, a = x.astype(dtype), a.astype(dtype)
    with jmx.engine.bulk(0):
        return np.asarray(_chain15(x, a).asnumpy(), np.float32)


def test_15op_chain_is_one_dispatch_with_eager_parity(xa, jax_trace_state):
    x, a = xa
    with engine.bulk(0):
        ref = _chain15(x, a).asnumpy()
    engine.dispatch_counter.reset()
    with engine.bulk(15):
        y = _chain15(x, a)
        assert engine.dispatch_counter.count == 1  # the watermark flushed
        out = y.asnumpy()
    assert engine.dispatch_counter.count == 1
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, _jax_chain(), atol=1e-5, rtol=0)


def test_bulk_zero_is_pure_eager(xa):
    x, a = xa
    with engine.bulk(0):
        engine.dispatch_counter.reset()
        y = _chain15(x, a)
        assert engine.dispatch_counter.count == 15
        assert y._lazy is None
        assert len(engine._window()) == 0


def test_watermark_splits_long_chains(xa):
    x, a = xa
    with engine.bulk(15):
        engine.dispatch_counter.reset()
        y = _chain15(_chain15(x, a), a)
        y.wait_to_read()
        assert engine.dispatch_counter.count == 2


def test_bf16_parity(xa, jax_trace_state):
    xb, ab = xa[0].astype("bfloat16"), xa[1].astype("bfloat16")
    with engine.bulk(0):
        ref = ((xb * 2.0 + 0.25).tanh() * xb).asnumpy()
    with engine.bulk(15):
        out = ((xb * 2.0 + 0.25).tanh() * xb).asnumpy()
        chain = _chain15(xb, ab).asnumpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(chain, _jax_chain("bfloat16"), atol=0.05)


def test_shape_dtype_queries_do_not_flush(xa):
    x, a = xa
    with engine.bulk(64):
        engine.dispatch_counter.reset()
        y = (x * a).sum(axis=0, keepdims=True)
        assert y.shape == (1, 6) and y.dtype == np.float32
        assert y.size == 6 and y.ndim == 2
        assert y._lazy is not None
        assert engine.dispatch_counter.count == 0
        y.wait_to_read()
        assert engine.dispatch_counter.count == 1


def test_flush_on_asnumpy_and_scalar_reads(xa):
    x, a = xa
    with engine.bulk(64):
        y = x * a
        assert y._lazy is not None
        y.asnumpy()
        assert y._lazy is None
        assert bool((x * 0.0).sum() == 0.0)
        assert float((x - x).sum()) == 0.0


def test_flush_on_record_entry(xa):
    x, _ = xa
    with engine.bulk(64):
        pre = x * 3.0
        assert pre._lazy is not None
        with autograd.record():
            assert pre._lazy is None
            x.attach_grad()
        np.testing.assert_allclose(pre.asnumpy(), X * 3.0, atol=1e-6)


def test_record_gradients_through_flushed_inputs(xa):
    x, _ = xa
    x.attach_grad()
    with engine.bulk(64):
        pre = x * 2.0
        with autograd.record():
            loss = (pre * x).sum()
        loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2.0 * X, atol=1e-5)


def test_flush_on_non_fusible_consumer(xa):
    x, a = xa
    with engine.bulk(64):
        y = x * a
        assert y._lazy is not None
        mean, var = nd.moments(y, axes=(0, 1))
        assert y._lazy is None
        np.testing.assert_allclose(mean.asnumpy(), (X * A).mean(),
                                   atol=1e-6)


def test_flush_on_mutation(xa):
    x, a = xa
    with engine.bulk(64):
        y = x * a
        y[0] = 7.0
        assert y._lazy is None
        assert np.all(y.asnumpy()[0] == 7.0)
        z = x * a
        z += 1.0
        assert z._lazy is None
        np.testing.assert_allclose(z.asnumpy(), X * A + 1.0, atol=1e-6)


def test_out_kwarg_falls_back_to_eager(xa):
    x, a = xa
    dst = nd.zeros((4, 6), ctx=CPU)
    with engine.bulk(64):
        r = nd.add(x, a, out=dst)
        assert r is dst and dst._lazy is None
        np.testing.assert_allclose(dst.asnumpy(), X + A, atol=1e-6)


def test_input_rebinding_after_deferral_keeps_old_value(xa):
    x, _ = xa
    with engine.bulk(64):
        y = x * 2.0
        x._data = nd.zeros((4, 6), ctx=CPU)._data
        np.testing.assert_allclose(y.asnumpy(), X * 2.0, atol=1e-6)


def test_in_place_write_to_a_read_tensor_raises(xa):
    """A tensor written in place after an op read it (not through an
    NDArray, which flushes first) would reach the op at the flush: it
    raises there instead."""
    x, _ = xa
    with engine.bulk(64):
        y = x * 2.0
        with torch.no_grad():
            x._buf.add_(1.0)
        with pytest.raises(RuntimeError, match="written in place"):
            y.asnumpy()


def test_identical_chain_hits_program_cache(xa):
    x, a = xa

    def run():
        return ((x * a + 1.0).tanh() * x).sum().asnumpy()

    with engine.bulk(16):
        first = run()
        engine.bulk_compile_counter.reset()
        engine.dispatch_counter.reset()
        for _ in range(3):
            out = run()
        assert engine.bulk_compile_counter.count == 0
        assert engine.dispatch_counter.count == 3
        np.testing.assert_allclose(out, first, atol=1e-6)


def test_scalar_value_change_does_not_recompile(xa):
    x, _ = xa
    with engine.bulk(16):
        ((x * 0.5 + 0.1).tanh()).asnumpy()
        engine.bulk_compile_counter.reset()
        out = ((x * 0.25 + 0.3).tanh()).asnumpy()
        assert engine.bulk_compile_counter.count == 0
        np.testing.assert_allclose(out, np.tanh(X * 0.25 + 0.3), atol=1e-6)


def test_set_bulk_size_returns_previous_and_flushes(xa):
    x, a = xa
    prev = engine.set_bulk_size(33)
    try:
        y = x * a
        assert y._lazy is not None
        assert engine.set_bulk_size(0) == 33
        assert y._lazy is None
    finally:
        engine.set_bulk_size(prev)


def test_waitall_flushes():
    x = nd.array(np.ones((3, 3), np.float32), ctx=CPU)
    with engine.bulk(64):
        y = x * 5.0
        assert y._lazy is not None
        nd.waitall()
        assert y._lazy is None
        assert np.all(y.asnumpy() == 5.0)


def test_transparent_through_mixed_code(xa):
    x, a = xa

    def body():
        y, acc = x, 0.0
        for i in range(4):
            y = (y * a + 0.1).tanh()
            acc += float(y[i % 2].sum())
        return acc, y.asnumpy()

    with engine.bulk(0):
        ref_acc, ref_y = body()
    with engine.bulk(15):
        acc, yv = body()
    assert abs(acc - ref_acc) < 1e-4
    np.testing.assert_allclose(yv, ref_y, atol=1e-6, rtol=0)


def test_default_size_and_knobs():
    """``MXNET_ENGINE_BULK_SIZE`` defaults to 0 in the port, where the JAX
    package's default is upstream's 15 (ROADMAP.md C.2); the counters are
    the JAX module's names."""
    assert engine.DEFAULT_BULK_SIZE == 0
    for name in ("dispatch", "bulk_compile", "tape_compile",
                 "tape_cache_hit", "symbol_compile"):
        assert getattr(engine, name + "_counter").name == name
        assert getattr(jmx.engine, name + "_counter").name == name


def test_native_engine_runs_pushed_tasks_in_dependency_order():
    """The prebuilt ``src/engine_cc/libmxtpu.so``, loaded read-only."""
    eng = engine.NativeEngine(num_threads=2)
    v = eng.new_variable()
    seen = []
    for i in range(8):
        eng.push(lambda i=i: seen.append(i), mutable_vars=[v])
    eng.wait_all()
    assert seen == list(range(8))
    assert engine.default_engine() is engine.default_engine()
