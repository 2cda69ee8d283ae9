"""The port's compiled tape replay (``autograd.set_tape_compile``) against
the cases of tests/test_tape_replay.py: with the replay on, a recorded
loop's backward is keyed by its graph's structure, one build and then only
hits (``engine.tape_compile_counter``, ``tape_cache_hit_counter``), with
gradients equal to the eager walk's and within fp32 1e-5 / bf16 0.05 of
the JAX package's on the same numpy inputs, for ``retain_graph``,
``grad_req`` ``add``/``null``, explicit head gradients, several heads,
bf16, ``create_graph``, an ``autograd.Function`` on the tape, an
attached intermediate and dropout. The counted eager routes
(``engine.tape_eager_counter``): the replay off, a ``Function`` node,
``create_graph``, a parameter hook. On the CPU the keyed backward runs
eagerly; one module-scoped case runs torch's compiled autograd for real
(``cpu_backend="aot_eager"``).

Differences from the JAX package's test, pinned here: the port's forward
under ``record()`` runs op by op (torch builds its autograd graph as the
ops run), so a 50-op recorded loop is 50 forward dispatches and one
keyed backward, not three dispatches; the replay is off by default on
the port (``ROADMAP.md`` C.2: each new graph costs a compile of seconds
on the card); the JAX package's donation handshake
(``mark_grad_shared``) has no counterpart, torch never donates a
gradient buffer."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import autograd, engine, nd
from torch_port_helpers import jax_trace_state  # noqa: F401

X = np.linspace(-1.5, 1.5, 24, dtype=np.float32).reshape(4, 6)
A = np.full((4, 6), 0.9, np.float32)


def _chain(x, a, n_ops):
    y, ops = x, 0
    while ops < n_ops:
        y = y * 0.9
        ops += 1
        if ops < n_ops:
            y = y + a
            ops += 1
        if ops < n_ops:
            y = y.tanh()
            ops += 1
        if ops < n_ops:
            y = y - 0.05
            ops += 1
    return y


@pytest.fixture
def replay():
    prev = autograd.set_tape_compile(True)
    yield
    autograd.set_tape_compile(prev)


@pytest.fixture
def xa():
    return nd.array(X, ctx="cpu"), nd.array(A, ctx="cpu")


def _counts():
    return (engine.tape_compile_counter.count,
            engine.tape_cache_hit_counter.count,
            engine.tape_eager_counter.count)


def _reset():
    for c in (engine.tape_compile_counter, engine.tape_cache_hit_counter,
              engine.tape_eager_counter, engine.dispatch_counter):
        c.reset()


def _jax_grad(n_ops, dtype="float32"):
    x, a = jnd.array(X), jnd.array(A)
    if dtype != "float32":
        x, a = x.astype(dtype), a.astype(dtype)
    x.attach_grad()
    with jag.record():
        loss = _chain(x, a, n_ops).sum()
    loss.backward()
    return np.asarray(x.grad.asnumpy(), np.float32)


def _eager_grad(x, a, n):
    prev = autograd.set_tape_compile(False)
    try:
        x.attach_grad()
        with autograd.record():
            loss = _chain(x, a, n).sum()
        loss.backward()
        return x.grad.asnumpy().copy()
    finally:
        autograd.set_tape_compile(prev)


def test_50op_loop_one_build_then_hits(xa, replay, jax_trace_state):
    x, a = xa
    x.attach_grad()

    def step():
        with autograd.record():
            loss = _chain(x, a, 50).sum()
        loss.backward()
        return float(loss), x.grad.asnumpy().copy()

    _reset()
    step()
    assert _counts() == (1, 0, 0)
    for _ in range(3):
        engine.dispatch_counter.reset()
        _, gv = step()
        # the forward op by op under record (50 ops and the sum)
        assert engine.dispatch_counter.count == 51
    assert _counts() == (1, 3, 0)
    np.testing.assert_allclose(gv, _eager_grad(x, a, 50), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gv, _jax_grad(50), atol=1e-5, rtol=0)


def test_eager_hatch_matches_and_never_compiles(xa, replay):
    x, a = xa
    x.attach_grad()
    prev = autograd.set_tape_compile(False)
    try:
        assert not autograd.tape_compile_enabled()
        _reset()
        with autograd.record():
            loss = _chain(x, a, 15).sum()
        loss.backward()
        g_eager = x.grad.asnumpy().copy()
        assert _counts() == (0, 0, 1)
    finally:
        autograd.set_tape_compile(prev)
    with autograd.record():
        loss = _chain(x, a, 15).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), g_eager, atol=1e-6, rtol=0)


def test_knob_and_default():
    prev = autograd.set_tape_compile(True)
    try:
        assert autograd.set_tape_compile(False) is True
        assert autograd.set_tape_compile(True) is False
    finally:
        autograd.set_tape_compile(prev)
    import mxnet_tpu_torch.autograd as m

    assert m._TAPE_COMPILE_DEFAULT is False  # ROADMAP.md C.2


def test_retain_graph_parity(xa, replay):
    x, a = xa
    x.attach_grad()
    with autograd.record():
        loss = ((x * a).tanh() * x).sum()
    loss.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), g1, atol=1e-6, rtol=0)


def test_grad_req_add_accumulates(xa, replay, jax_trace_state):
    x, _ = xa
    x.attach_grad(grad_req="add")
    for _ in range(3):
        with autograd.record():
            y = (x * x).sum()
        y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 3 * 2 * X, rtol=1e-6)


def test_grad_req_null_is_untouched(xa, replay):
    x, a = xa
    x.attach_grad()
    a.attach_grad(grad_req="null")
    marker = np.full(a.shape, 7.0, np.float32)
    a._grad._data = nd.array(marker, ctx="cpu")._data
    with autograd.record():
        loss = (x * a).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), A, atol=1e-6)
    np.testing.assert_allclose(a.grad.asnumpy(), marker, atol=0)


def test_explicit_head_grads(xa, replay):
    x, _ = xa
    x.attach_grad()
    hg = nd.array(np.arange(24, dtype=np.float32).reshape(4, 6), ctx="cpu")
    with autograd.record():
        y = x * 2.0
    y.backward(hg)
    np.testing.assert_allclose(x.grad.asnumpy(), 2.0 * hg.asnumpy(),
                               atol=1e-6)


def test_multi_head_and_partial_head(xa, replay):
    x, a = xa
    x.attach_grad()
    with autograd.record():
        h1 = (x * a).sum()
        h2 = (x * x).sum()
    autograd.backward([h1, h2])
    np.testing.assert_allclose(x.grad.asnumpy(), A + 2 * X, atol=1e-5)
    _reset()
    with autograd.record():
        h1 = (x * a).sum()
        h2 = (x * x).sum()
    h1.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), A, atol=1e-6)
    c = _counts()  # one keyed backward (its key may be known already)
    assert c[0] + c[1] == 1 and c[2] == 0


def test_bf16_parity(xa, replay, jax_trace_state):
    x, a = xa
    xb, ab = x.astype("bfloat16"), a.astype("bfloat16")
    xb.attach_grad()
    with autograd.record():
        loss = _chain(xb, ab, 12).sum()
    loss.backward()
    got = np.asarray(xb.grad.asnumpy(), np.float32)
    assert str(xb.grad.dtype) == "bfloat16"
    np.testing.assert_allclose(got, _jax_grad(12, "bfloat16"), atol=0.05)


def test_create_graph_grad_of_grad_is_a_counted_eager_route(replay):
    x = nd.array(np.array([2.0, -1.5, 3.0], np.float32), ctx="cpu")
    x.attach_grad()
    _reset()
    with autograd.record():
        y = (x * x * x).sum()
        (g,) = autograd.grad(y, [x], create_graph=True)
        z = (g * g).sum()
    z.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 36 * x.asnumpy() ** 3,
                               rtol=1e-4)
    assert engine.tape_eager_counter.count == 1  # the create_graph grad


def test_fallback_for_function_nodes(xa, replay):
    class Scale3(autograd.Function):
        def forward(self, v):
            return v * 3.0

        def backward(self, dv):
            return dv * 3.0

    x, _ = xa
    x.attach_grad()
    f = Scale3()
    _reset()
    with autograd.record():
        y = f(x * 2.0)
        loss = (y * y).sum()
    loss.backward()
    assert _counts() == (0, 0, 1)
    np.testing.assert_allclose(x.grad.asnumpy(), 72.0 * X, rtol=1e-5)


def test_parameter_hook_takes_the_eager_route(replay):
    """A parameter with a post-accumulate-grad hook (the bucketed exchange
    starts there) keeps its hook firing: the backward takes the counted
    eager route."""
    from mxnet_tpu_torch import gluon

    net = gluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    fired = []
    net.weight._tensor().register_post_accumulate_grad_hook(
        lambda t: fired.append(1))
    _reset()
    with autograd.record():
        loss = net(nd.array(np.ones((2, 4), np.float32), ctx="cpu")).sum()
    loss.backward()
    assert fired == [1] and _counts() == (0, 0, 1)


def test_intermediate_attach_grad(xa, replay):
    x, _ = xa
    x.attach_grad()
    with autograd.record():
        v = x * 2.0
        v.attach_grad()
        loss = (v * v).sum()
    loss.backward()
    np.testing.assert_allclose(v.grad.asnumpy(), 4.0 * X, atol=1e-5)


def test_rng_op_backward_sees_the_forward_mask(xa, replay):
    x, _ = xa
    x.attach_grad()
    with autograd.record():
        y = nd.Dropout(x, p=0.5)
        loss = (y * y).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2.0 * y.asnumpy() / 0.5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def compiled_runs():
    """The 15-op loop and a grad_req='add' loop through torch's compiled
    autograd on the CPU (aot_eager), against the eager walk."""
    prev = autograd.set_tape_compile(True, cpu_backend="aot_eager")
    try:
        x = nd.array(X, ctx="cpu")
        a = nd.array(A, ctx="cpu")
        x.attach_grad()
        out, counts = [], []
        for _ in range(2):
            with autograd.record():
                loss = _chain(x, a, 15).sum()
            before = _counts()
            loss.backward()
            counts.append(tuple(n - b for n, b in zip(_counts(), before)))
            out.append(x.grad.asnumpy().copy())
        x.attach_grad(grad_req="add")
        for _ in range(2):
            with autograd.record():
                loss = _chain(x, a, 15).sum()
            loss.backward()
        out.append(x.grad.asnumpy().copy())
    finally:
        autograd.set_tape_compile(prev, cpu_backend="")
    return out, _eager_grad(nd.array(X, ctx="cpu"), nd.array(A, ctx="cpu"),
                            15), counts


def test_compiled_autograd_on_the_cpu(compiled_runs):
    (g1, g2, acc), ref, _ = compiled_runs
    np.testing.assert_allclose(g1, ref, atol=1e-6)
    np.testing.assert_allclose(g2, ref, atol=1e-6)
    np.testing.assert_allclose(acc, 2 * ref, atol=1e-6)


def test_compiled_builds_are_torchs(compiled_runs):
    """Through compiled autograd the build and hit counts are read from
    torch's own counters: the first backward captured and compiled its
    graph, the second ran it (no recompile)."""
    counts = compiled_runs[2]
    assert counts == [(1, 0, 0), (0, 1, 0)], counts
