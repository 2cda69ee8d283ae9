"""``mx.nd`` op parity for the legacy flat ops of ``tools/nd_op_cases.py``
(``all_finite``, ``multi_*``, ``onehot_encode``, the optimizer updates
with their in-place state writes, each against the JAX package's), the
random draws' moments and determinism under a seed, and the coverage of
the JAX registry: every name is ported and held by a case, or in
``nd.NOT_PORTED`` with its ROADMAP item."""
import numpy as np
import pytest

from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401
from torch_port_nd_parity import cases_between, cases_param, check_parity
from tools.nd_op_cases import CASES, RANDOM_CASES, SAMPLE_CASES

# torch on 2 threads: the suite runs a worker a core or so
pytestmark = pytest.mark.usefixtures("few_threads")

LEGACY = cases_between("all_finite", "arange_like")


@cases_param(LEGACY)
def test_nd_op_matches_jax(case, jax_trace_state):  # noqa: F811
    check_parity(case)


@pytest.mark.parametrize("op,kw,mean,var", RANDOM_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(RANDOM_CASES)])
def test_random_moments_and_seed(op, kw, mean, var):
    import mxnet_tpu_torch as mx

    n = 20000
    with mx.cpu():
        mx.random.seed(7)
        a = getattr(mx.nd, op)(shape=(n,), **kw).asnumpy().astype(np.float64)
        mx.random.seed(7)
        b = getattr(mx.nd, op)(shape=(n,), **kw).asnumpy()
        c = getattr(mx.nd, op)(shape=(n,), **kw).asnumpy()
    np.testing.assert_array_equal(a, b)  # one seed, one stream
    assert not np.array_equal(b, c)
    assert abs(a.mean() - mean) <= 5 * np.sqrt(var / n)
    assert abs(a.var() - var) <= 0.1 * var


@pytest.mark.parametrize("op,params,kw,mean,var", SAMPLE_CASES,
                         ids=[c[0] for c in SAMPLE_CASES])
def test_sample_moments(op, params, kw, mean, var):
    import mxnet_tpu_torch as mx

    n = 20000
    with mx.cpu():
        mx.random.seed(3)
        arrs = [mx.nd.array(np.asarray(p, np.float32)) for p in params]
        out = getattr(mx.nd, op)(*arrs, shape=(n,), **kw).asnumpy()
    assert out.shape == (len(mean), n)
    out = out.astype(np.float64)
    for row, m in enumerate(mean):
        sd = np.sqrt(var[row]) if var else 1.0
        assert abs(out[row].mean() - m) <= 5 * sd / np.sqrt(n) + 1e-3
        if var:
            assert abs(out[row].var() - var[row]) <= 0.1 * var[row]


def test_multinomial_prob_and_shuffle():
    import mxnet_tpu_torch as mx

    with mx.cpu():
        p = mx.nd.array([[0.1, 0.9], [1.0, 0.0]])
        draws, lp = mx.nd.random.multinomial(p, shape=4, get_prob=True)
        assert draws.shape == (2, 4) and draws.dtype == np.int32
        assert (draws.asnumpy()[1] == 0).all()
        np.testing.assert_allclose(
            lp.asnumpy(), np.log(p.asnumpy())[np.arange(2)[:, None],
                                             draws.asnumpy()], rtol=1e-6)
        x = mx.nd.arange(10)
        assert sorted(mx.nd.random.shuffle(x).asnumpy()) == list(range(10))
        assert sorted(mx.nd.shuffle(x).asnumpy()) == list(range(10))


def test_every_jax_op_is_ported_or_listed():
    import mxnet_tpu  # noqa: F401  (fills the JAX registry)
    from mxnet_tpu.base import OP_REGISTRY as JAX_REG
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.base import OP_REGISTRY as REG

    missing = [n for n in JAX_REG if n not in REG and n not in nd.NOT_PORTED]
    assert not missing, missing
    assert not set(REG) & set(nd.NOT_PORTED)
    for name, item in nd.NOT_PORTED.items():
        assert item.split()[0] in ("A.11", "A.14", "A.17", "A.11/A.17")
        with pytest.raises(NotImplementedError, match=item.split()[0]):
            getattr(nd, name)()
    # every ported name is held by a case, or is the same function as a
    # name that is, or is drawn at random above, or is held by the
    # earlier slices' own tests
    held = {c.op for c in CASES} | {c[0] for c in RANDOM_CASES} | {
        c[0] for c in SAMPLE_CASES}
    held_fns = {id(REG[n]) for n in held}
    elsewhere = {"dequant_cache", "contrib_quantize", "contrib_dequantize",
                 "quantized_fully_connected", "quantized_conv", "arange",
                 "_basic_index", "_sample_multinomial_prob",
                 "shuffle",  # shuffle: test_multinomial_prob_and_shuffle
                 # the graph's source and projection ops:
                 # tests/test_torch_port_symbol.py test_graph_ops
                 "_const", "_filled", "_arange", "_item",
                 # the control-flow nodes as ops: tests/
                 # test_torch_port_control_flow.py test_nd_registry_nodes
                 "_cond", "_foreach", "_while"}
    unheld = [n for n in REG if n in JAX_REG and n not in held
              and id(REG[n]) not in held_fns and n not in elsewhere]
    assert not unheld, unheld


def test_nd_contrib_and_control_flow_name_their_items():
    import mxnet_tpu_torch as mx

    for name, item in (("ROIAlign", "A.17"), ("PSROIPooling", "A.17")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(mx.nd.contrib, name)()
    with pytest.raises(NotImplementedError, match="A.17"):
        mx.sym.contrib.ROIPooling()
    # the contrib names of A.17's first half are ported (ops/contrib_extra)
    from mxnet_tpu._contrib_ops import CONTRIB_OPS as JAX_CONTRIB
    assert mx.nd.contrib.CONTRIB_OPS == JAX_CONTRIB
    with mx.cpu():
        spec = mx.nd.contrib.fft(mx.nd.array([[1.0, 0.0, 0.0, 0.0]]))
        np.testing.assert_array_equal(spec.asnumpy(), [[1, 0] * 4])
    with mx.cpu():  # the control flow is ported (A.14)
        outs, last = mx.nd.contrib.foreach(
            lambda x, s: (x + s, s + 1.0), mx.nd.ones((3, 2)),
            mx.nd.zeros((2,)))
        np.testing.assert_array_equal(outs.asnumpy()[:, 0], [1, 2, 3])
        np.testing.assert_array_equal(last.asnumpy(), [3, 3])
    with mx.cpu():
        x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        m = mx.nd.contrib.boolean_mask(x, mx.nd.array([1, 0, 1, 0]))
        np.testing.assert_array_equal(m.asnumpy(), x.asnumpy()[[0, 2]])
        y = mx.nd.contrib.BilinearResize2D(x.reshape(1, 1, 4, 3), height=2,
                                           width=2)
        assert y.shape == (1, 1, 2, 2)
