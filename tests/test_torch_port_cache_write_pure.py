"""Through ``mx.nd`` the KV-cache writes are functional, as in the JAX
package: ``nd.cache_write``, ``nd.quant_cache_write`` and
``nd.quant_cache_write_read`` return new arrays and leave the arrays they
are given as they were, equal to the JAX package's outputs (exact: the
writes copy values, and the int8 pages and scales are integer-valued or
one fp32 max). The tensor-level ops the decode steps call stay in place:
they write into the buffers they are given and return them."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import F
from torch_port_helpers import jax_trace_state  # noqa: F401


def test_cache_write_leaves_its_input(jax_trace_state):  # noqa: F811
    """The probe: a (1, 1, 4, 2) cache of zeros, ones written at 1."""
    with tmx.cpu():
        c = tmx.nd.zeros((1, 1, 4, 2))
        out = tmx.nd.cache_write(c, tmx.nd.ones((1, 1, 1, 2)), 1)
    jc = jmx.nd.zeros((1, 1, 4, 2))
    jout = jmx.nd.cache_write(jc, jmx.nd.ones((1, 1, 1, 2)), 1)
    np.testing.assert_array_equal(c.asnumpy(), np.zeros((1, 1, 4, 2)))
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(out.asnumpy().ravel(),
                                  [0, 0, 1, 1, 0, 0, 0, 0])


@pytest.mark.parametrize("op", ["quant_cache_write",
                                "quant_cache_write_read"])
@pytest.mark.parametrize("by_name", [False, True])
def test_quant_cache_writes_leave_their_inputs(jax_trace_state, op,  # noqa
                                               by_name):
    rng = np.random.RandomState(0)
    cache = rng.randint(-127, 128, (2, 2, 5, 4)).astype(np.int8)
    scale = rng.uniform(0.01, 0.02, (2, 2, 1, 1)).astype(np.float32)
    upd = rng.uniform(-5, 5, (2, 2, 1, 4)).astype(np.float32)
    with tmx.cpu():
        tc = tmx.nd.array(cache, dtype="int8")
        ts = tmx.nd.array(scale)
        args = (tc, ts, tmx.nd.array(upd), 3)
        if by_name:
            got = getattr(tmx.nd, op)(cache=tc, scale=ts,
                                      update=tmx.nd.array(upd), index=3)
        else:
            got = getattr(tmx.nd, op)(*args)
    want = getattr(jmx.nd, op)(jmx.nd.array(cache, dtype="int8"),
                               jmx.nd.array(scale), jmx.nd.array(upd), 3)
    np.testing.assert_array_equal(tc.asnumpy(), cache)
    np.testing.assert_array_equal(ts.asnumpy(), scale)
    for g, w in zip(got, want):
        assert g.dtype.name == w.dtype.name
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    assert not np.array_equal(got[0].asnumpy(), cache)


def test_tensor_level_writes_stay_in_place():
    cache = torch.zeros(1, 2, 6, 3)
    out = F.cache_write(cache, torch.ones(1, 2, 2, 3), 2)
    assert out is cache and float(cache.sum()) == 12.0
    q = torch.zeros(1, 2, 6, 3, dtype=torch.int8)
    s = torch.zeros(1, 2, 1, 1)
    qc, qs = F.quant_cache_write(q, s, torch.ones(1, 2, 1, 3), 0)
    assert qc is q and qs is s and int(q[0, 0, 0, 0]) == 127
    q2 = torch.zeros_like(q)
    s2 = torch.zeros_like(s)
    F.quant_cache_write_read(q2, s2, torch.ones(1, 2, 1, 3), 1)
    assert int(q2[0, 0, 1, 0]) == 127 and float(s2.min()) > 0
