"""Edge cases of the port's ``F`` ops against the JAX package's ops: indices
past the end and negative, Python slice bounds, ``keepdims`` with
``axis=None``, the mean of an integer tensor, and an index out of range
in ``pick``. The same seeded numpy input goes through both packages and the
results must be equal, shape and values (NaN where the JAX op gives NaN)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import functional as JF
from mxnet_tpu_torch.ops import functional as TF


def _data(shape, dtype=np.float32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 4).astype(dtype)


def _both(op, arrays, **kw):
    """(the JAX op's result, the port op's result), as numpy."""
    want = getattr(JF, op)(*[jnp.asarray(a) for a in arrays], **kw)
    got = getattr(TF, op)(*[torch.from_numpy(a) for a in arrays], **kw)
    return np.asarray(want), got.numpy()


def _assert_same(want, got):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,indices,axis", [
    ("clip", [5, -1, 2], 0),
    ("clip", [[3, -2], [0, 9]], 1),
    ("wrap", [5, -1, 2], 0),
    ("wrap", [[3, -2], [0, -7]], 1),
    ("clip", [0, 1, 3], 0),
])
def test_take_modes_match_jax(mode, indices, axis):
    x = _data((4, 3))
    idx = np.asarray(indices, np.int32)
    _assert_same(*_both("take", [x, idx], axis=axis, mode=mode))


def test_take_default_mode_clips():
    x = _data((4, 3))
    idx = np.asarray([7, -3], np.int32)
    _assert_same(*_both("take", [x, idx]))
    np.testing.assert_array_equal(
        TF.take(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        x[[3, 0]])


@pytest.mark.parametrize("mode", ["fill", "raise", "bogus"])
def test_take_unknown_mode_raises(mode):
    with pytest.raises(ValueError, match=mode):
        TF.take(torch.zeros(4, 3), torch.tensor([0]), mode=mode)


@pytest.mark.parametrize("axis,begin,end", [
    (0, -1, None),
    (0, 0, -1),
    (0, 1, 9),
    (0, 3, 1),
    (1, -2, -1),
    (-1, -9, 2),
    (1, 2, 2),
])
def test_slice_axis_matches_jax(axis, begin, end):
    x = _data((4, 3))
    _assert_same(*_both("slice_axis", [x], axis=axis, begin=begin, end=end))


@pytest.mark.parametrize("op,dtype,axis,keepdims", [
    ("sum", np.float32, None, True),
    ("mean", np.float32, None, True),
    ("sum", np.float32, (0, 2), True),
    ("mean", np.int32, None, False),
    ("mean", np.int32, None, True),
    ("mean", np.int32, 1, False),
])
def test_reductions_match_jax(op, dtype, axis, keepdims):
    x = _data((2, 3, 4), dtype=dtype, seed=1)
    want, got = _both(op, [x], axis=axis, keepdims=keepdims)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.shape == want.shape


@pytest.mark.parametrize("dtype,axis,indices,keepdims", [
    (np.float32, -1, [0, 3, -1, 7], False),
    (np.float32, 0, [0, 4, -4], False),
    (np.float32, -1, [2, -4, 1, 0], True),
    (np.int32, -1, [0, 5, -1, 1], False),
])
def test_pick_out_of_range_matches_jax(dtype, axis, indices, keepdims):
    """An index outside [-n, n) gives NaN in a float output (the most
    negative int in an int one), never another row's element."""
    x = _data((4, 3), dtype=dtype, seed=2)
    idx = np.asarray(indices, np.int32)
    want, got = _both("pick", [x, idx], axis=axis, keepdims=keepdims)
    _assert_same(want, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids", [
    [1, -1, 4, -5],                    # the ROADMAP probe on 4 rows
    [[0, -6, 6, 2], [-1, 9, -7, 5]],   # [-n, 0), >= n and < -n on 6 rows
    [3, -3, 100, -100, 0, 5],          # a row hit twice, once wrapped
])
def test_embedding_out_of_range_ids_match_jax(ids, dtype):
    """``F.Embedding`` on ids outside the table equals ``jnp.take``'s fill
    mode, bit for bit: an id in [-n, 0) takes row id + n, an id outside
    [-n, n) a NaN row; the gradient adds each valid id's rows into its
    wrapped row and nothing for the others. Each row is hit by at most
    two ids, so the JAX package's bf16 sum (C.2) rounds as the port's
    fp32 one does."""
    import jax

    idx = np.asarray(ids, np.int32)
    n = 4 if idx.ndim == 1 and len(idx) == 4 else 6
    rng = np.random.RandomState(7)
    w = rng.randn(n, 8).astype(np.float32)
    g = rng.randn(*idx.shape, 8).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jw, jg = jnp.asarray(w, jdt), jnp.asarray(g, jdt)
    want, vjp = jax.vjp(lambda t: JF.Embedding(jnp.asarray(idx), t), jw)
    (want_dw,) = vjp(jg)
    tw = torch.tensor(w).to(tdt).requires_grad_()
    got = TF.Embedding(torch.from_numpy(idx), tw)
    got.backward(torch.tensor(g).to(tdt))
    assert got.dtype == tdt and tw.grad.dtype == tdt
    _assert_same(np.asarray(want, np.float32), got.detach().float().numpy())
    _assert_same(np.asarray(want_dw, np.float32), tw.grad.float().numpy())
    bad = (idx < -n) | (idx >= n)
    assert np.isnan(got.detach().float().numpy()[bad]).all()
    assert not np.isnan(got.detach().float().numpy()[~bad]).any()
