"""The port's detection ops against the JAX package's on the same seeded
numpy inputs, at the edges the ``nd`` case table does not reach: integer
outputs, masks and every score NMS keeps or drops exactly, boxes and
regression targets within 1e-6 of the largest element (1e-5 for the log
of the box-size targets). Two ground-truth boxes that share a best anchor
(the JAX op's scatter keeps the later one), NMS score ties, padding rows
and invalid entries, ``bipartite_matching`` with NaN and +-inf, and the
``nd.contrib`` names of the ops."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import detection as jdet
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import detection as tdet
from torch_port_helpers import jax_trace_state, few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads", "jax_trace_state")


def _both(name, *arrays, **kw):
    """(port outputs, JAX outputs) of op ``name``, each a list of numpy
    arrays."""
    t = getattr(tdet, name)(*[torch.from_numpy(a) for a in arrays], **kw)
    j = getattr(jdet, name)(*[jnp.asarray(a) for a in arrays], **kw)
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    return [x.numpy() for x in t], [np.asarray(x) for x in j]


def _boxes(rng, *shape):
    lo = rng.uniform(0.0, 0.7, shape + (2,))
    wh = rng.uniform(0.05, 0.3, shape + (2,))
    return np.concatenate([lo, np.minimum(lo + wh, 1.0)], -1).astype(
        np.float32)


def _anchors(h, w):
    return tdet.multibox_prior(torch.zeros(1, 1, h, w), sizes=(0.2, 0.3),
                               ratios=(1, 2, 0.5)).numpy()


@pytest.mark.parametrize("hw,kw", [
    ((8, 8), dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5))),
    ((5, 3), dict(sizes=(0.7,), ratios=(1, 3, 1 / 3), clip=True)),
    ((2, 2), dict(sizes=(0.71, 0.79), ratios=(1, 2, 0.5),
                  steps=(0.5, 0.5), offsets=(0.25, 0.75)))])
def test_multibox_prior(hw, kw):
    t, j = _both("multibox_prior", np.zeros((1, 3) + hw, np.float32), **kw)
    assert t[0].dtype == j[0].dtype == np.float32
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-6)


def test_multibox_target_random(jax_trace_state):  # noqa: F811
    """Batch 4, 8 boxes an image (the last two of two images padding), on
    the anchors of an 8 x 8 map: positives, mined negatives and ignored
    anchors exact, targets within 1e-6 (1e-5 for the log terms)."""
    rng = np.random.RandomState(0)
    anc = _anchors(8, 8)
    lab = np.concatenate([rng.randint(0, 5, (4, 8, 1)).astype(np.float32),
                          _boxes(rng, 4, 8)], -1)
    lab[1:3, 6:, 0] = -1.0
    cls = rng.uniform(0, 1, (4, 6, anc.shape[1])).astype(np.float32)
    (tb, tm, tc), (jb, jm, jc) = _both("multibox_target", anc, lab, cls)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    assert (tc > 0).sum() > 8 and (tc == 0).sum() > 0 and (tc < 0).sum() > 0
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-5 * np.abs(jb).max())


def test_multibox_target_shared_best_anchor(jax_trace_state):  # noqa: F811
    """Two valid boxes whose best anchor is the same one (the first a
    copy of the anchor, the second shifted by 0.01): the first box's IoU
    is the higher, but the JAX op's scatter of the forced matches keeps
    the later box there, and so does the port. Padding rows before and
    after them take no part. The shapes are the random test's, so the
    JAX side reuses its compiled ops."""
    anc = _anchors(8, 8)
    a = 100
    lab = np.zeros((4, 8, 5), np.float32)
    lab[..., 0] = -1.0
    lab[0, 1] = [3, *anc[0, a]]
    lab[0, 2] = [1, *(anc[0, a] + 0.01)]
    lab[1, 0] = [2, 0.1, 0.1, 0.4, 0.5]
    cls = np.full((4, 6, anc.shape[1]), 0.2, np.float32)
    (tb, tm, tc), (jb, jm, jc) = _both("multibox_target", anc, lab, cls)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-5 * np.abs(jb).max())
    assert tc[0, a] == 2.0  # the later box's class + 1


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5, valid_thresh=0.0),
    dict(overlap_thresh=0.3, valid_thresh=0.1, force_suppress=True),
    dict(overlap_thresh=0.4, id_index=-1, in_format="center"),
    dict(overlap_thresh=0.5, coord_start=1, score_index=0, id_index=5)])
def test_box_nms_ties_and_padding(kw):
    """Score ties (stable order: the earlier index first), padding rows
    with score -1 and invalid scores, near-duplicate boxes of two classes;
    every output value exact."""
    rng = np.random.RandomState(2)
    d = np.concatenate([rng.randint(0, 3, (2, 40, 1)).astype(np.float32),
                        rng.choice([0.2, 0.5, 0.7, 0.9], (2, 40, 1)).astype(
                            np.float32), _boxes(rng, 2, 40)], -1)
    d[:, 10:20, 2:] = d[:, :10, 2:] + 0.01
    d[:, 30:, 1] = -1.0
    if kw.get("coord_start") == 1:
        d = np.concatenate([d[..., 1:2], d[..., 2:], d[..., :1]], -1)
    t, j = _both("box_nms", d, **kw)
    np.testing.assert_array_equal(t[0], j[0])
    score = kw.get("score_index", 1)
    assert 0 < (t[0][..., score] == -1).sum() < t[0][..., score].size
    t1, j1 = _both("box_nms", d[0], **kw)  # 2-D data
    np.testing.assert_array_equal(t1[0], j1[0])


def test_multibox_detection_random(jax_trace_state):  # noqa: F811
    """Decoding and per-class NMS at batch 2 over 8 x 8 anchors, 5
    classes: ids and scores exact, boxes within 1e-6."""
    rng = np.random.RandomState(3)
    anc = _anchors(8, 8)
    n = anc.shape[1]
    logits = rng.randn(2, 6, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = rng.randn(2, n * 4).astype(np.float32) * 0.3
    t, j = _both("multibox_detection", prob.astype(np.float32), loc, anc,
                 threshold=0.2, nms_threshold=0.45)
    np.testing.assert_array_equal(t[0][..., :2], j[0][..., :2])
    np.testing.assert_allclose(t[0][..., 2:], j[0][..., 2:], rtol=0,
                               atol=1e-6)
    assert (t[0][..., 1] > 0).sum() > 0


@pytest.mark.parametrize("x,kw", [
    (np.array([[[0.5, np.nan, 0.2, 0.9], [np.inf, 0.3, -np.inf, 0.1],
                [0.2, 0.9, 0.1, np.inf], [np.nan, np.nan, 0.4, 0.4]]],
              np.float32), dict(threshold=0.15)),
    (np.array([[[0.5, np.nan, 0.2], [np.inf, 0.3, -np.inf],
                [0.2, 0.9, 0.1]]], np.float32),
     dict(threshold=0.4, is_ascend=True)),
    (np.array([[[-np.inf, -np.inf], [-np.inf, -np.inf]]], np.float32),
     dict(threshold=-np.inf)),
    (np.random.RandomState(4).uniform(0, 1, (3, 6, 4)).astype(np.float32),
     dict(threshold=0.3, topk=2)),
])
def test_bipartite_matching_special_values(x, kw):
    t, j = _both("bipartite_matching", x, **kw)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_box_iou_formats():
    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 3, 6), _boxes(rng, 3, 4)
    for fmt in ("corner", "center"):
        t, j = _both("box_iou", a, b, format=fmt)
        np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-6)


def test_nd_and_contrib_names():
    """``nd.<op>`` and ``nd.contrib.<name>`` (the MultiBox aliases too)
    reach the ported ops."""
    rng = np.random.RandomState(6)
    a, b = _boxes(rng, 2, 3), _boxes(rng, 2, 2)
    with tmx.cpu():
        got = tmx.nd.contrib.box_iou(tmx.nd.array(a), tmx.nd.array(b))
        np.testing.assert_array_equal(
            got.asnumpy(), tmx.nd.box_iou(tmx.nd.array(a),
                                          tmx.nd.array(b)).asnumpy())
        prior = tmx.nd.contrib.MultiBoxPrior(tmx.nd.zeros((1, 3, 2, 2)),
                                             sizes=(0.5,))
        assert prior.shape == (1, 4, 4)
