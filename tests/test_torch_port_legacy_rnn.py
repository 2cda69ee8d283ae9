"""``mx.rnn`` of the port against the JAX package's on the same inputs:
``BucketSentenceIter``'s buckets, plans and batches (both layouts, the
shuffle plan from one seed, discards), ``FusedRNNCell.unroll`` on the same
weights (fp32 1e-5) and the legacy cell names."""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")
TOL = dict(rtol=1e-5, atol=1e-5)


def _sentences(seed=0, n=60, lo=2, hi=14):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 50, rng.randint(lo, hi))) for _ in range(n)]


def _batches(it):
    return [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             b.provide_data[0].shape, b.provide_data[0].layout) for b in it]


@pytest.mark.parametrize("layout", ["NT", "TN"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("buckets", [[4, 8, 12], None])
def test_bucket_sentence_iter_matches(layout, shuffle, buckets):
    import mxnet_tpu.rnn as jrnn

    sents = _sentences()
    kw = dict(batch_size=5, buckets=buckets, invalid_label=0, layout=layout,
              shuffle=shuffle, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jrnn.BucketSentenceIter(sents, **kw)
        with tmx.cpu():
            t = tmx.rnn.BucketSentenceIter(sents, **kw)
    assert t.buckets == j.buckets
    assert t.default_bucket_key == j.default_bucket_key
    assert t.provide_data[0].shape == j.provide_data[0].shape
    for epoch in range(2):
        with tmx.cpu():
            tb = _batches(t)
        jb = _batches(j)
        assert len(tb) == len(jb) > 0
        for (tk, td, tl, ts, tlay), (jk, jd, jl, js, jlay) in zip(tb, jb):
            assert (tk, ts, tlay) == (jk, js, jlay)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
        t.reset()
        j.reset()


def test_bucket_sentence_iter_shifts_labels_and_discards():
    sents = ([[1, 2, 3]] * 5) + ([[4, 5, 6, 7, 8]] * 7) + [[9] * 12]
    with pytest.warns(UserWarning, match="discarded 1"):
        it = tmx.rnn.BucketSentenceIter(sents, batch_size=2, buckets=[4, 8],
                                        invalid_label=0)
    with tmx.cpu():
        batches = list(it)
    assert sorted(b.bucket_key for b in batches) == [4, 4, 8, 8, 8]
    for b in batches:
        d, l = b.data[0].asnumpy(), b.label[0].asnumpy()
        assert d.shape == (2, b.bucket_key)
        np.testing.assert_array_equal(l[:, :-1], d[:, 1:])
        assert (l[:, -1] == 0).all()
    with pytest.raises(ValueError):
        tmx.rnn.BucketSentenceIter([[1, 2]], 1, buckets=[4], layout="XY")


@pytest.mark.parametrize("mode,layers,bidir", [("lstm", 2, False),
                                               ("gru", 1, True),
                                               ("rnn_tanh", 2, False)])
def test_fused_rnn_cell_unroll_matches(mode, layers, bidir):
    import mxnet_tpu.rnn as jrnn
    from mxnet_tpu import nd as jnd

    jcell = jrnn.FusedRNNCell(6, num_layers=layers, mode=mode,
                              bidirectional=bidir)
    tcell = tmx.rnn.FusedRNNCell(6, num_layers=layers, mode=mode,
                                 bidirectional=bidir)
    x = np.random.RandomState(1).randn(3, 7, 4).astype(np.float32)  # NTC
    jout, jstates = jcell.unroll(5, jnd.array(x), layout="NTC")
    with tmx.cpu():
        tcell._layer.initialize(device="cpu")
        tx = tmx.nd.array(x)
        tcell._layer(tx.swapaxes(0, 1), tcell._layer.begin_state(
            batch_size=3, ctx=tmx.cpu()))  # deferred shapes settle
        jp = jcell._layer.collect_params()
        for (jn, jv), (tn, tv) in zip(sorted(jp.items()), sorted(
                tcell._layer.collect_params().items())):
            tv.set_data(torch.from_numpy(np.array(jv.data()._data)))
        tout, tstates = tcell.unroll(5, tx, layout="NTC")
    assert tout.shape == (3, 5, 6 * (2 if bidir else 1))
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    for a, b in zip(tstates, jstates):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    with pytest.raises(ValueError):
        with tmx.cpu():
            tcell.unroll(9, tx, layout="NTC")


def test_legacy_cell_names_are_gluon_cells():
    for name in ("RNNCell", "LSTMCell", "GRUCell", "SequentialRNNCell",
                 "BidirectionalCell", "DropoutCell", "ResidualCell",
                 "ZoneoutCell", "ModifierCell"):
        assert getattr(tmx.rnn, name) is getattr(tmx.gluon.rnn, name)
    cell = tmx.rnn.LSTMCell(4, input_size=3)
    cell.initialize(device="cpu")
    with tmx.cpu():
        out, states = cell.unroll(5, tmx.nd.ones((2, 5, 3)), layout="NTC",
                                  merge_outputs=True)
    assert out.shape == (2, 5, 4) and len(states) == 2
