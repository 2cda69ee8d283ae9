"""``mx.io`` and ``mx.recordio`` of the port against the JAX package's, on
the same numpy inputs: every batch's data, label and pad equal, each epoch
(``NDArrayIter``'s shuffle draws from numpy's global state in both, so a
test seeds it the same way before each side), the native CSV reader and
the ``loadtxt`` route, idx-ubyte files, and RecordIO files written by
either package read byte for byte by the other."""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")


def _epoch(it):
    return [([d.asnumpy() for d in b.data],
             [l.asnumpy() for l in (b.label or [])], b.pad) for b in it]


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(x, y)


def _data(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


@pytest.mark.parametrize("handle", ["pad", "keep", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(handle, shuffle):
    import mxnet_tpu.io as jio

    x, y = _data()
    np.random.seed(3)
    j = jio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                        last_batch_handle=handle)
    np.random.seed(3)
    with tmx.cpu():
        t = tio.NDArrayIter(x, y, batch_size=4, shuffle=shuffle,
                            last_batch_handle=handle)
        for epoch in range(3):
            np.random.seed(10 + epoch)
            ej = _epoch(j)
            np.random.seed(10 + epoch)
            et = _epoch(t)
            _same(ej, et)
            assert ej, "an epoch yielded nothing"
            np.random.seed(20 + epoch)
            j.reset()
            np.random.seed(20 + epoch)
            t.reset()
    assert [d.shape for d in t.provide_data] == \
        [d.shape for d in j.provide_data]
    assert t.provide_label[0].name == "softmax_label"


def test_ndarray_iter_names_and_dict_inputs():
    import mxnet_tpu.io as jio

    x, y = _data(8)
    with tmx.cpu():
        t = tio.NDArrayIter({"a": x, "b": x * 2}, [y, y + 1], batch_size=3)
        j = jio.NDArrayIter({"a": x, "b": x * 2}, [y, y + 1], batch_size=3)
        assert [d.name for d in t.provide_data] == \
            [d.name for d in j.provide_data]
        assert [d.name for d in t.provide_label] == \
            [d.name for d in j.provide_label]
        _same(_epoch(j), _epoch(t))


def _write_csv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join("%.6g" % v for v in r) + "\n")


def test_csv_iter_native_reader(tmp_path):
    import mxnet_tpu.io as jio

    x, y = _data(9, seed=1)
    _write_csv(tmp_path / "d.csv", x)
    _write_csv(tmp_path / "l.csv", y[:, None])
    before = dict(tio.counters)
    with tmx.cpu():
        t = tio.CSVIter(str(tmp_path / "d.csv"), (3,),
                        str(tmp_path / "l.csv"), batch_size=4)
        j = jio.CSVIter(str(tmp_path / "d.csv"), (3,),
                        str(tmp_path / "l.csv"), batch_size=4)
        _same(_epoch(j), _epoch(t))
    assert tio.counters["csv_native"] == before["csv_native"] + 2
    assert tio.counters["csv_loadtxt"] == before["csv_loadtxt"]


def test_csv_iter_round_batch_false_keeps_the_short_batch(tmp_path):
    import mxnet_tpu.io as jio

    x, _ = _data(7, seed=2)
    _write_csv(tmp_path / "d.csv", x)
    with tmx.cpu():
        t = tio.CSVIter(str(tmp_path / "d.csv"), (3,), batch_size=3,
                        round_batch=False)
        j = jio.CSVIter(str(tmp_path / "d.csv"), (3,), batch_size=3,
                        round_batch=False)
        et = _epoch(t)
        _same(_epoch(j), et)
    assert et[-1][0][0].shape == (1, 3)


def test_csv_iter_ragged_file_takes_loadtxt(tmp_path):
    """The native reader declines a file with a trailing-comma row (its
    rows would be ragged); ``loadtxt`` reads it and the route is counted."""
    import mxnet_tpu.io as jio

    p = tmp_path / "r.csv"
    p.write_text("1,2,3\n4,5,6\n7,8,9\n")
    assert tio._read_csv_native(str(p)) is not None
    q = tmp_path / "bad.csv"
    q.write_text("1,2,3\n4,5,6,\n7,8,9\n")
    native = tio._read_csv_native(str(q))
    before = dict(tio.counters)
    with tmx.cpu():
        if native is None:
            with pytest.raises(ValueError):
                tio.CSVIter(str(q), (3,), batch_size=2)
            assert tio.counters["csv_loadtxt"] == before["csv_loadtxt"] + 1
            with pytest.raises(ValueError):
                jio.CSVIter(str(q), (3,), batch_size=2)
        else:
            t = _epoch(tio.CSVIter(str(q), (3,), batch_size=2))
            _same(_epoch(jio.CSVIter(str(q), (3,), batch_size=2)), t)
    # a single column squeezes as loadtxt does
    c = tmp_path / "c.csv"
    c.write_text("1\n2\n3\n")
    np.testing.assert_array_equal(tio._load_csv_f32(str(c)),
                                  np.loadtxt(str(c), delimiter=",",
                                             dtype=np.float32))


def _write_idx(path, arr, gz=False):
    raw = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.astype(np.uint8).tobytes()
    (gzip.open if gz else open)(path, "wb").write(raw)


@pytest.mark.parametrize("flat,shuffle,parts,gz", [
    (False, False, 1, False), (True, True, 1, True), (False, True, 2, False)])
def test_mnist_iter_matches(tmp_path, flat, shuffle, parts, gz):
    import mxnet_tpu.io as jio

    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (11, 28, 28))
    labs = rng.randint(0, 10, (11,))
    ext = ".gz" if gz else ""
    _write_idx(tmp_path / ("i" + ext), imgs, gz)
    _write_idx(tmp_path / ("l" + ext), labs, gz)
    kw = dict(batch_size=4, flat=flat, shuffle=shuffle, seed=7,
              num_parts=parts, part_index=parts - 1)
    with tmx.cpu():
        t = tio.MNISTIter(str(tmp_path / ("i" + ext)),
                          str(tmp_path / ("l" + ext)), **kw)
        j = jio.MNISTIter(str(tmp_path / ("i" + ext)),
                          str(tmp_path / ("l" + ext)), **kw)
        et = _epoch(t)
        _same(_epoch(j), et)
    assert et[0][0][0].shape == ((4, 784) if flat else (4, 1, 28, 28))
    with pytest.raises(ValueError):
        bad = tmp_path / "bad"
        bad.write_bytes(struct.pack(">HBB", 0, 0x0D, 1) + b"\0\0\0\1" * 2)
        tio._read_idx_ubyte(str(bad))


def test_prefetching_and_resize_iters_match():
    import mxnet_tpu.io as jio

    x, y = _data(10, seed=5)
    with tmx.cpu():
        tp = tio.PrefetchingIter(tio.NDArrayIter(x, y, batch_size=4))
        jp = jio.PrefetchingIter(jio.NDArrayIter(x, y, batch_size=4))
        for _ in range(2):
            _same(_epoch(jp), _epoch(tp))
            tp.reset()
            jp.reset()
        tr = tio.ResizeIter(tio.NDArrayIter(x, y, batch_size=4), 5)
        jr = jio.ResizeIter(jio.NDArrayIter(x, y, batch_size=4), 5)
        et = _epoch(tr)
        _same(_epoch(jr), et)
        assert len(et) == 5
        tr.reset()
        assert len(_epoch(tr)) == 5


def test_prefetching_iter_thread_makes_arrays_on_the_callers_context():
    x, y = _data(6)
    with tmx.cpu():
        it = tio.PrefetchingIter(tio.NDArrayIter(x, y, batch_size=3))
    batches = list(it)
    assert len(batches) == 2
    assert all(b.data[0].context == tmx.cpu() for b in batches)


def test_iterators_need_a_context_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is the default context here")
    from mxnet_tpu_torch.base import DeviceError

    x, y = _data(4)
    with pytest.raises(DeviceError):
        next(iter(tio.NDArrayIter(x, y, batch_size=2)))


# ---------------------------------------------------------------- RecordIO

def _payloads(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [bytes(rng.randint(0, 256, rng.randint(0, 40)).astype(np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recordio_files_cross_both_ways(tmp_path, writer):
    import mxnet_tpu.recordio as jrec

    w, r = (jrec, trec) if writer == "jax" else (trec, jrec)
    recs = _payloads()
    rec, idx = str(tmp_path / "f.rec"), str(tmp_path / "f.idx")
    out = w.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(recs):
        out.write_idx(i, p)
    out.close()
    raw = open(rec, "rb").read()
    # the other package writes the same bytes
    rec2, idx2 = str(tmp_path / "g.rec"), str(tmp_path / "g.idx")
    out2 = r.MXIndexedRecordIO(idx2, rec2, "w")
    for i, p in enumerate(recs):
        out2.write_idx(i, p)
    out2.close()
    assert open(rec2, "rb").read() == raw
    assert open(idx2).read() == open(idx).read()
    # and reads the file back: sequentially, by key, by scan, natively
    seq = r.MXRecordIO(rec, "r")
    got = []
    while True:
        b = seq.read()
        if b is None:
            break
        got.append(b)
    assert got == recs
    ind = r.MXIndexedRecordIO(idx, rec, "r")
    assert [ind.read_idx(k) for k in reversed(ind.keys)] == recs[::-1]
    assert seq.scan_offsets() == [ind.idx[k] for k in ind.keys]
    assert trec.load_offsets(trec.MXRecordIO(rec, "r")) == \
        jrec.load_offsets(jrec.MXRecordIO(rec, "r"))
    assert trec.read_all_native(rec) == recs


def test_irheader_pack_unpack_cross():
    import mxnet_tpu.recordio as jrec

    for label in (3.5, [1.0, 2.0, 7.25]):
        for mod_a, mod_b in ((jrec, trec), (trec, jrec)):
            s = mod_a.pack(mod_a.IRHeader(0, label, 42, 7), b"payload")
            assert s == mod_b.pack(mod_b.IRHeader(0, label, 42, 7),
                                   b"payload")
            h, body = mod_b.unpack(s)
            assert body == b"payload" and h.id == 42 and h.id2 == 7
            np.testing.assert_array_equal(np.asarray(h.label),
                                          np.asarray(label, np.float32))


def test_record_source_and_native_refusals(tmp_path):
    recs = _payloads(5, seed=1)
    rec = str(tmp_path / "s.rec")
    w = trec.MXRecordIO(rec, "w")
    for p in recs:
        w.write(trec.pack(trec.IRHeader(0, float(len(p)), 0, 0), p))
    w.close()
    src = trec.RecordSource(rec)
    assert len(src) == 5
    h, body = src.read(3)
    assert body == recs[3] and h.label == float(len(recs[3]))
    with pytest.raises(IOError):
        trec.read_all_native(str(tmp_path / "missing.rec"))
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\x00" * 12)
    with pytest.raises(ValueError):
        trec.read_all_native(str(bad))
