"""``gluon.data`` and ``gluon.utils`` of the port against the JAX package's
on the same numpy inputs: the datasets and samplers (one seed, one
order), the DataLoader's serial, thread and process routes (batches in
order and equal, an early break, the worker processes never touching a
CUDA device), ``DevicePrefetcher`` over a device list, ``split_and_load``,
and ``clip_global_norm`` (the norm and the scaled values against the JAX
package's; in place, so a ``Trainer`` steps the scaled gradients, where a
rebinding clip leaves them unscaled)."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import utils as tutils
from torch_port_helpers import jax_trace_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_trace_state")
CPU = tmx.cpu()


def _arrays(n=23, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 9, n).astype(np.int32))


def _host(batch):
    if isinstance(batch, (list, tuple)):
        return [_host(b) for b in batch]
    return np.asarray(batch.asnumpy())


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        else:
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------- datasets

def test_datasets_match():
    from mxnet_tpu.gluon import data as jdata

    x, y = _arrays()
    for mod in (jdata, tdata):
        ds = mod.ArrayDataset(x, y)
        assert len(ds) == 23
    jds, tds = jdata.ArrayDataset(x, y), tdata.ArrayDataset(x, y)

    def first_plus(a):
        return a + 1.0

    views = [
        lambda d: d.transform(lambda a, b: (a * 2.0, b)),
        lambda d: d.transform_first(first_plus),
        lambda d: d.transform(lambda a, b: (a, b), lazy=False),
        lambda d: d.filter(lambda s: s[1] % 2 == 0),
        lambda d: d.take(5),
        lambda d: d.shard(4, 3),
        lambda d: d.sample(tdata.RandomSampler(len(d), seed=4)),
    ]
    for view in views:
        jv, tv = view(jds), view(tds)
        assert len(tv) == len(jv)
        for i in range(len(tv)):
            for a, b in zip(tv[i], jv[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(IndexError):
        tds.shard(4, 3)[-7]
    with pytest.raises(ValueError):
        tds.shard(4, 4)
    assert tdata.SimpleDataset([1, 2, 3])[1] == 2
    assert tdata.ArrayDataset(x)[2].shape == (3,)


def test_record_file_dataset_reads_a_jax_written_file(tmp_path):
    import mxnet_tpu.recordio as jrec
    from mxnet_tpu.gluon import data as jdata

    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(6):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 6
    assert [t[i] for i in range(6)] == [j[i] for i in range(6)]


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match(last):
    from mxnet_tpu.gluon import data as jdata

    for mod in (jdata, tdata):
        assert list(mod.SequentialSampler(5, start=2)) == [2, 3, 4, 5, 6]
    assert list(tdata.RandomSampler(17, seed=8)) == \
        list(jdata.RandomSampler(17, seed=8))
    tb = tdata.BatchSampler(tdata.RandomSampler(17, seed=1), 5, last)
    jb = jdata.BatchSampler(jdata.RandomSampler(17, seed=1), 5, last)
    for _ in range(3):
        assert list(tb) == list(jb)
        assert len(tb) == len(jb)
    x, y = _arrays()
    ds = tdata.ArrayDataset(x, y)
    assert list(tdata.FilterSampler(lambda s: s[1] > 4, ds)) == \
        list(jdata.FilterSampler(lambda s: s[1] > 4,
                                 jdata.ArrayDataset(x, y)))
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(range(3), 2, "bad"))


# ------------------------------------------------------------- DataLoader

def _loader_pair(**kw):
    from mxnet_tpu.gluon import data as jdata

    x, y = _arrays()
    seed = kw.pop("seed", 5)
    jl = jdata.DataLoader(jdata.ArrayDataset(x, y),
                          sampler=jdata.RandomSampler(23, seed=seed), **kw)
    tl = tdata.DataLoader(tdata.ArrayDataset(x, y),
                          sampler=tdata.RandomSampler(23, seed=seed), **kw)
    return jl, tl


@pytest.mark.parametrize("workers,last", [(0, "keep"), (0, "discard"),
                                          (3, "keep"), (2, "rollover")])
def test_dataloader_serial_and_threads_match(workers, last):
    jl, tl = _loader_pair(batch_size=4, last_batch=last, num_workers=workers)
    for _ in range(2):
        jb = [_host(b) for b in jl]
        with tmx.cpu():
            tb = [_host(b) for b in tl]
        _same(tb, jb)
        assert len(tl) == len(jl)
    with tmx.cpu():
        for i, b in enumerate(tl):  # an early break
            if i == 1:
                break
        assert b[0].context == CPU


@pytest.fixture(scope="module")
def process_loader():
    """One pool of two spawned workers for the module (each imports
    torch), closed after."""
    x, y = _arrays()
    tl = tdata.DataLoader(tdata.ArrayDataset(x, y),
                          sampler=tdata.RandomSampler(23, seed=5),
                          batch_size=4, num_workers=2, thread_pool=False)
    yield tl
    tl.close()


def test_dataloader_process_workers_match_and_hide_the_card(
        process_loader):
    from mxnet_tpu.gluon import data as jdata

    x, y = _arrays()
    jl = jdata.DataLoader(jdata.ArrayDataset(x, y),
                          sampler=jdata.RandomSampler(23, seed=5),
                          batch_size=4)
    for _ in range(2):
        with tmx.cpu():
            tb = [_host(b) for b in process_loader]
        _same(tb, [_host(b) for b in jl])
    with tmx.cpu():
        for i, _ in enumerate(process_loader):  # an early break
            if i == 2:
                break
        assert len([_host(b) for b in process_loader]) == 6
    reports = process_loader.worker_reports + process_loader.worker_probe()
    assert len(process_loader._mp_pool._processes) == 2
    for r in reports:
        assert r["CUDA_VISIBLE_DEVICES"] == ""
        assert r["cuda_initialized"] is False
        assert r["device_count"] == 0


def test_mp_batchify_stays_numpy():
    x, y = _arrays(4)
    out = tdata.dataloader.default_mp_batchify_fn([(x[i], y[i])
                                                   for i in range(4)])
    assert all(isinstance(o, np.ndarray) for o in out)
    assert out[0].dtype == np.float32


def test_pin_memory_loader_makes_host_batches_and_places_them():
    jl, tl = _loader_pair(batch_size=5, last_batch="discard",
                          num_workers=2, pin_memory=True)
    with tmx.cpu():
        tb = [_host(b) for b in tl]
    _same(tb, [_host(b) for b in jl])


# ----------------------------------------------------------- prefetcher

def test_device_prefetcher_splits_over_a_device_list():
    x, y = _arrays(10)
    with tmx.cpu():
        batches = [[tmx.nd.array(x[i:i + 5]), tmx.nd.array(y[i:i + 5])]
                   for i in (0, 5)]
    pf = tdata.DevicePrefetcher(batches, ctx=[tmx.cpu(0), tmx.cpu(1),
                                              tmx.cpu(2)])
    got = list(pf)
    assert len(got) == 2 and len(pf) == 2
    parts = got[0][0]
    assert [p.shape[0] for p in parts] == [1, 1, 3]  # the last takes the rest
    np.testing.assert_array_equal(np.concatenate([p.asnumpy() for p in parts]),
                                  x[:5])
    with pytest.raises(TypeError):
        tdata.DevicePrefetcher(batches, ctx=object())


def test_split_and_load_matches():
    from mxnet_tpu.gluon import utils as jutils

    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    got = tutils.split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
    assert [g.shape for g in got] == [(5, 2), (5, 2)]
    np.testing.assert_array_equal(np.concatenate([g.asnumpy() for g in got]),
                                  x)
    with pytest.raises(ValueError):
        tutils.split_and_load(x[:9], [tmx.cpu(0), tmx.cpu(1)])
    uneven = tutils.split_and_load(x[:9], [tmx.cpu(0), tmx.cpu(1)],
                                   even_split=False)
    assert [u.shape[0] for u in uneven] == [4, 5]
    jparts = jutils.split_data(jutils.split_and_load(
        x[:9], [jutils_cpu()])[0], 2, even_split=False)
    for a, b in zip(uneven, jparts):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    one = tutils.split_and_load(tmx.nd.array(x, ctx=CPU), [CPU])
    assert len(one) == 1 and one[0].shape == (10, 2)


def jutils_cpu():
    import mxnet_tpu as jmx

    return jmx.cpu()


# -------------------------------------------------------- clip_global_norm

@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_global_norm_matches(max_norm):
    from mxnet_tpu import nd as jnd
    from mxnet_tpu.gluon import utils as jutils

    rng = np.random.RandomState(2)
    vals = [rng.randn(*s).astype(np.float32) for s in ((3, 4), (5,), (2, 2))]
    jarrs = [jnd.array(v) for v in vals]
    tarrs = [tmx.nd.array(v, ctx=CPU) for v in vals]
    tensors = [a._data for a in tarrs]
    jn = jutils.clip_global_norm(jarrs, max_norm)
    tn = tutils.clip_global_norm(tarrs, max_norm)
    assert abs(tn - jn) <= 1e-6 * abs(jn)
    want = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in vals))
    assert abs(tn - want) <= 1e-6 * want
    for t, a, j in zip(tensors, tarrs, jarrs):
        assert a._data is t  # scaled in place
        np.testing.assert_allclose(a.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    bad = [tmx.nd.array(np.array([np.inf], np.float32), ctx=CPU)]
    assert not np.isfinite(tutils.clip_global_norm(bad, 1.0))


def _rebinding_clip(arrays, max_norm):
    """The JAX form transliterated: each array rebound to a scaled copy."""
    norm = float(np.sqrt(sum(float((a.asnumpy().astype(np.float64) ** 2)
                                   .sum()) for a in arrays)))
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._data = a._data * scale
    return norm


def _trainer_step(clip):
    net = tgluon.nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 1.0})
    x = tmx.nd.array(np.random.RandomState(3).randn(6, 4).astype(np.float32),
                     ctx=CPU)
    with tmx.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    params = list(net.collect_params().values())
    before = [p.data().asnumpy().copy() for p in params]
    grads = [p.grad() for p in params]
    g0 = [g.asnumpy().copy() for g in grads]
    norm = clip(grads, 0.5)
    tr.step(1)
    return before, g0, norm, [p.data().asnumpy() for p in params]


def test_clip_global_norm_scales_trainer_gradients_in_place():
    before, g0, norm, after = _trainer_step(tutils.clip_global_norm)
    scale = 0.5 / (norm + 1e-8)
    assert scale < 1.0
    for b, g, a in zip(before, g0, after):
        np.testing.assert_allclose(a, b - g * scale, rtol=1e-5, atol=1e-6)
    # the planted rebinding clip leaves the Trainer's gradients unscaled
    before, g0, norm, after = _trainer_step(_rebinding_clip)
    assert not all(np.allclose(a, b - g * 0.5 / norm, rtol=1e-5, atol=1e-6)
                   for b, g, a in zip(before, g0, after))


def test_check_sha1_and_download(tmp_path):
    import hashlib

    p = tmp_path / "f.bin"
    p.write_bytes(b"abc" * 1000)
    assert tutils.check_sha1(str(p), hashlib.sha1(b"abc" * 1000).hexdigest())
    assert not tutils.check_sha1(str(p), "0" * 40)
    with pytest.raises(RuntimeError):
        tutils.download("http://localhost/none")
