"""A CPU rehearsal of ``chip_smoke.py``'s slice-24 phase at small settings:
``phase_sparse_lm`` on a 2-layer LSTM LM of width 32 (vocabulary 200,
batch 4 x bptt 5) trained by ``Estimator.fit`` with a ``SparseEmbedding``,
and the CSR path on a libsvm file of 2 batches of 8 rows over 3900
features. The kernels do not launch on the CPU: the launch check, and only
it, fails here; every other check, the planted fault's catch among them,
holds. ``time_ms`` (CUDA graphs) is stood in for by one call of each
function."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from torch_port_helpers import few_threads, keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads", "keep_block_names")

CPU = torch.device("cpu")


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(cs, "SPARSE_LM", dict(
        vocab=200, batch=4, bptt=5, hidden=32, layers=2, dropout=0.5))
    monkeypatch.setattr(cs, "CSR_RECIPE", dict(
        batch=8, batches=2, features=3900, fields=39, numeric=13, cols=16))
    monkeypatch.setattr(cs, "SPARSE_TIMED", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")

    def once(*fns, **kw):
        for fn in fns:
            fn()
        return 0.0 if len(fns) == 1 else [0.0] * len(fns)

    monkeypatch.setattr(cs, "time_ms", once)
    failed = []

    def check(cond, what):
        if not cond:
            if "launch" not in what:
                raise cs.SmokeFailure(what)
            failed.append(what)

    monkeypatch.setattr(cs, "check", check)
    return failed


def test_sparse_lm_phase_on_the_cpu(small):
    records = [{"name": "softmax_xent_fwd"}, {"name": "softmax_xent_bwd"}]
    out = cs.run_slice24(CPU, records)
    assert len(out["losses"]) == cs.SPARSE_LM_STEPS
    g = out["row_sparse_grad"]
    assert g["stype"] == "row_sparse" and g["rows"] == g["unique_ids"]
    assert g["calls"] == cs.SPARSE_LM_STEPS and g["rows"] <= 20
    assert out["untouched"]["rows"] > 0
    assert out["untouched"]["weight_kept"] and out["untouched"][
        "momentum_kept"]
    assert out["step1_gap"] <= cs.SPARSE_UPDATE_TOL
    assert out["step2_gap"] <= cs.SPARSE_UPDATE_TOL
    # the plain versions are the run itself on the CPU
    assert out["vs_plain"]["gaps"] == [0.0] * cs.SPARSE_LM_STEPS
    assert out["planted_fault"]["caught"]
    ck = out["checkpoint"]
    assert ck["trained"] == ck["loaded"]
    assert "sparse_lm-epoch0.params" in ck["files"]
    assert "sparse_lm-epoch0.states" in ck["files"]
    csr = out["csr"]
    assert csr["batches"] == 2 and csr["nnz"] == 2 * 8 * 39
    assert csr["worst_ratio"] <= 1.0 and csr["max_abs_err_fp64"] < 1e-4
    assert out["lazy_update_timing"]["rows"] == g["rows"]
    st = out["storage"]
    assert st["pulled_equal"] and st["ids_equal"] and st["round_trip_equal"]
    assert st["rows"] == g["rows"]
    for r in records:
        e = r["sparse_lm_train"]
        assert e["shape"] == [20, 200] and e["bound_ms"] > 0
        assert e["max_abs_err"] == 0.0
    # no kernel launches on the CPU: the launch checks fail, and only they
    assert sorted(small) == [
        "sparse lm %s launches 0 != 1 x 3 steps" % n
        for n in ("softmax_xent_bwd", "softmax_xent_fwd")]
    assert not cs._slice24_tmp


def test_a_dropped_row_reads_above_the_limit():
    """The spy's reading on its own: a lazy update that skips a touched row
    is off by that row's step; one that runs them all is not."""
    from mxnet_tpu_torch import optimizer, sparse

    g = torch.zeros(6, 3)
    g[[1, 4]] = torch.tensor([[0.5, -0.25, 1.0], [2.0, 0.0, -1.0]])
    for drop in (False, True):
        opt = optimizer.SGD(learning_rate=1.0, momentum=0.9)
        w = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))

        class P:
            _data = w.detach().clone().requires_grad_()

        P._data.grad = g
        opt.param_dict = {0: P}
        spy = cs._RowSparseSpy(opt, drop_id=drop)
        opt._update_rsp = spy
        opt.update(0, w, sparse.dense_to_row_sparse(g),
                   opt.create_state(0, w))
        gap = spy.gap()
        assert (gap > 1.0) if drop else (gap == 0.0)
        if drop:
            assert spy.first["dropped"] == 4


@pytest.mark.parametrize("broken", [False, True])
def test_step2_reading_sees_the_momentum_rows(broken):
    """The step-2 reading: the real lazy update over two steps agrees with
    the dense momentum step; one that steps the weight rows but leaves
    the momentum rows unwritten is off by that step."""
    from mxnet_tpu_torch import optimizer, sparse

    gen = torch.Generator().manual_seed(1)
    grads = [torch.zeros(6, 3), torch.zeros(6, 3)]
    grads[0][[1, 4]] = torch.randn(2, 3, generator=gen)
    grads[1][[1, 2]] = torch.randn(2, 3, generator=gen)
    opt = optimizer.SGD(learning_rate=1.0, momentum=0.9)
    w = torch.randn(6, 3, generator=gen)

    class P:
        _data = w.detach().clone().requires_grad_()

    opt.param_dict = {0: P}
    spy = cs._RowSparseSpy(opt)
    if broken:
        real = spy.real

        def no_momentum_scatter(index, weight, grad, state):
            before = state.clone()
            real(index, weight, grad, state)
            return state.copy_(before)

        spy.real = no_momentum_scatter
    opt._update_rsp = spy
    state = opt.create_state(0, w)
    for g in grads:
        P._data.grad = g
        state = opt.update(0, w, sparse.dense_to_row_sparse(g), state)
    gap = spy.gap2(0.9)
    assert (gap > 0.1) if broken else (gap == 0.0)


def test_libsvm_file_has_criteo_layout(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "CSR_RECIPE", dict(
        batch=4, batches=1, features=390, fields=39, numeric=13, cols=2))
    path = str(tmp_path / "f.libsvm")
    ids, vals = cs._write_libsvm(path, np.random.default_rng(0))
    lines = open(path).read().splitlines()
    assert len(lines) == 4
    for line, row in zip(lines, ids):
        parts = line.split()
        assert parts[0] in ("0", "1") and len(parts) == 40
        cols = [int(p.split(":")[0]) for p in parts[1:]]
        assert cols == list(row) and cols == sorted(cols)
        assert all(c // 10 == f for f, c in enumerate(cols))
        assert all(p.endswith(":1") for p in parts[14:])


def test_slice24_group_is_listed():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "cuda_phases.py")
    spec = importlib.util.spec_from_file_location("_cuda_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert {"sparse_lm", "slice24"} <= set(mod.GROUPS)
