"""``gluon.contrib.estimator`` of the port: the fit loop and its handlers
against the JAX package's on the same net and data, the handler cases of
the JAX package's ``tests/test_estimator.py`` on the port, and the twin
``examples/torch_train_estimator.py``'s first loss against the JAX
example's.

Tolerances: a run of both Estimators from the same weights gives the same
per-batch losses within fp32 1e-5 relative (Adam's steps round alike to a
few ulps over 8 steps) and the same accuracies exactly; the twin's first
loss is the JAX example's within fp32 1e-4 absolute, the fp32 loss
tolerance of the other twins (tests/test_torch_port_examples.py).
"""
import importlib.util
import os
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import estimator as jest
from torch_port_helpers import (jax_params, jax_trace_state_module,  # noqa: F401
                                keep_block_names)

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.convert import carry_params
from mxnet_tpu_torch.gluon import loss as gloss, nn
from mxnet_tpu_torch.gluon.contrib.estimator import (
    CheckpointHandler, EarlyStoppingHandler, Estimator,
    LoggingHandler, MetricHandler, ValidationHandler)

pytestmark = pytest.mark.usefixtures("jax_trace_state_module",
                                      "keep_block_names")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _np_batches(n=32, d=8, classes=3, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, classes, n)
    return [(x[i:i + batch], y[i:i + batch]) for i in range(0, n, batch)]


def _toy_data(n=32, d=8, classes=3, batch=8, seed=0):
    return [(nd.array(x), nd.array(y))
            for x, y in _np_batches(n, d, classes, batch, seed)]


def _toy_net(classes=3):
    net = nn.Sequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(classes))
    net.initialize()
    return net


def _estimator(**kw):
    net = _toy_net()
    return Estimator(net, gloss.SoftmaxCrossEntropyLoss(),
                     train_metrics=mx.metric.Accuracy(), **kw), net


def test_fit_matches_the_jax_estimator(tmp_path):
    """Both Estimators from the same weights: the losses, accuracies,
    checkpoint files and early stop agree."""
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(16, activation="relu"), jnn.Dense(3))
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.zeros((1, 8)))
    net = _toy_net()
    net(nd.zeros((1, 8)))
    carry_params(net, jax_params(jnet))
    runs = []
    for pkg, model, dirname in ((jmx, jnet, "jax"), (mx, net, "port")):
        E = jest if pkg is jmx else __import__(
            "mxnet_tpu_torch.gluon.contrib.estimator", fromlist=["x"])
        array = jnd.array if pkg is jmx else nd.array
        train = [(array(x), array(y)) for x, y in _np_batches(n=32)]
        val = [(array(x), array(y)) for x, y in _np_batches(n=16, seed=1)]
        est = E.Estimator(
            model, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
            train_metrics=pkg.metric.Accuracy(),
            trainer=pkg.gluon.Trainer(model.collect_params(), "adam",
                                      {"learning_rate": 0.01}))

        class Rec(E.BatchEnd):
            losses = []

            def batch_end(self, estimator, batch=None):
                self.losses.append(float(
                    estimator._last_loss.mean().asscalar()))

        rec = Rec()
        rec.losses = []
        ckpt = str(tmp_path / dirname)
        stop = E.EarlyStoppingHandler(monitor="validation accuracy",
                                      patience=1, mode="max")
        out = est.fit(train, val_data=val, epochs=2, event_handlers=[
            rec, stop, E.CheckpointHandler(ckpt, model_prefix="m",
                                           save_best=True,
                                           monitor="validation accuracy",
                                           mode="max")])
        runs.append({"losses": rec.losses, "train": out,
                     "val": [m.get() for m in est.val_metrics],
                     "files": sorted(os.listdir(ckpt)),
                     "best": stop.best, "epoch": est.current_epoch})
    jr, tr = runs
    np.testing.assert_allclose(tr["losses"], jr["losses"], rtol=1e-5)
    assert tr["train"] == jr["train"] and tr["val"] == jr["val"]
    assert tr["files"] == jr["files"] and tr["epoch"] == jr["epoch"]
    assert tr["best"] == jr["best"]


def test_fit_runs_and_tracks_metrics():
    est, _ = _estimator()
    (name, acc), = est.fit(_toy_data(), epochs=2)
    assert name == "accuracy" and 0.0 <= acc <= 1.0
    assert est.current_epoch == 1


def test_loss_decreases_over_epochs():
    est, _ = _estimator()
    data = _toy_data(n=64)
    first = est.evaluate(data, metrics=mx.metric.Loss())
    est.fit(data, epochs=8)
    last = est.evaluate(data, metrics=mx.metric.Loss())
    assert last[0][1] < first[0][1]


def test_validation_handler_periods():
    est, _ = _estimator()
    calls = []
    vh = ValidationHandler(_toy_data(seed=1),
                           lambda d: calls.append(est.evaluate(d)),
                           epoch_period=2)
    est.fit(_toy_data(), epochs=4, event_handlers=[vh])
    assert len(calls) == 2  # epochs 1 and 3
    calls = []
    vh = ValidationHandler(_toy_data(seed=1), lambda d: calls.append(1),
                           epoch_period=None, batch_period=3)
    est.fit(_toy_data(), epochs=1, event_handlers=[vh])  # 4 batches
    assert len(calls) == 1


def test_default_validation_handler_populates_val_metrics():
    est, _ = _estimator()
    est.fit(_toy_data(), val_data=_toy_data(seed=1), epochs=1)
    assert est.val_metrics[0].get()[0] == "validation accuracy"
    assert est.val_metrics[0].num_inst > 0


def test_stopping_handler_max_batch():
    est, _ = _estimator()
    seen = []

    class Counter:
        def batch_end(self, estimator, batch=None):
            seen.append(estimator.current_batch)

    est.fit(_toy_data(), epochs=100, event_handlers=[Counter()], batches=6)
    assert len(seen) == 6


def _series(values):
    class Series(MetricHandler):
        """The monitored metric overwritten with ``values(epoch)``."""

        def __init__(self):
            pass

        def epoch_begin(self, estimator):
            pass

        def batch_end(self, estimator, batch=None):
            m = estimator.train_metrics[0]
            m.reset()
            m.sum_metric = values(estimator.current_epoch)
            m.num_inst = 1

    return Series()


def test_early_stopping_patience_and_min_delta():
    est, _ = _estimator()
    h = EarlyStoppingHandler(monitor="accuracy", patience=2, mode="max")
    est.fit(_toy_data(), epochs=50,
            event_handlers=[_series(lambda e: -float(e)), h])
    assert est.current_epoch == 2 and h.stopped_epoch == 2
    est, _ = _estimator()
    h = EarlyStoppingHandler(monitor="accuracy", patience=3, mode="max",
                             min_delta=0.01)
    est.fit(_toy_data(), epochs=50,
            event_handlers=[_series(lambda e: 1.0 + 1e-6 * e), h])
    assert est.current_epoch == 3


def test_checkpoint_rotation_best_and_batch_period(tmp_path):
    est, _ = _estimator()
    ch = CheckpointHandler(str(tmp_path / "a"), model_prefix="m",
                           save_best=True, monitor="accuracy", mode="max",
                           max_checkpoints=2)
    est.fit(_toy_data(), epochs=5, event_handlers=[ch])
    files = sorted(os.listdir(tmp_path / "a"))
    assert len([f for f in files if "epoch" in f
                and f.endswith(".params")]) == 2
    assert "m-best.params" in files and "m-epoch4.states" in files
    est, _ = _estimator()
    ch = CheckpointHandler(str(tmp_path / "b"), model_prefix="m",
                           epoch_period=None, batch_period=1,
                           max_checkpoints=3)
    est.fit(_toy_data(), epochs=3, event_handlers=[ch])  # 12 batch saves
    assert len([f for f in os.listdir(tmp_path / "b")
                if f.endswith(".params")]) == 3


def test_checkpoint_resume(tmp_path):
    est, net = _estimator()
    ch = CheckpointHandler(str(tmp_path), model_prefix="m",
                           max_checkpoints=20)
    est.fit(_toy_data(), epochs=12, event_handlers=[ch])
    assert os.path.exists(tmp_path / "m-epoch11.params")
    ref = {k: v.data().asnumpy()
           for k, v in net._collect_params_with_prefix().items()}
    est2, net2 = _estimator()
    ch2 = CheckpointHandler(str(tmp_path), model_prefix="m",
                            max_checkpoints=20, resume_from_checkpoint=True)
    # a fit of no epochs still fires train_begin: the newest epoch (11,
    # not the lexically last 9) loads
    est2.fit(_toy_data(), epochs=0, event_handlers=[ch2])
    for k, v in net2._collect_params_with_prefix().items():
        np.testing.assert_allclose(v.data().asnumpy(), ref[k], rtol=1e-6)
    est3, _ = _estimator()
    ch3 = CheckpointHandler(str(tmp_path), model_prefix="m",
                            max_checkpoints=20, resume_from_checkpoint=True)
    est3.fit(_toy_data(), epochs=2, event_handlers=[ch3])
    files = os.listdir(tmp_path)
    assert "m-epoch12.params" in files and "m-epoch13.params" in files
    # the trainer state came back: Adam's count went on from 12 epochs
    assert est3.trainer._optimizer.num_update > len(_toy_data()) * 12


def test_fit_empty_loader_stops():
    est, _ = _estimator()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        est.fit([], batches=10)
    assert any("no batches" in str(w.message) for w in rec)


def test_logging_handler(capsys):
    est, _ = _estimator()
    est.fit(_toy_data(), epochs=1,
            event_handlers=[LoggingHandler(log_interval=2)])
    out = capsys.readouterr().out
    assert "samples/s" in out and "epoch 0 done" in out
    est.fit(_toy_data(), epochs=1,
            event_handlers=[LoggingHandler(log_interval="epoch")])
    out = capsys.readouterr().out
    assert "samples/s" not in out and "epoch 0 done" in out


def test_default_monitor_prefers_validation_metric():
    from mxnet_tpu_torch.gluon.contrib.estimator import _monitored_value

    est, _ = _estimator()
    est.train_metrics[0].update(nd.array([1, 1]), nd.array(np.eye(3)[[0, 0]]))
    name, _ = _monitored_value(est, None, "test")
    assert name == est.train_metrics[0].get()[0]
    est.val_metrics = [mx.metric.Accuracy()]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        name, val = _monitored_value(est, None, "test")
    assert name == est.train_metrics[0].get()[0] and val == 0.0
    assert any("TRAIN metric" in str(r.message) for r in rec)
    est.val_metrics[0].update(nd.array([1, 2]), nd.array(np.eye(3)[[1, 2]]))
    assert _monitored_value(est, None, "test") == (
        est.val_metrics[0].get()[0], 1.0)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_first_loss_matches_jax_example():
    jex = _load("examples/train_estimator.py", "_jax_example_estimator")
    tw = _load("examples/torch_train_estimator.py", "_twin_estimator")
    jnet = jnn.Sequential()
    jnet.add(jnn.Dense(64, activation="relu"), jnn.Dense(5))
    jnet.initialize(jmx.init.Xavier())
    x, y = jex.make_data(256, seed=0)[0]
    jl = float(jloss.SoftmaxCrossEntropyLoss()(jnet(x), y).mean()
               .asscalar())
    tx, ty = tw.make_data(256, seed=0)[0]
    np.testing.assert_array_equal(tx.asnumpy(), x.asnumpy())
    np.testing.assert_array_equal(ty.asnumpy(), y.asnumpy())
    r = tw.main(["--device", "cpu", "--epochs", "2", "--samples", "256"],
                weights=jax_params(jnet))
    assert abs(r["losses"][0] - jl) <= LOSS_TOL
    assert r["epochs_run"] == 2 and "mlp-best.params" in r["checkpoints"]
    assert len(r["losses"]) == 2 * 8
