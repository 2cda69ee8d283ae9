"""The port's top-level names against the JAX package's: ``dir(mxnet_tpu)``
less ``dir(mxnet_tpu_torch)`` is exactly ``MISSING``, each name with the
ROADMAP.md item that ports it (or why it has none). A name the port gains
must leave the list, and a name the JAX package gains must join it: the
test fails until the list says so. Both packages are read in a fresh
interpreter: a submodule that another test imported joins its package's
``dir``."""
import json
import os
import subprocess
import sys

import pytest

import mxnet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MISSING = {
    # A.16's rest: tooling
    "analysis": "A.16", "runtime": "A.16", "libinfo": "A.16",
    "kvstore_server": "A.16",
    # A.17: the rest
    "contrib": "A.17", "numpy_api": "A.17", "np": "A.17",
    "npx": "A.17", "np_array": "A.17", "np_shape": "A.17",
    "use_np": "A.17", "use_np_array": "A.17", "use_np_shape": "A.17",
    "onnx": "A.17", "operator": "A.17", "registry": "A.17",
    "sparse": "A.17",
    # the JAX package's TPU context: the port's accelerator is mx.gpu
    "tpu": "not applicable", "num_tpus": "not applicable",
}


@pytest.fixture(scope="module")
def names():
    """{module: its public names} at import, in a fresh interpreter."""
    code = ("import json, mxnet_tpu, mxnet_tpu.parallel, mxnet_tpu_torch; "
            "pub = lambda m: sorted(n for n in dir(m) if n[0] != '_'); "
            "print(json.dumps({'jax': pub(mxnet_tpu), "
            "'jax.parallel': pub(mxnet_tpu.parallel), "
            "'port': pub(mxnet_tpu_torch), "
            "'port.parallel': pub(mxnet_tpu_torch.parallel)}))")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return {k: set(v) for k, v in json.loads(
        r.stdout.strip().splitlines()[-1]).items()}


def test_missing_names_are_listed_with_their_item(names):
    missing = names["jax"] - names["port"]
    assert missing - set(MISSING) == set(), \
        "names the port lacks and MISSING does not list"
    assert set(MISSING) - missing == set(), \
        "names MISSING lists that the port has (or the JAX package lacks)"
    assert all(v.startswith("A.") or v == "not applicable"
               for v in MISSING.values())


def test_bound_at_import():
    """What MXNet scripts reach through ``mx.`` resolves without importing
    the submodule first."""
    mx = mxnet_tpu_torch
    assert callable(mx.kvstore.create)
    assert mx.lr_scheduler.FactorScheduler is not None
    assert callable(mx.parallel.ring_attention)
    assert callable(mx.waitall)
    assert mx.init.Xavier is mx.initializer.Xavier
    assert issubclass(mx.MXNetError, RuntimeError)
    assert mx.cpu_pinned().torch_device().type == "cpu"
    assert mx.dist.attach is not None
    assert mx.mod.Module is mx.module.Module
    assert callable(mx.model.save_checkpoint)
    assert mx.callback.Speedometer is not None
    assert mx.monitor.Monitor is not None
    assert isinstance(mx.metric.create("acc"), mx.metric.Accuracy)
    assert mx.rnn.BucketSentenceIter is not None
    assert mx.io.NDArrayIter is not None
    assert mx.recordio.MXRecordIO is not None
    assert mx.gluon.data.DataLoader is not None
    assert callable(mx.gluon.utils.split_and_load)
    assert mx.image.ImageIter is not None
    assert mx.image_det.CreateDetAugmenter is mx.image.CreateDetAugmenter
    assert mx.image.ImageDetIter is mx.io.ImageDetRecordIter
    assert callable(mx.recordio.pack_img)
    assert mx.gluon.data.vision.transforms.ToTensor is not None
    assert callable(mx.profiler.set_config)
    assert callable(mx.observability.snapshot)


def test_parallel_exports_match_the_jax_package(names):
    """``parallel`` exports what ``mxnet_tpu.parallel`` does, less
    ``get_shard_map`` (each torch rank runs its own program)."""
    assert names["jax.parallel"] - names["port.parallel"] == \
        {"get_shard_map"}
