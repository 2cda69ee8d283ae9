"""``mx.runtime``, ``mx.libinfo`` and ``mx.kvstore_server`` of the port
against the JAX package's: ``Features()`` keeps the JAX names (the TPU
ones read False here) and adds upstream MXNet's GPU names, which read
this process's torch without building anything; ``find_lib_path`` lists
what exists and never builds the kernels; ``KVStoreServer`` raises its
reason."""
import os

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore_server, libinfo, runtime
from mxnet_tpu_torch.ops.cuda import _build
from torch_port_helpers import keep_block_names  # noqa: F401

pytestmark = pytest.mark.usefixtures("keep_block_names")

GPU_NAMES = ("CUDA", "CUDNN", "NCCL", "TRITON", "NVCC", "CUTLASS",
             "CUDA_KERNELS", "HOPPER", "FP8", "CUDA_GRAPHS", "DIST_KVSTORE")


def _jax_feature_names():
    """The names the JAX package's ``_detect`` sets, read from its source
    (its probe imports orbax, seconds for names alone)."""
    import re

    src = os.path.join(os.path.dirname(jmx.__file__), "runtime.py")
    with open(src) as fh:
        return set(re.findall(r'feats\["([A-Z_0-9]+)"\]', fh.read()))


def test_features_keep_the_jax_names_and_add_the_gpu_ones():
    feats = mx.runtime.Features()
    jnames = _jax_feature_names()
    assert "TPU" in jnames and "CPP_HOST_ENGINE" in jnames
    assert jnames <= set(feats)
    assert set(GPU_NAMES) <= set(feats)
    for name in ("TPU", "XLA", "PALLAS", "ORBAX_CHECKPOINT"):
        assert feats.is_enabled(name) is False
    assert feats.is_enabled("cpu") and feats.is_enabled("BF16")
    cuda = torch.cuda.is_available()
    assert feats.is_enabled("CUDA") is cuda
    if not cuda:  # this machine: no card, so none of its features
        for name in ("CUDNN", "NCCL", "HOPPER", "FP8", "CUDA_GRAPHS"):
            assert feats.is_enabled(name) is False, name
    assert feats.is_enabled("CPP_HOST_ENGINE") is os.path.exists(
        mx.engine.native_lib_path())
    assert feats.is_enabled("DIST_KVSTORE") is \
        torch.distributed.is_available()
    with pytest.raises(RuntimeError, match="unknown feature"):
        feats.is_enabled("NOPE")
    assert repr(feats).startswith("[") and "CUDA" in repr(feats)
    assert [f.name for f in runtime.feature_list()] == list(feats)


def test_no_probe_builds_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a capability probe built the kernels")

    monkeypatch.setattr(_build, "extension", refuse)
    feats = runtime.Features()
    assert feats.is_enabled("CUDA_KERNELS") is \
        (libinfo.built_extension() is not None)
    paths = libinfo.find_lib_path()
    assert all(os.path.exists(p) for p in paths)
    assert mx.engine.native_lib_path() in paths
    inc = libinfo.find_include_path()
    assert os.path.isfile(os.path.join(inc, "layernorm.cu"))
    assert libinfo.__version__.startswith("1.9.0")


def test_kvstore_server_raises_its_reason():
    with pytest.raises(RuntimeError, match="no parameter-server role"):
        kvstore_server.KVStoreServer()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        kvstore_server._init_kvstore_server_module()
    with pytest.raises(RuntimeError):
        jmx.kvstore_server.KVStoreServer()


def test_torch_diagnose_runs_to_its_end():
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tool = os.path.join(repo, "tools", "torch_diagnose.py")
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run([sys.executable, tool], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=25)
    assert r.returncode == 0, r.stderr[-2000:]
    for head in ("Features", "Library Info", "Device", "Graph IR",
                 "Compile Store", "Autotuning", "Other Sections"):
        assert "----------%s----------" % head in r.stdout, head
    assert "no CUDA device" in r.stdout or "NVIDIA" in r.stdout


def test_torch_diagnose_json_is_the_snapshot(capsys):
    import importlib.util
    import json

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_diagnose", os.path.join(repo, "tools", "torch_diagnose.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--json"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert {"ir", "comp_cache", "tune"} <= set(snap)
    assert snap["not_ported"] == {}
