"""The port's names against the JAX package's: ``dir(mxnet_tpu)`` less
``dir(mxnet_tpu_torch)`` is exactly ``MISSING``, each name with the
ROADMAP.md item that ports it (or why it has none); the same for every
submodule both packages have (``MISSING_IN``: the names a JAX module
defines itself) and for the main classes (``MISSING_ATTRS``). A name the port gains
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
    # the JAX package's TPU context: the port's accelerator is mx.gpu
    "tpu": "not applicable", "num_tpus": "not applicable",
}


JAX_INTERNAL = ("not applicable, because it is the JAX package's machinery "
                "over XLA (jit funnels, threefry keys, XLA compile "
                "counters), which the port's torch programs do not have")

# submodule -> {name the JAX module defines and the port's lacks: its item}
# ("ops" keeps its functional ops in ops.functional, compared there)
MISSING_IN = {
    "autograd": {"TapeNode": JAX_INTERNAL, "append_node": JAX_INTERNAL,
                 "mark_grad_private": JAX_INTERNAL,
                 "mark_grad_shared": JAX_INTERNAL},
    "base": {n: JAX_INTERNAL for n in (
        "OpDef", "bulk_jitted", "check_call", "is_tpu_backend", "jitted",
        "tape_jitted")},
    "analysis.hlolint": dict(
        {n: "not applicable, because the port has no StableHLO text: it "
            "lints the op records observability.costs keeps (lint_record, "
            "Program)" for n in ("HloOp", "TType", "Arg", "parse_program",
                                 "parse_type", "lint_text")},
        DONATE_MIN_BYTES="not applicable, because it is GL022's threshold "
                         "and torch has no buffer donation",
        **{n: "not applicable, because the corpus is observability.costs' "
              "op records, kept at the cost seam (costs.records, "
              "costs.reset)" for n in ("capture", "corpus", "reset")}),
    "observability.costs": {
        n: "not applicable, because the port counts a program on its "
           "first run at the capture seam (costs.counting), not from an "
           "XLA executable parked for later analysis"
        for n in ("materialize", "record_compiled", "tracked")},
    "context": {"tpu": "not applicable, because the port's accelerator is "
                       "mx.gpu", "num_tpus": "not applicable, because the "
                       "port's accelerator is mx.gpu"},
    "engine": {n: JAX_INTERNAL for n in (
        "decode_compile_counter",
        "dist_bucket_counter", "dist_compile_counter",
        "serve_compile_counter", "verify_dispatch_counter")},
    "gluon.block": {"builtins_sum": "not applicable, because it is a "
                                    "helper of the JAX summary()"},
    "linalg": {n: JAX_INTERNAL for n in (
        "k_gelqf", "k_gemm2", "k_potri", "k_syrk", "k_trmm", "k_trsm")},
    "ndarray": {"LazyExpr": "not applicable, because the port's bulk "
                            "window keeps its own record of deferred ops, "
                            "which it converts into the IR at its flush "
                            "(ir.graph.from_window)"},
    "observability.watchdog": {
        "compile_context": "not applicable, because each port build site "
                           "names its key in the counter's bump(note=)",
        "current_context": "not applicable, because each port build site "
                           "names its key in the counter's bump(note=)"},
    "operator": {
        "register_jax_op": "not applicable, because it registers a JAX "
                           "function: its torch counterpart is "
                           "operator.register_torch_op",
        "as_jax_fn": "not applicable, because it wraps a host CustomOp in "
                     "jax.pure_callback for traced JAX code: a torch "
                     "program calls nd.Custom directly, and a CUDA graph "
                     "capture of it raises"},
    "ops": "not applicable, because the port keeps its functional ops in "
           "ops.functional (ops.F), compared there",
    "ops.detection": {n: "A.17" for n in (
        "onnx_gather_nd", "onnx_nms", "onnx_scatter_nd", "yolo3_decode",
        "yolo3_target")},
    "ops.functional": {"linalg_gemm2": "not applicable, because the port "
                                       "defines it in ops.legacy_ops with "
                                       "the other linalg ops"},
    "parallel": {"get_shard_map": "not applicable, because each torch rank "
                                  "runs its own program"},
    "parallel.mesh": {"get_shard_map": "not applicable, because each torch "
                                       "rank runs its own program"},
    "random": {n: JAX_INTERNAL for n in (
        "get_state", "next_key", "set_state", "split")},
    "serve": {"symbol_infer_fn": "not applicable, because the port's "
                                 "SymbolBlock is hybridized at "
                                 "construction (A.14)"},
    "serve.executor_pool": {"symbol_infer_fn": "not applicable, because "
                                               "the port's SymbolBlock is "
                                               "hybridized at construction "
                                               "(A.14)"},
    "sym": dict({n: "A.17" for n in (
        "BilinearSampler", "DeformableConvolution", "GridGenerator",
        "ModulatedDeformableConvolution", "MultiProposal", "PSROIPooling",
        "Proposal", "ROIAlign", "ROIPooling", "SpatialTransformer",
        "bilinear_sampler", "deformable_convolution", "grid_generator",
        "modulated_deformable_convolution", "multi_proposal", "proposal",
        "psroi_pooling", "roi_align", "roi_pooling", "spatial_transformer",
        "yolo3_decode", "yolo3_target")},
        space_to_depth_stem_conv="not applicable, because the space-to-depth "
                                 "stem only re-lays the TPU's input lanes "
                                 "(A.11)"),
}

# class -> {public attribute the JAX class has and the port's lacks: item}
MISSING_ATTRS = {
    "gluon.Parameter": {}, "gluon.ParameterDict": {}, "gluon.Block": {},
    "gluon.HybridBlock": {}, "gluon.SymbolBlock": {}, "gluon.Trainer": {},
    "Context": {"jax_device": JAX_INTERNAL},
    "serve.ModelServer": {}, "serve.GenerativeServer": {},
    "serve.PagedKVCache": {"update": JAX_INTERNAL},
    "serve.DynamicBatcher": {}, "serve.FleetRouter": {},
    "serve.WorkerHandle": {}, "serve.Autoscaler": {},
    "kvstore.KVStore": {}, "nd.NDArray": {}, "optimizer.Optimizer": {},
    "module.Module": {}, "sym.Symbol": {}, "initializer.Initializer": {},
    "io.DataIter": {}, "metric.EvalMetric": {}, "amp.LossScaler": {},
    "gluon.data.DataLoader": {},
}

_SUBMODULE_NAMES = r"""
import importlib, json, pkgutil, types, functools
import mxnet_tpu, mxnet_tpu_torch
def own(mod, name, n):
    o = getattr(mod, n)
    if isinstance(o, types.ModuleType):
        return False
    m = getattr(o, "__module__", None)
    if not isinstance(m, str):
        return n.isupper()
    if hasattr(mod, "__path__"):
        return m == name or m.startswith(name + ".")
    return m == name
mods, attrs = {}, {}
for info in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                  "mxnet_tpu_torch."):
    sub = info.name[len("mxnet_tpu_torch."):]
    if any(part.startswith("_") for part in sub.split(".")):
        continue
    try:
        jm = importlib.import_module("mxnet_tpu." + sub)
    except ImportError:
        continue
    pm = importlib.import_module(info.name)
    mods[sub] = sorted(n for n in dir(jm) if n[0] != "_"
                       and own(jm, "mxnet_tpu." + sub, n)
                       and not hasattr(pm, n))
get = lambda m, p: functools.reduce(getattr, p.split("."), m)
for cls in json.loads(CLASSES):
    a, b = get(mxnet_tpu, cls), get(mxnet_tpu_torch, cls)
    attrs[cls] = sorted(n for n in dir(a) if n[0] != "_"
                        and not hasattr(b, n))
print(json.dumps({"mods": mods, "attrs": attrs}))
"""


@pytest.fixture(scope="module")
def sub_names():
    """{"mods": {submodule: names the JAX one defines that the port's
    lacks}, "attrs": {class: attributes likewise}}, in a fresh
    interpreter."""
    code = "CLASSES = %r\n" % json.dumps(sorted(MISSING_ATTRS)) + \
        _SUBMODULE_NAMES
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _valid_item(v):
    return v.startswith("A.") or v.startswith("not applicable, because ")


def test_submodule_names_are_listed_with_their_item(sub_names):
    got = sub_names["mods"]
    for mod, lacking in got.items():
        table = MISSING_IN.get(mod, {})
        if isinstance(table, str):
            assert _valid_item(table), mod
            continue
        assert set(lacking) - set(table) == set(), \
            "%s: names the port lacks and MISSING_IN does not list" % mod
    for mod, table in MISSING_IN.items():
        if isinstance(table, str):
            continue
        assert set(table) - set(got.get(mod, ())) == set(), \
            "%s: names MISSING_IN lists that the port has" % mod
        assert all(_valid_item(v) for v in table.values()), mod


def test_class_attributes_are_listed_with_their_item(sub_names):
    for cls, lacking in sub_names["attrs"].items():
        assert set(lacking) == set(MISSING_ATTRS[cls]), cls
        assert all(_valid_item(v) for v in MISSING_ATTRS[cls].values())


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
                       capture_output=True, text=True, timeout=45)
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
