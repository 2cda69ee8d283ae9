"""The port stands alone: no file of ``mxnet_tpu_torch/``, not
``chip_smoke.py`` and not the case table it reads imports JAX or the JAX
package; the package (the GPT
model, the generative server, the checkpoint layer, the snapshots, the
optimizers, the LR schedulers, ``ir.tune``, ``parallel``, the vision
layers, the model zoo, NDArray and the ``nd`` namespace, ``gluon.rnn``,
the detection ops and the LSTM, SSD and Transformer models, the kvstore,
``dist``, ``parallel``, the converters and the model store, tensor,
sequence, pipeline and expert parallelism and ``SyncBatchNorm``, the
shared capture module and ``hybridize``'s programs, the engine's bulk
window, the symbolic API, the Module family, control flow, the host
I/O, the image path, the observability core and the profiler, cost
attribution, the analysis tools, the replica fleet, ``onnx``, sparse
storage, ``operator``, ``registry``, ``np``/``npx``, ``contrib`` and
``gluon.contrib``'s cells and Estimator included) imports with JAX
blocked; the example and tool twins
(``examples/torch_*.py``, ``tools/torch_*.py``) import neither; and without
CUDA every entry point refuses to run unless the caller asks for the
CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mxnet_tpu_torch")


def _port_sources():
    for root, dirs, files in os.walk(PORT):
        if "_build" in dirs:  # build outputs, not sources
            dirs.remove("_build")
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "nd_op_cases.py")  # chip_smoke's
    yield os.path.join(REPO, "tools", "torch_resnet_ref.py")  # and this
    yield os.path.join(REPO, "tools", "torch_fleet_factory.py")  # workers'
    yield os.path.join(REPO, "tools", "cuda_phases.py")
    # the example and tool twins
    for d in ("examples", "tools"):
        for f in sorted(os.listdir(os.path.join(REPO, d))):
            if f.startswith("torch_") and f.endswith(".py"):
                yield os.path.join(REPO, d, f)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(set(_port_sources())),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "mxnet_tpu"}, roots


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None; "
            "import mxnet_tpu_torch, mxnet_tpu_torch.models.bert, "
            "mxnet_tpu_torch.models.gpt, mxnet_tpu_torch.serve.decoder, "
            "mxnet_tpu_torch.checkpoint, "
            "mxnet_tpu_torch.serve, mxnet_tpu_torch.ops.cuda._build, "
            "mxnet_tpu_torch.cache.snapshot, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.ir.tune, "
            "mxnet_tpu_torch.ir, mxnet_tpu_torch.ir.graph, "
            "mxnet_tpu_torch.ir.passes, mxnet_tpu_torch.ir.lower, "
            "mxnet_tpu_torch.cache, mxnet_tpu_torch.cache.store, "
            "mxnet_tpu_torch.cache.aot, mxnet_tpu_torch.runtime, "
            "mxnet_tpu_torch.libinfo, mxnet_tpu_torch.kvstore_server, "
            "mxnet_tpu_torch.parallel.data_parallel, "
            "mxnet_tpu_torch.gluon.nn.conv_layers, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.gluon.model_zoo.convert, "
            "mxnet_tpu_torch.quantization, mxnet_tpu_torch.ops.lowbit, "
            "mxnet_tpu_torch.context, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.nd, mxnet_tpu_torch.nd.random, "
            "mxnet_tpu_torch.nd.contrib, mxnet_tpu_torch.linalg, "
            "mxnet_tpu_torch.test_utils, mxnet_tpu_torch.ops.extra, "
            "mxnet_tpu_torch.ops.legacy_ops, mxnet_tpu_torch.ops.rnn, "
            "mxnet_tpu_torch.ops.detection, mxnet_tpu_torch.gluon.rnn, "
            "mxnet_tpu_torch.models.lstm_lm, mxnet_tpu_torch.models.ssd, "
            "mxnet_tpu_torch.models.transformer, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.dist, mxnet_tpu_torch.dist.hierarchical, "
            "mxnet_tpu_torch.dist.bucketer, mxnet_tpu_torch.dist.zero, "
            "mxnet_tpu_torch.dist.elastic, mxnet_tpu_torch.parallel, "
            "mxnet_tpu_torch.parallel.mesh, "
            "mxnet_tpu_torch.parallel.distributed, "
            "mxnet_tpu_torch.parallel.resilience, "
            "mxnet_tpu_torch.parallel.tensor_parallel, "
            "mxnet_tpu_torch.parallel.ring_attention, "
            "mxnet_tpu_torch.parallel.ulysses, "
            "mxnet_tpu_torch.parallel.pipeline, "
            "mxnet_tpu_torch.parallel.expert_parallel, "
            "mxnet_tpu_torch.gluon.contrib.nn, mxnet_tpu_torch.init, "
            "mxnet_tpu_torch.sparse, mxnet_tpu_torch.operator, "
            "mxnet_tpu_torch.registry, mxnet_tpu_torch.npx, "
            "mxnet_tpu_torch.numpy_api, mxnet_tpu_torch.contrib, "
            "mxnet_tpu_torch.contrib.text, mxnet_tpu_torch._contrib_ops, "
            "mxnet_tpu_torch.ops.contrib_extra, mxnet_tpu_torch.ops.ctc, "
            "mxnet_tpu_torch.gluon.contrib.rnn, "
            "mxnet_tpu_torch.gluon.contrib.estimator, "
            "mxnet_tpu_torch.gluon.model_zoo.model_store, "
            "mxnet_tpu_torch.capture, mxnet_tpu_torch.gluon.hybrid, "
            "mxnet_tpu_torch.serve.step_graph, mxnet_tpu_torch.engine, "
            "mxnet_tpu_torch.name, mxnet_tpu_torch.attribute, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.sym, "
            "mxnet_tpu_torch.sym_contrib, mxnet_tpu_torch.shape_inference, "
            "mxnet_tpu_torch.executor, mxnet_tpu_torch.visualization, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.callback, "
            "mxnet_tpu_torch.monitor, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.ops.control_flow, mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch.gluon.utils, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.image_det, mxnet_tpu_torch.gluon.data.vision, "
            "mxnet_tpu_torch.gluon.data.vision.datasets, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.observability, "
            "mxnet_tpu_torch.observability.registry, "
            "mxnet_tpu_torch.observability.tracing, "
            "mxnet_tpu_torch.observability.http, "
            "mxnet_tpu_torch.observability.watchdog, "
            "mxnet_tpu_torch.observability.costs, "
            "mxnet_tpu_torch.analysis, mxnet_tpu_torch.analysis.graphlint, "
            "mxnet_tpu_torch.analysis.validate, "
            "mxnet_tpu_torch.analysis.concurrency, "
            "mxnet_tpu_torch.analysis.hlolint, "
            "mxnet_tpu_torch.serve.fleet, mxnet_tpu_torch.serve.worker, "
            "mxnet_tpu_torch.profiler, mxnet_tpu_torch.onnx, "
            "mxnet_tpu_torch.onnx.proto, mxnet_tpu_torch.onnx.export, "
            "mxnet_tpu_torch.onnx.import_model; "
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr


def test_without_cuda_entry_points_raise(monkeypatch):
    from mxnet_tpu_torch.base import DeviceError, resolve_device
    from mxnet_tpu_torch.models.bert import BERTModel
    from mxnet_tpu_torch.models.gpt import GPTModel
    from mxnet_tpu_torch.serve import GenerativeServer, ModelServer
    from torch_port_helpers import SMALL_BERT, SMALL_GPT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        resolve_device()
    with pytest.raises(DeviceError):
        resolve_device("cuda")
    model = BERTModel(**SMALL_BERT)
    with pytest.raises(DeviceError):
        model.initialize()
    model.initialize(device="cpu")
    with pytest.raises(DeviceError):
        ModelServer(model, [((8,), "int32")] * 2 + [((), "int32")],
                    buckets=(1,))
    gpt = GPTModel(**dict(SMALL_GPT, num_layers=1))
    gpt.initialize(device="cpu")
    with pytest.raises(DeviceError):
        GenerativeServer(gpt)
    with pytest.raises(DeviceError):
        gpt.generate([[1, 2]], max_new_tokens=1)
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet18_v1(classes=4)
    with pytest.raises(DeviceError):
        net.initialize()
    net.initialize(device="cpu")
    with pytest.raises(DeviceError):
        ModelServer(net, [((3, 32, 32), "float32")], buckets=(1,))
    from mxnet_tpu_torch.models.lstm_lm import RNNModel
    from mxnet_tpu_torch.models.ssd import SSD
    from mxnet_tpu_torch.models.transformer import TransformerModel

    lm = RNNModel(vocab_size=20, num_embed=8, num_hidden=8, num_layers=1)
    with pytest.raises(DeviceError):
        lm.initialize()
    ssd = SSD(num_classes=2, sizes=((0.2, 0.3),), ratios=((1, 2),))
    with pytest.raises(DeviceError):
        ssd.initialize()
    ssd.initialize(device="cpu")
    with pytest.raises(DeviceError):
        ssd.detect(torch.zeros(1, 3, 32, 32))
    nmt = TransformerModel(src_vocab=20, tgt_vocab=20, units=8, hidden=16,
                           num_layers=1, num_heads=2, max_len=8)
    with pytest.raises(DeviceError):
        nmt.initialize()
    nmt.initialize(device="cpu")
    for kw in ({}, {"use_cache": False}, {"beam": 2}):
        with pytest.raises(DeviceError):
            nmt.translate(torch.ones(1, 3, dtype=torch.int32), max_len=3,
                          **kw)
    from mxnet_tpu_torch import nd

    for make in (lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nd.random.normal(shape=(2,)),
                 lambda: nd.random_uniform(shape=(2,))):
        with pytest.raises(DeviceError):
            make()
    import numpy as np
    from mxnet_tpu_torch import io, module, rnn, sym
    from mxnet_tpu_torch.gluon import data as gdata

    x = np.ones((4, 2), np.float32)
    for run in (lambda: next(iter(io.NDArrayIter(x, batch_size=2))),
                lambda: module.Module(sym.var("data")),
                lambda: next(iter(gdata.DataLoader(gdata.ArrayDataset(x),
                                                   batch_size=2))),
                lambda: next(iter(rnn.BucketSentenceIter([[1, 2]] * 2, 2)))):
        with pytest.raises(DeviceError):
            run()
    from mxnet_tpu_torch.gluon.model_zoo import convert
    from mxnet_tpu_torch.parallel import distributed

    with pytest.raises(DeviceError):
        distributed.init_process_group()
    assert not distributed.is_initialized()
    with pytest.raises(DeviceError):  # a converted value with no ctx
        convert.apply_converted(vision.resnet18_v1(classes=4), {
            "output.bias": torch.zeros(4).numpy()}, strict=False)
    with pytest.raises(DeviceError):
        ModelServer(net, [((3, 32, 32), "float32")], buckets=(1,),
                    devices=["cpu", "cuda:0"])


def test_model_parallel_on_cuda_tensors_raises_without_a_card(monkeypatch):
    """A rank of a gloo group of CPU ranks (no card) given CUDA tensors:
    ``ring_attention``, ``moe_ffn`` and ``sequence_parallel_scope`` refuse
    them before any collective, and a ring step on the card's tensors
    (``ring_replay``, what the ring runs a rank's blocks through) reaches
    the flash kernel's build, which raises without CUDA: no step falls
    back to the plain versions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mxnet_tpu_torch.base import DeviceError
    from mxnet_tpu_torch.ops import F
    from mxnet_tpu_torch.parallel import (distributed, moe_ffn,
                                          ring_attention,
                                          sequence_parallel_scope)
    from mxnet_tpu_torch.parallel.ring_attention import ring_replay

    class Mesh:
        shape = {"sp": 1, "ep": 1}

        def group(self, axis):
            return None

        def local_rank(self, axis):
            return 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed, "_device", torch.device("cpu"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16, device="cuda")
        x = torch.zeros(8, 16, device="cuda")
        with pytest.raises(DeviceError):
            ring_attention(q, q, q, Mesh(), causal=True)
        with pytest.raises(DeviceError):
            moe_ffn(x, torch.zeros(16, 4, device="cuda"),
                    torch.zeros(4, 16, 8, device="cuda"),
                    torch.zeros(4, 8, 16, device="cuda"), Mesh())
        with sequence_parallel_scope(Mesh()):
            with pytest.raises(DeviceError):
                F.scaled_dot_attention(q, q, q, causal=True)
        for causal in (False, True):
            with pytest.raises(DeviceError, match="CUDA device"):
                ring_replay(q, q, q, 1, causal=causal)


def test_split_and_hybridized_paths_on_cuda_tensors_raise_without_a_card(
        monkeypatch):
    """Without a card, CUDA tensors: the vocabulary-parallel loss (the
    split head's loss inside a tp_scope) reaches the softmax-xent
    kernel's build, which raises, and a hybridized block refuses the
    call; neither falls back to the plain versions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mxnet_tpu_torch.base import DeviceError
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    net = nn.Dense(4, in_units=8)
    net.initialize(device="cpu")
    net.hybridize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(4, 8, device="cuda")
        labels = torch.zeros(4, dtype=torch.int32, device="cuda")
        with tp.tp_scope.replay(2, []) as scope:
            with pytest.raises(DeviceError, match="CUDA"):
                tp.vocab_parallel_xent([x, x], labels, [0, 8],
                                       merge=scope.xent_merge)
        with pytest.raises(DeviceError, match="CUDA"):
            net(x)


def test_without_cuda_symbolic_entry_points_raise(monkeypatch, tmp_path):
    """``simple_bind``, ``SymbolBlock.imports`` and ``serve.load`` run on
    the card unless the caller asks for the CPU."""
    from mxnet_tpu_torch import serve, sym
    from mxnet_tpu_torch.base import DeviceError
    from mxnet_tpu_torch.gluon import nn

    net = nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    net.export(str(tmp_path / "d"), input_shapes=[(2, 4)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        sym.FullyConnected(sym.var("x"), num_hidden=3).simple_bind(x=(2, 4))
    with pytest.raises(DeviceError):
        serve.load(str(tmp_path / "d"))
    assert serve.load(str(tmp_path / "d"), ctx="cpu") is not None


def test_spawned_worker_imports_no_jax():
    """A fleet worker process, JAX and the JAX package blocked in it, comes
    up from the factory twin, serves and shuts down: nothing it imports
    reaches either."""
    import json

    from mxnet_tpu_torch.serve import WorkerHandle

    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['mxnet_tpu'] = None; "
            "sys.argv = ['worker', '--factory', %r]; "
            "runpy.run_module('mxnet_tpu_torch.serve.worker', "
            "run_name='__main__')" % (os.path.join(
                REPO, "tools", "torch_fleet_factory.py")
                + ":model_server_cpu"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("{"), proc.stderr.read()[-2000:]
        ready = json.loads(line)
        h = WorkerHandle("127.0.0.1", ready["port"], proc=proc)
        y = h.predict([torch.zeros(16).numpy()])
        assert tuple(y.shape) == (10,)
        h.shutdown()
        assert proc.wait(timeout=35) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
