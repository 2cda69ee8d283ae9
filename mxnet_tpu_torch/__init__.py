"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It serves
BERT (Gluon blocks and layers over torch tensors, the BERT model, the
attention seam, the bucketed dynamic-batching ModelServer), trains it
(``autograd.record``/``backward``, the softmax cross-entropy loss, Adam and
``gluon.Trainer``), serves GPT generatively (the GPT model, a paged KV
cache and the continuous-batching GenerativeServer), and reads and writes
the JAX package's parameter, trainer-state and checkpoint files
(``checkpoint``), serves quantized (``quant``: int8 and fp8 weights, int8
KV pages), runs the vision layers and model zoo (ResNet-50 trained and
served, int8 convolutions), with hand-written CUDA kernels (sm_90a) for the
LayerNorm, the flash-attention forward and backward, and the softmax
cross-entropy forward and backward. ``mx.nd`` gives MXNet's imperative
idiom over them (``NDArray``, the op namespace generated from the
registry, ``autograd`` with ``attach_grad`` and higher orders), and Gluon
blocks take and return NDArray. It also runs the LSTM PTB language
model over ``gluon.rnn``, SSD-512 with the multibox detection ops, and
the Transformer NMT model with ``translate``, trains data-parallel
(``kvstore``, ``dist``, ``parallel``) and model-parallel (``parallel``:
tensor, ring and Ulysses sequence, pipeline and expert parallelism) over
``torch.distributed``. It has MXNet's symbolic API (``sym``, ``symbol``,
``Executor``, ``HybridBlock.export`` and ``SymbolBlock``, serving from the
export layout) and the engine's bulk window and compiled tape replay
(``engine``, ``autograd.set_tape_compile``), symbol and ``nd`` control
flow and ``autograd.get_symbol``, the Module API (``mod``/``module``,
``model``, ``callback``, ``monitor``, ``metric``, the legacy ``rnn``), and
the host I/O (``io`` iterators, ``recordio``, ``gluon.data`` with the
DataLoader and the device prefetcher, ``gluon.utils``), the image path
(``image``, ``image_det``, the image record iterators, ``pack_img``,
``gluon.data.vision``), and the tooling (``profiler`` over
``torch.profiler``, ``observability`` with the servers' ``/metrics`` and
per-program cost attribution, the replica fleet ``serve.fleet``, and
``analysis``: graphlint, validate, racecheck, the program lint), sparse
storage (``sparse``: CSR and row-sparse arrays, the lazy row update of a
row-sparse gradient, ``io.LibSVMIter``), ``gluon.contrib`` (the contrib
blocks, convolutional cells and the ``Estimator``), the contrib and CTC
ops, ``operator`` (``CustomOp``, ``register_torch_op``), ``registry``,
``np``/``npx`` with the numpy-mode switches, and ``contrib.text``. Entry
points run on the current CUDA device unless the caller passes
``device="cpu"`` (or ``ctx=mx.cpu()``, or enters ``with mx.cpu():``). The package imports
neither JAX nor anything of ``mxnet_tpu``.
"""
from . import base, context, util  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import cpu, cpu_pinned, gpu, num_gpus  # noqa: F401
from . import autograd, random, optimizer, lr_scheduler  # noqa: F401
from . import ops, initializer, gluon, amp, convert, models, serve  # noqa: F401
from . import init  # noqa: F401
from . import checkpoint, quantization, quant  # noqa: F401
from . import ndarray, nd, linalg, test_utils  # noqa: F401
from . import kvstore, dist, parallel  # noqa: F401
from . import engine, name, attribute, symbol, sym, sym_contrib  # noqa: F401
from . import executor, visualization  # noqa: F401
from . import io, recordio, metric, model, module, callback  # noqa: F401
from . import monitor, rnn  # noqa: F401
from . import image, image_det, profiler, observability  # noqa: F401
from . import analysis  # noqa: F401
from . import runtime, libinfo, kvstore_server, cache, ir  # noqa: F401
from . import onnx  # noqa: F401
from . import sparse, operator, registry, npx, contrib  # noqa: F401
from . import numpy_api  # noqa: F401
from . import numpy_api as np  # noqa: F401  (mx.np)
from .util import (use_np, use_np_array, use_np_shape, np_array,  # noqa: F401
                   np_shape)
from . import module as mod  # noqa: F401
from . import visualization as viz  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .context import Context, current_context  # noqa: F401
from .ndarray import NDArray, waitall  # noqa: F401
