"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. This slice
serves BERT: Gluon blocks and layers over torch tensors, the BERT model,
the attention seam, the bucketed dynamic-batching ModelServer, and
hand-written CUDA kernels (sm_90a) for the LayerNorm and the
flash-attention forward. Entry points run on the current CUDA device unless
the caller passes ``device="cpu"``. The package imports neither JAX nor
anything of ``mxnet_tpu``.
"""
from . import base, context, util  # noqa: F401
from .context import cpu, gpu, num_gpus  # noqa: F401
from . import ops, initializer, gluon, amp, convert, models, serve  # noqa: F401
