"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib/__init__.py``; ref:
python/mxnet/contrib/__init__.py): the contrib ops (``ndarray``,
``symbol``, generated from ``_contrib_ops``), ``quantization`` and
``onnx`` (modules of their own), and ``text`` (vocabulary and embedding
utilities)."""
from ..nd import contrib as ndarray  # noqa: F401  (mx.contrib.ndarray ops)
from .. import sym_contrib as symbol  # noqa: F401
from .. import quantization  # noqa: F401
from .. import onnx  # noqa: F401
from . import text  # noqa: F401
