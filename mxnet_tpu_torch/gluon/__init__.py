"""Gluon API of the port (ref: python/mxnet/gluon/__init__.py)."""
from . import parameter, block, nn, rnn, loss, model_zoo, contrib  # noqa: F401
from . import data, utils  # noqa: F401
from .parameter import Parameter, ParameterDict, Constant  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401

# the 2.x location of the metrics, as the JAX package keeps it
import sys as _sys  # noqa: E402

from .. import metric  # noqa: F401,E402

_sys.modules[__name__ + ".metric"] = metric  # dotted imports resolve
