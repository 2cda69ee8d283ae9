"""Gluon API of the port (ref: python/mxnet/gluon/__init__.py)."""
from . import parameter, block, nn, rnn, loss, model_zoo, contrib  # noqa: F401
from . import data, utils  # noqa: F401
from .parameter import Parameter, ParameterDict, Constant  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
