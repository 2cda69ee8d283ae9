"""gluon.contrib (ref: python/mxnet/gluon/contrib; counterpart of
``mxnet_tpu/gluon/contrib``): ``nn`` (the contrib blocks), ``rnn`` (the
convolutional, variational-dropout and projected LSTM cells) and
``estimator`` (the fit loop and its event handlers)."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
