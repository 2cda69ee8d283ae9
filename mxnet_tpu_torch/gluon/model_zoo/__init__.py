"""Model zoo (ref: python/mxnet/gluon/model_zoo)."""
from . import vision  # noqa: F401
