"""Alias module: ``mx.init`` is ``mx.initializer`` (ref:
python/mxnet/initializer.py)."""
from .initializer import *  # noqa: F401,F403
from .initializer import create  # noqa: F401
