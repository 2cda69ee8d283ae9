from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _b
from .conv_layers import __all__ as _c
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401

__all__ = list(_b) + list(_c) + ["Block", "HybridBlock", "SymbolBlock"]
