"""Models of the port."""
from . import bert, gpt, lstm_lm, ssd, transformer  # noqa: F401
from .gpt import GPTModel, gpt2_small, gpt_nano  # noqa: F401
from .lstm_lm import RNNModel, lstm_ptb  # noqa: F401
from .ssd import SSD, SSDLoss, ssd_512  # noqa: F401
from .transformer import TransformerModel, transformer_base  # noqa: F401
