"""Models of the port."""
from . import bert, gpt  # noqa: F401
from .gpt import GPTModel, gpt2_small, gpt_nano  # noqa: F401
