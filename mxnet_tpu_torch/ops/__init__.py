"""Functional ops of the port; ``F`` is what ``hybrid_forward`` receives."""
from . import functional as F  # noqa: F401
from . import attention  # noqa: F401
