"""Models of the port."""
from . import bert  # noqa: F401
