"""Functional ops of the port; ``F`` is what ``hybrid_forward`` receives."""
import re as _re

from . import functional as F  # noqa: F401
from . import attention  # noqa: F401
from . import extra, legacy_ops  # noqa: F401
from ..base import OP_REGISTRY as _R


def _snake(name):
    s = _re.sub(r"([A-Z]+)([A-Z][a-z])", r"\1_\2", name)
    s = _re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s)
    return s.lower()


# every CamelCase op under its snake_case name too, as upstream's
# ndarray/register.py generates both (and the JAX package aliases them)
for _n in list(_R):
    if _n[:1].isupper():
        _R.setdefault(_snake(_n), _R[_n])
del _n
