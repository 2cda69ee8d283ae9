"""Carry weights from the JAX package into a port block.

``from_jax_params(block, {name: array})`` takes the JAX model's parameters
by name (``{p.name: np.asarray(p.data()._data)}`` there, or the dict
``util.load_npz_exact`` reads from a checkpoint it saved) and sets the port
block's parameters from them. Names are matched after stripping each
model's own root prefix, because the auto-name counter of the root
(``bertmodel0_`` in one process, ``bertmodel3_`` in another) differs
between processes; everything under the root must match exactly. A
missing, extra or reshaped name raises, and each array keeps its dtype.
Every parameter crosses this way, the ones without a gradient too: the
BatchNorm running statistics, a recurrent layer's weights per (layer,
direction), and a ``gluon.Constant`` such as the Transformer's
``pos_enc``.
"""
from __future__ import annotations

import re

from .util import to_tensor


def _root_pattern(prefix):
    """Regex for a root prefix like this block's, with any counter."""
    m = re.fullmatch(r"(.*?)\d+_", prefix)
    return re.escape(m.group(1)) + r"\d+_" if m else re.escape(prefix)


def strip_root(names, prefix):
    """{local name: full name} for ``names`` under a root prefix shaped
    like ``prefix``; raises if a name is not under such a root."""
    pat = re.compile(_root_pattern(prefix))
    out = {}
    for name in names:
        m = pat.match(name)
        if m is None:
            raise KeyError("parameter %r is not under a root prefix like %r"
                           % (name, prefix))
        out[name[m.end():]] = name
    return out


def from_jax_params(block, params):
    """Set ``block``'s parameters from ``params`` ({name: numpy array or
    tensor}); see the module docstring. Returns the block."""
    mine = {p.name[len(block.prefix):]: p
            for p in block.collect_params().values()}
    theirs = strip_root(params, block.prefix)
    missing = sorted(set(mine) - set(theirs))
    extra = sorted(set(theirs) - set(mine))
    if missing or extra:
        raise KeyError("parameter names differ: missing %s, extra %s"
                       % (missing, extra))
    for local, p in mine.items():
        value = to_tensor(params[theirs[local]])
        if p._shape_known() and tuple(value.shape) != p.shape:
            raise ValueError("parameter %r: shape %s, expected %s"
                             % (p.name, tuple(value.shape), tuple(p.shape)))
        device = p.device
        p.dtype = value.dtype
        p._data = None
        p.set_data(value if device is None else value.to(device))
    return block
