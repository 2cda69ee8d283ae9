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
        _set(p, params[theirs[local]])
    return block


def _set(p, arr):
    """``p`` holds ``arr``'s values and dtype, on ``p``'s device."""
    value = to_tensor(arr)
    if p._shape_known() and tuple(value.shape) != p.shape:
        raise ValueError("parameter %r: shape %s, expected %s"
                         % (p.name, tuple(value.shape), tuple(p.shape)))
    device = p.device
    p.dtype = value.dtype
    p._data = None
    p.set_data(value if device is None else value.to(device))


def _below_root(name):
    """A parameter's name below its outermost auto-named block
    (``bertmodel3_word_embed_weight`` -> ``word_embed_weight``)."""
    m = re.match(r"[a-z_]*?\d+_", name)
    return name[m.end():] if m else name


def carry_params(block, params):
    """Set ``block``'s parameters from ``params`` ({name: array} in the
    JAX model's ``collect_params()`` order), one for one in order: for a
    model whose parameters sit under more than one root block (a
    ``BERTClassifier`` over a trunk built outside its scope, a
    ``HybridSequential`` made without a prefix), which
    :func:`from_jax_params` refuses. Each pair must hold the same name
    below its root and the same shape, or it raises. Returns the block."""
    mine = list(block.collect_params().values())
    theirs = list(params.items())
    if len(mine) != len(theirs):
        raise KeyError("%d parameters, %d given" % (len(mine), len(theirs)))
    for p, (name, arr) in zip(mine, theirs):
        if _below_root(p.name) != _below_root(name):
            raise KeyError("parameter %r paired with %r" % (p.name, name))
        _set(p, arr)
    return block
