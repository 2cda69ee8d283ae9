"""Checkpoints (counterpart of ``mxnet_tpu/checkpoint.py``): a model's
parameters, a trainer's state and a step counter in one call, arrays in the
shared npz format, and the structural gate of a weight hot-swap.

Every file is in the JAX package's format (``util.save_npz_exact`` for
arrays and parameters, the Trainer's pickle for its state), so a checkpoint
either package writes loads in the other.
"""
from __future__ import annotations

import json
import os

from .util import load_npz_exact, save_npz_exact, to_tensor

__all__ = ["save_checkpoint", "load_checkpoint", "save_arrays",
           "load_arrays", "SwapError", "validate_swap"]


def save_checkpoint(prefix, epoch, block=None, trainer=None, extra=None):
    """``<prefix>-<epoch>.params`` (the block's parameters),
    ``.states`` (the trainer's) and ``.meta`` (epoch and ``extra``, JSON)."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".",
                exist_ok=True)
    if block is not None:
        block.save_parameters("%s-%04d.params" % (prefix, epoch))
    if trainer is not None:
        trainer.save_states("%s-%04d.states" % (prefix, epoch))
    with open("%s-%04d.meta" % (prefix, epoch), "w") as f:
        json.dump({"epoch": epoch, "extra": extra or {}}, f)


def load_checkpoint(prefix, epoch, block=None, trainer=None):
    """Restore what :func:`save_checkpoint` wrote; returns the meta dict."""
    if block is not None:
        block.load_parameters("%s-%04d.params" % (prefix, epoch))
    states = "%s-%04d.states" % (prefix, epoch)
    if trainer is not None and os.path.exists(states):
        trainer.load_states(states)
    meta_path = "%s-%04d.meta" % (prefix, epoch)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {"epoch": epoch, "extra": {}}


def save_arrays(path, arrays):
    """dict[str, tensor or numpy array] -> npz, dtype-exact (bf16 stays
    bf16)."""
    save_npz_exact(path, {k: to_tensor(v) for k, v in arrays.items()})


def load_arrays(path):
    """The dict :func:`save_arrays` wrote, as CPU tensors."""
    return load_npz_exact(path)


class SwapError(RuntimeError):
    """A pushed checkpoint does not match the live model's structure: the
    weight hot-swap is refused and the old weights keep serving."""


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def validate_swap(block, params_file):
    """The structural gate of a weight hot-swap: the file must carry exactly
    the live model's parameters, under their structural names (any alias of
    a shared parameter, as ``save_parameters(deduplicate=True)`` writes),
    with the same shapes and dtypes. Anything else (missing, extra,
    reshaped, another dtype) raises :class:`SwapError` listing every
    problem, and the caller keeps serving the old weights.

    Returns ``{structural name: CPU tensor}`` for the flip."""
    params = block._collect_params_with_prefix()
    loaded = load_npz_exact(params_file)
    by_id = {}
    for name, p in params.items():
        by_id.setdefault(id(p), []).append(name)
    problems, picked, used = [], {}, set()
    for name, p in params.items():
        key = name if name in loaded else next(
            (a for a in by_id[id(p)] if a in loaded), None)
        if key is None:
            problems.append("missing %r" % name)
            continue
        used.add(key)
        arr = loaded[key]
        live = p._tensor()
        if tuple(arr.shape) != tuple(live.shape):
            problems.append("reshaped %r: file %s vs live %s"
                            % (name, tuple(arr.shape), tuple(live.shape)))
        elif arr.dtype != live.dtype:
            problems.append("dtype %r: file %s vs live %s"
                            % (name, _dtype_name(arr.dtype),
                               _dtype_name(live.dtype)))
        else:
            picked[name] = arr
    for key in sorted(set(loaded) - used):
        problems.append("extra %r" % key)
    if problems:
        raise SwapError(
            "checkpoint %r rejected (%d problem%s): %s — old weights keep "
            "serving" % (params_file, len(problems),
                         "" if len(problems) == 1 else "s",
                         "; ".join(problems[:8])
                         + ("; ..." if len(problems) > 8 else "")))
    return picked
