"""Checkpoints (counterpart of ``mxnet_tpu/checkpoint.py``): a model's
parameters, a trainer's state and a step counter in one call, arrays in the
shared npz format, the serving layout (``save_for_serving``, the export's
``-symbol.json`` and ``-NNNN.params``, and ``load_for_serving``), and the
structural gate of a weight hot-swap.

Every file is in the JAX package's format (``util.save_npz_exact`` for
arrays and parameters, the Trainer's pickle for its state), so a checkpoint
either package writes loads in the other.

``save_sharded``/``restore_sharded``/``latest_step`` are the resumable
loops' checkpoints: ``<dir>/step_%08d.pkl``, written to a temporary name
and renamed, holding the pickle the JAX package writes when it has no
orbax (``{"arrays": [numpy leaves in jax.tree_util order], "treedef":
str}``), so a file crosses both ways. An orbax checkpoint directory
raises, naming it: the port has no orbax.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import re

import numpy as np
import torch

from .util import load_npz_exact, save_npz_exact, to_tensor

__all__ = ["save_checkpoint", "load_checkpoint", "save_arrays",
           "load_arrays", "SwapError", "validate_swap", "save_sharded",
           "restore_sharded", "latest_step", "save_for_serving",
           "load_for_serving"]


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


def save_for_serving(prefix, block, epoch=0, input_names=("data",),
                     input_shapes=None):
    """The serving layout of ``block``: ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` (``HybridBlock.export``), dtype-exact, so a
    reload serves with the same parameter dtypes and captures the same
    bucket graphs. ``input_shapes`` (one per input, batch included) is
    needed by a model whose trace reads shapes (BERT, GPT), and bakes that
    batch into the graph (``ROADMAP.md`` C.2). Returns (symbol file,
    params file)."""
    return block.export(prefix, epoch=epoch, input_names=input_names,
                        input_shapes=input_shapes)


def load_for_serving(prefix, epoch=0, input_names=("data",), ctx=None):
    """The exported block as a ``SymbolBlock`` whose parameters carry the
    file's dtypes and shapes, on ``ctx`` (default: the current CUDA
    device)."""
    from .gluon.block import SymbolBlock

    return SymbolBlock.imports("%s-symbol.json" % prefix, list(input_names),
                               "%s-%04d.params" % (prefix, epoch), ctx=ctx)


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


def _flatten(tree):
    """(leaves in ``jax.tree_util`` order, the structure's string in the
    form of a JAX ``PyTreeDef``)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for ls, _ in parts for x in ls],
                "{%s}" % ", ".join("%r: %s" % (k, d)
                                   for k, (_, d) in zip(keys, parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        inner = ", ".join(d for _, d in parts)
        if isinstance(tree, tuple):
            inner = "(%s%s)" % (inner, "," if len(tree) == 1 else "")
        else:
            inner = "[%s]" % inner
        return [x for ls, _ in parts for x in ls], inner
    if tree is None:
        return [], "None"
    return [tree], "*"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        if node is None:
            return None
        return next(it)

    return build(like)


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:  # numpy has no bf16: fp32 is exact
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def save_sharded(directory, pytree, step=0):
    """Write ``pytree`` (nested dicts, lists and tuples of tensors, arrays
    or scalars) as ``step_%08d.pkl``: to a temporary name, then renamed,
    so a crash mid-save never leaves a truncated latest checkpoint.
    bf16 tensors are written as fp32 (exact; the reader casts back).
    Returns False (the JAX package's return for its pickle branch)."""
    os.makedirs(directory, exist_ok=True)
    leaves, treedef = _flatten(pytree)
    final = os.path.join(directory, "step_%08d.pkl" % step)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump({"arrays": [_to_numpy(a) for a in leaves],
                     "treedef": "PyTreeDef(%s)" % treedef}, f)
    os.replace(tmp, final)
    return False


def _from_file(a, like):
    if isinstance(like, torch.Tensor):
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # ml_dtypes bf16
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray) or isinstance(like, np.generic):
        return np.asarray(a, dtype=like.dtype)
    return type(like)(np.asarray(a).item()) if np.ndim(a) == 0 else a


def restore_sharded(directory, step, like):
    """Read a ``save_sharded`` checkpoint (either package's) onto the
    structure of ``like``, each leaf with its template's dtype and device.
    An orbax directory raises."""
    from .gluon.trainer import _StateUnpickler

    pkl = os.path.join(directory, "step_%08d.pkl" % step)
    if not os.path.exists(pkl):
        orbax_dir = os.path.join(directory, "step_%08d" % step)
        if os.path.isdir(orbax_dir):
            raise NotImplementedError(
                "%s is an orbax checkpoint; the port reads the pickle form "
                "only (orbax is not available to it): write it with the "
                "JAX package's save_sharded where orbax is not installed"
                % orbax_dir)
        raise FileNotFoundError("no checkpoint of step %d in %s"
                                % (step, directory))
    with open(pkl, "rb") as f:
        blob = _StateUnpickler(io.BytesIO(f.read())).load()
    flat = blob["arrays"]
    flat_like, _ = _flatten(like)
    if len(flat) != len(flat_like):
        raise ValueError("checkpoint has %d leaves, template has %d"
                         % (len(flat), len(flat_like)))
    return _unflatten(like, [_from_file(a, l)
                             for a, l in zip(flat, flat_like)])


_STEP_RE = re.compile(r"^step_(\d{8,})(\.pkl)?$")


def latest_step(directory):
    """The largest completed step in ``directory``: exact ``step_%08d.pkl``
    files or ``step_%08d`` (orbax) directories; ``.tmp`` files are saves in
    flight."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_RE.match,
                                          os.listdir(directory)) if m]
    return max(steps) if steps else None


def save_serving_snapshot(server, prefix, input_names=None, epoch=0):
    """The serving artifact of a live, warmed server (``serve.snapshot``):
    this checkpoint layout plus the server's config and program list."""
    from .cache.snapshot import save_snapshot

    return save_snapshot(server, prefix, input_names=input_names,
                         epoch=epoch)


def load_serving_snapshot(prefix, model=None, **server_kwargs):
    """A ready server from ``save_serving_snapshot``'s artifact, every
    program it lists captured before the first request
    (``serve.load(prefix, snapshot=True)``)."""
    from .cache.snapshot import load_snapshot

    return load_snapshot(prefix, model=model, **server_kwargs)
