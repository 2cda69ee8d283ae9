"""Tensor parallelism: sharding rules, the Megatron f/g regions and
activation constraints (counterpart of
``mxnet_tpu/parallel/tensor_parallel.py``).

The JAX package names a placement per parameter and lets XLA's
partitioner insert the collectives. Here each rank is a process: a
sharded parameter is this rank's block (:func:`shard_params`), the
``build_train_step(param_spec=)`` step gathers it for the forward and
reduce-scatters its gradient, and a model that splits its own math over
``tp`` closes each region with :func:`psum_region_entry` and
:func:`psum_region_exit` (Megatron-LM's ``f`` and ``g``), explicit
``torch.autograd.Function``s over the axis's process group.
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist

from .mesh import P, current_mesh, shard_array, spec_axes

__all__ = ["psum_region_exit", "psum_region_entry", "TRANSFORMER_RULES",
           "FSDP_RULES", "spec_for", "shard_params", "param_specs",
           "constrain"]


def _axis_group(axis_name, mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("%r names a mesh axis, but no mesh is given or "
                         "entered (parallel.use_mesh)" % (axis_name,))
    return mesh.group(axis_name), int(mesh.shape[axis_name])


def _all_reduce(x, group, n):
    x = x.contiguous().clone()
    if n > 1:
        dist.all_reduce(x, group=group)
    return x


class _RegionExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RegionEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.n), None, None


def psum_region_exit(x, axis_name, mesh=None):
    """Megatron row-parallel exit: the sum over ``axis_name`` forward,
    the identity backward (the ``g`` operator of Megatron-LM fig. 3).

    Every rank of the axis then computes the same (replicated) loss, so
    each keeps its own cotangent copy: an all-reduce backward would
    multiply the gradients upstream by the axis size (and
    ``torch.distributed.nn``'s all-reduce does exactly that). ``mesh``
    defaults to the entered one (``use_mesh``)."""
    group, n = _axis_group(axis_name, mesh)
    return _RegionExit.apply(x, group, n)


def psum_region_entry(x, axis_name, mesh=None):
    """Megatron column-parallel entry: the identity forward, the sum over
    ``axis_name`` backward (the ``f`` operator). The region's input is
    replicated over the axis and each rank's math gives only a partial
    input cotangent, so the true one is their sum."""
    group, n = _axis_group(axis_name, mesh)
    return _RegionEntry.apply(x, group, n)


# BERT/Transformer sharding rules: parameter-name regex -> PartitionSpec.
# Dense weights are (out, in), as in MXNet FullyConnected.
TRANSFORMER_RULES = [
    (r".*(query|key|value|qkv).*weight", P("tp", None)),   # column parallel
    (r".*attn_out.*weight", P(None, "tp")),                # row parallel
    (r".*(query|key|value|qkv).*bias", P("tp")),
    (r".*ffn_1.*weight", P("tp", None)),                   # up-proj column
    (r".*ffn_2.*weight", P(None, "tp")),                   # down-proj row
    (r".*ffn_1.*bias", P("tp")),
    (r".*word_embed.*weight", P("tp", None)),              # vocab sharded
    (r".*embed.*weight", P()),
    (r".*", P()),                                          # default: whole
]

FSDP_RULES = [
    (r".*", "fsdp_largest"),  # the largest dim the 'fsdp' axis divides
]


def spec_for(name, shape, rules, mesh):
    """The spec of the first rule whose pattern matches ``name``; whole
    when that spec does not fit ``shape`` on ``mesh``."""
    for pattern, spec in rules:
        if re.match(pattern, name):
            if spec == "fsdp_largest":
                return _fsdp_spec(shape, mesh)
            if _fits(spec, shape, mesh):
                return spec
            return P()
    return P()


def _fits(spec, shape, mesh):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % mesh.shape[axis] != 0:
            return False
    return True


def _fsdp_spec(shape, mesh):
    n = mesh.shape.get("fsdp", 1)
    if n <= 1:
        return P()
    for dim, s in sorted(enumerate(shape), key=lambda t: -t[1]):
        if s % n == 0:
            spec = [None] * len(shape)
            spec[dim] = "fsdp"
            return P(*spec)
    return P()


def shard_params(named_arrays, mesh, rules=TRANSFORMER_RULES):
    """``[(name, tensor)]`` (the whole values, alike on every rank) -> this
    rank's block of each under its rule's spec. A block carries its whole
    shape as ``_full_shape``."""
    out = []
    for name, a in named_arrays:
        spec = spec_for(name, tuple(a.shape), rules, mesh)
        blk = shard_array(a, mesh, *spec).clone()
        blk._full_shape = tuple(a.shape)
        out.append(blk)
    return out


def param_specs(named_shapes, mesh, rules=TRANSFORMER_RULES):
    return [spec_for(name, tuple(shape), rules, mesh)
            for name, shape in named_shapes]


def constrain(x, *spec):
    """``with_sharding_constraint`` for activations: each rank holds the
    whole value here, so ``x`` comes back as it is; the spec is checked
    against the entered mesh (its axes exist and divide ``x``'s
    dimensions). Without a mesh, nothing is checked."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(spec) > x.dim():
        raise ValueError("constrain: spec %r has more entries than x has "
                         "dimensions %s" % (P(*spec), tuple(x.shape)))
    for d, entry in enumerate(spec):
        n = 1
        for a in spec_axes(entry):
            if a not in mesh.shape:
                raise ValueError("constrain: %r is not an axis of %r"
                                 % (a, mesh))
            n *= int(mesh.shape[a])
        if x.shape[d] % n:
            raise ValueError("constrain: dimension %d of %s does not split "
                             "%d ways" % (d, tuple(x.shape), n))
    return x
