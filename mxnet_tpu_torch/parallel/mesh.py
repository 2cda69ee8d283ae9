"""Named meshes of ranks (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX package lays one program over a mesh of devices; here every rank
runs its own program, so a mesh is a grid of ranks with a
``torch.distributed`` group along each named axis
(``torch.distributed.device_mesh``). Axis convention as in the JAX
package: ``dp`` data parallel (outermost), ``dcn`` the slow hop between
hosts, ``fsdp``, ``tp``, ``sp``, ``pp``, ``ep``.

A rank's coordinates follow the row-major order of ``devices``: in
``make_mesh({"dcn": 2, "dp": 2})`` ranks 0 and 1 form one ``dp`` group, 0
and 2 one ``dcn`` group. Building a mesh is a collective: every rank of
the group calls ``make_mesh`` with the same arguments, also the ranks
left out of ``devices`` (their ``is_member`` is False).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "use_mesh", "current_mesh", "P",
           "PartitionSpec", "NamedSharding", "named_sharding", "replicated",
           "shard_array", "spec_axes", "AXES"]

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")


class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is split over (None: whole)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class NamedSharding(tuple):
    """A placement: ``(mesh, spec)``, what :func:`shard_array` and
    ``tensor_parallel.shard_params`` read (the JAX package's
    ``NamedSharding``)."""

    def __new__(cls, mesh, spec):
        return super().__new__(cls, (mesh, P(*spec)))

    @property
    def mesh(self):
        return self[0]

    @property
    def spec(self):
        return self[1]

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def named_sharding(mesh, *spec):
    return NamedSharding(mesh, spec)


def replicated(mesh):
    return NamedSharding(mesh, ())


def spec_axes(entry):
    """The mesh axes one entry of a spec names: () for None, a tuple's
    axes (the first outermost), or the one axis."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Mesh:
    """A grid of ranks with named axes. ``shape`` maps each axis to its
    size (the JAX mesh's ``shape``), ``devices`` is the grid of ranks,
    ``group(axis)`` this rank's process group along ``axis`` and
    ``local_rank(axis)`` its index in it."""

    def __init__(self, axes, ranks, device_mesh):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.devices = np.array(ranks).reshape(tuple(axes.values()))
        self.device_mesh = device_mesh
        self.coordinate = device_mesh.get_coordinate()

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def is_member(self):
        return self.coordinate is not None

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis):
        return int(self.coordinate[self.axis_names.index(axis)])

    def __repr__(self):
        return "Mesh(%s, ranks=%s)" % (self.shape, self.devices.ravel()
                                       .tolist())


def _device_type():
    from . import distributed

    dev = distributed.device()
    return "cpu" if dev is None else dev.type


def make_mesh(axes=None, devices=None):
    """``axes``: axis name -> size (one may be -1, inferred), e.g.
    ``{"dcn": 2, "dp": 2}``; the sizes multiply to the number of
    ``devices`` (ranks; default: every rank of the group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = dist.get_world_size()
    everyone = devices is None
    ranks = list(range(world)) if everyone else [int(r) for r in devices]
    n = len(ranks)
    axes = dict(axes or {"dp": n})
    known, infer = 1, None
    for k, v in axes.items():
        if v == -1:
            infer = k
        else:
            known *= v
    if infer is not None:
        axes[infer] = n // known
    if math.prod(axes.values()) != n:
        raise ValueError("mesh %s needs %d ranks, have %d"
                         % (axes, math.prod(axes.values()), n))
    names, sizes = tuple(axes), tuple(axes.values())
    if ranks == list(range(world)):
        dm = init_device_mesh(_device_type(), sizes, mesh_dim_names=names)
    else:
        dm = DeviceMesh(_device_type(),
                        torch.tensor(ranks, dtype=torch.int64).reshape(sizes),
                        mesh_dim_names=names)
    return Mesh(axes, ranks, dm)


_current_mesh = []


@contextmanager
def use_mesh(mesh):
    _current_mesh.append(mesh)
    try:
        yield mesh
    finally:
        _current_mesh.pop()


def current_mesh():
    return _current_mesh[-1] if _current_mesh else None


def shard_array(x, mesh, *spec):
    """This rank's block of ``x`` (the whole value, on every rank) under
    ``spec``: a dimension named by an axis (or a tuple of axes, the first
    outermost) is cut into that many equal blocks. ``mesh`` may be a
    :class:`NamedSharding` (then no ``spec`` follows)."""
    if isinstance(mesh, NamedSharding):
        mesh, spec = mesh.mesh, tuple(mesh.spec)
    for d, axis in enumerate(spec):
        names = spec_axes(axis)
        if not names:
            continue
        n, idx = 1, 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.local_rank(a)
            n *= mesh.shape[a]
        if x.shape[d] % n:
            raise ValueError("dimension %d of %s does not split %d ways"
                             % (d, tuple(x.shape), n))
        s = x.shape[d] // n
        x = x.narrow(d, idx * s, s)
    return x
