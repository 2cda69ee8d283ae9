"""Hierarchical allreduce (counterpart of ``mxnet_tpu/dist/hierarchical.py``;
Goyal-style two-level allreduce, arXiv 1810.11112): reduce-scatter within
the fast ``ici`` group, cross the slow ``dcn`` group with only the
scattered shard, all-gather back.

A flat allreduce moves the whole gradient over both wires; the hierarchy
moves it whole only inside the fast group and 1/ici_size of it across:

    1. reduce-scatter over ``ici_axis``: each rank owns the group's sum of
       one 1/ici_size shard;
    2. the shard, optionally compressed, is summed over ``dcn_axis`` (an
       all-reduce), or through :class:`~mxnet_tpu_torch.kvstore.DistKVStore`
       when ``dcn="kvstore"``;
    3. all-gather over ``ici_axis`` rebuilds the whole reduced vector.

Compression is error feedback: the residual comes in and goes out with
the shard, so what quantization dropped this step is added back next step
(``acc == dequantize(payload) + residual`` exactly).

Each rank passes its own vector (``stacked=True``, the JAX package's
``(W, n)`` input with rank ``r`` holding row ``r``): the result is the sum
over the ranks, or the mean with ``average``. ``stacked=False`` is the JAX
package's replicated mode: every rank holds the same vector and the same
data movement gives it back exactly. Collectives run on the rank's device:
NCCL on CUDA (each launched with ``async_op``, on the exchange's stream),
gloo on the CPU; every one is launched, also over a group of one.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["HierarchicalAllreduce", "FlatAllreduce"]

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _make_codec(compression):
    """compression dict -> (quantize, dequantize) of one fp32 shard:
    ``quantize(acc) -> (payload, new_residual)`` with
    ``acc == dequantize(payload) + new_residual`` exactly."""
    if compression is None:
        return None
    ctype = compression.get("type", "2bit")
    if ctype == "fp16":
        def quant(acc):
            q = acc.to(torch.float16)
            return q, acc - q.to(torch.float32)

        return quant, lambda q: q.to(torch.float32)
    if ctype == "int8":
        def quant(acc):
            # one symmetric scale a shard; a zero shard keeps the division
            # finite and its payload exactly zero
            scale = torch.clamp(acc.abs().max() / 127.0, min=1e-30)
            q = torch.clamp(torch.round(acc / scale), -127, 127).to(
                torch.int8)
            return (q, scale), acc - q.to(torch.float32) * scale

        def deq(payload):
            q, scale = payload
            return q.to(torch.float32) * scale

        return quant, deq
    if ctype == "2bit":
        t = float(compression.get("threshold", 0.5))

        def quant(acc):
            from ..kvstore import two_bit_quantize

            return two_bit_quantize(acc, t)

        return quant, lambda q: q
    raise ValueError("unsupported dist compression type %r "
                     "(fp16 / int8 / 2bit)" % (ctype,))


class HierarchicalAllreduce:
    """Two-level reduction over a mesh of ranks.

    mesh:        ``parallel.mesh.Mesh`` with ``ici_axis`` (and ``dcn_axis``)
    ici_axis:    fast axis: reduce-scatter and all-gather
    dcn_axis:    slow axis (None: one level)
    compression: None or ``{"type": "fp16"|"int8"|"2bit", ...}`` on the
                 shard that crosses ``dcn_axis``, with error feedback
    average:     divide the sum by the number of ranks
    dcn:         ``"jit"``: the shard crosses as an all-reduce of the
                 ``dcn`` group, launched with the bucket (the JAX
                 package's name for its in-program psum); ``"kvstore"``:
                 through ``DistKVStore`` push/pull on that group
    """

    def __init__(self, mesh, ici_axis="dp", dcn_axis=None, compression=None,
                 average=False, dcn="jit"):
        if dcn not in ("jit", "kvstore"):
            raise ValueError("dcn must be 'jit' or 'kvstore', got %r" % dcn)
        self.mesh = mesh
        self.ici_axis = ici_axis
        self.dcn_axis = dcn_axis
        self.compression = dict(compression) if compression else None
        self.average = bool(average)
        self.dcn = dcn
        self.ici_size = int(mesh.shape[ici_axis])
        self.dcn_size = int(mesh.shape[dcn_axis]) if dcn_axis else 1
        self._codec = _make_codec(self.compression)
        self._ici = mesh.group(ici_axis)
        self._dcn = mesh.group(dcn_axis) if dcn_axis else None
        self._kv = None
        self.key = ("hier", tuple(sorted(mesh.shape.items())), ici_axis,
                    dcn_axis, dcn,
                    tuple(sorted(self.compression.items()))
                    if self.compression else None, self.average)

    @property
    def world(self):
        return self.ici_size * self.dcn_size

    @property
    def needs_host_hop(self):
        return self.dcn == "kvstore"

    def pad_to(self, n):
        """A bucket's vector pads to a multiple of the ici size, so the
        reduce-scatter splits it evenly."""
        m = self.ici_size
        return ((n + m - 1) // m) * m

    def residual_init(self, n_pad, device=None):
        """This rank's error-feedback state of one bucket: its shard's
        residual, fp32 zeros (None without compression)."""
        if self._codec is None:
            return None
        return torch.zeros(n_pad // self.ici_size, dtype=torch.float32,
                           device=device)

    # ---------------------------------------------------------- the stages
    def _stage1(self, x, residual, stacked):
        """Reduce-scatter within ici, then compress: returns (the shard to
        cross dcn, dequantized, fp32; the new residual)."""
        shard = torch.empty(x.shape[0] // self.ici_size, dtype=x.dtype,
                            device=x.device)
        _reduce_scatter(shard, x, group=self._ici, async_op=True).wait()
        if not stacked:
            shard /= self.ici_size   # identical copies summed
        if self._codec is None:
            return shard, None
        quant, deq = self._codec
        payload, new_res = quant(shard + residual)
        return deq(payload), new_res

    def _cross(self, d, stacked):
        """Sum the shard over the dcn group."""
        if self.dcn_axis is None:
            return d
        if self.dcn == "kvstore":
            kv = self._kvstore()
            key = "dist_shard_%d_%d" % (d.numel(), int(stacked))
            kv.init(key, torch.zeros_like(d))
            kv.push(key, d)
            d = kv._store[key]
        else:
            dist.all_reduce(d, group=self._dcn, async_op=True).wait()
        return d if stacked else d / self.dcn_size

    def launch(self, vec, residual=None, stacked=True):
        """Start the exchange of one padded flat fp32 vector (this rank's
        row, or the replicated vector): returns ``(finish,
        new_residual)``, where ``finish()`` waits for the last collective
        (the all-gather) and gives the reduced vector."""
        d, new_res = self._stage1(vec, residual, stacked)
        d = self._cross(d, stacked)
        out = torch.empty(d.shape[0] * self.ici_size, dtype=d.dtype,
                          device=d.device)
        work = _all_gather(out, d.contiguous(), group=self._ici,
                           async_op=True)

        def finish():
            work.wait()
            if self.average and stacked:
                out.div_(self.world)
            return out

        return finish, new_res

    def reduce(self, vec, residual=None, stacked=True):
        """:meth:`launch` and wait: (out, new_residual)."""
        finish, new_res = self.launch(vec, residual, stacked)
        return finish(), new_res

    def _kvstore(self):
        if self._kv is None:
            from ..kvstore import DistKVStore

            self._kv = DistKVStore("dist_sync", group=self._dcn)
        return self._kv


class FlatAllreduce:
    """The serialized baseline: one all-reduce over the replica axes, no
    hierarchy, no compression."""

    def __init__(self, mesh, axes=("dp",), average=False):
        if len(axes) != 1 and tuple(axes) != tuple(mesh.axis_names):
            raise ValueError("FlatAllreduce reduces over one axis or over "
                             "every axis of the mesh")
        self.mesh = mesh
        self.axes = tuple(axes)
        self.average = bool(average)
        self.world = 1
        for a in self.axes:
            self.world *= int(mesh.shape[a])
        self._group = mesh.group(self.axes[0]) if len(self.axes) == 1 \
            else _mesh_group(mesh)
        self._codec = None
        self.dcn_axis = None
        self.dcn = "jit"
        self.key = ("flat", tuple(sorted(mesh.shape.items())), self.axes,
                    self.average)

    @property
    def needs_host_hop(self):
        return False

    def pad_to(self, n):
        return n

    def residual_init(self, n_pad, device=None):
        return None

    def launch(self, vec, residual=None, stacked=True):
        out = vec.clone()
        work = dist.all_reduce(out, group=self._group, async_op=True) \
            if stacked else None

        def finish():
            if work is not None:
                work.wait()
            if self.average and stacked:
                out.div_(self.world)
            return out

        return finish, residual

    def reduce(self, vec, residual=None, stacked=True):
        finish, res = self.launch(vec, residual, stacked)
        return finish(), res


def _mesh_group(mesh):
    """The process group of every rank of ``mesh`` (made once a mesh)."""
    g = getattr(mesh, "_all_group", None)
    if g is None:
        ranks = [int(r) for r in mesh.devices.ravel()]
        g = mesh._all_group = (None if ranks == list(
            range(dist.get_world_size())) else dist.new_group(ranks))
    return g
