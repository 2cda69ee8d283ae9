"""Serving snapshots (``serve.snapshot`` / ``serve.load(snapshot=True)``),
the counterpart of ``mxnet_tpu/cache/snapshot.py`` for the
``GenerativeServer`` and the ``ModelServer``.

The JAX package's artifact bundles the checkpoint, the serving config and
the serialized XLA executable of every warmed program, so a new replica
deserializes its programs instead of compiling them. The port's programs
are CUDA graphs (``serve/step_graph.py``), and a CUDA graph holds one
process's device addresses: it cannot be written to a file and read by
another process. So the port's artifact holds the checkpoint, the config
and the *list* of warmed programs, and :func:`load_snapshot` captures each
listed step program (decode, verify, chunk, the draft's round) on
throwaway slots before the server takes traffic; the first request then
replays graphs only. The eager entries (prefill, inject, extract and the
draft's fill at each prompt bucket) have nothing to compile or capture in
PyTorch: they are listed, for the JAX package and for the next snapshot,
and not run at load. The layout and the manifest are
the JAX package's (``FORMAT = 1``, ``kind: "generative"``, the same keys),
with no ``-exec/*.mxc`` files, so an artifact crosses between the
packages both ways: the port reads a JAX artifact's checkpoint and config
and ignores its executables (with one warning); the JAX package reads a
port artifact's checkpoint and config (the fingerprints differ, so it
loads no executables).

Layout, for ``prefix = "export/m"``::

    m-snapshot.json     manifest (config + program index), written atomically
    m-0000.params       checkpoint (``save_parameters``, dtype-exact npz)

A ModelServer artifact (``kind: "model"``) is the served block's export
layout (``checkpoint.save_for_serving``: ``m-symbol.json`` and
``m-0000.params``) with the manifest's ``input_names``, ``input_specs``
and ``buckets``; :func:`load_snapshot` reads the export into a
``SymbolBlock`` and builds a ``ModelServer`` over it, whose warmup
captures every bucket's graph before the first request. A JAX model
artifact's executables are ignored, as a generative one's are; the JAX
package loads a port artifact's export and config. A Gluon model whose
trace reads shapes (BERT) is exported at the largest bucket, whose batch
the graph then bakes in (``ROADMAP.md`` C.2).
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import warnings

import torch

from ..base import resolve_device

__all__ = ["FORMAT", "fingerprint", "atomic_write", "save_snapshot",
           "load_manifest", "load_snapshot"]

FORMAT = 1
SCHEMA = "mxnet_tpu_torch-snapshot-1"
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
# the program kinds a GenerativeServer's manifest lists (the JAX package's)
_DRAFT_KINDS = ("verify", "draftstep", "draftfill")


def _warn(msg):
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


@functools.lru_cache(maxsize=1)
def _csrc_digest():
    """sha256 (16 hex digits) of the kernel sources' names and bytes."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC)):
        h.update(name.encode())
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def fingerprint(device=None):
    """What a snapshot's programs were made with: torch, CUDA, the device's
    name and a hash of the kernel sources. A mismatch on load warns once
    and changes nothing else: load reads nothing compiled."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    return "|".join((SCHEMA, "torch=" + torch.__version__,
                     "cuda=%s" % torch.version.cuda, "device=" + name,
                     "csrc=" + _csrc_digest()))


def atomic_write(path, data):
    """Unique temporary file + rename (a copy of the JAX package's
    ``CompCacheStore.atomic_write``): a reader never sees a torn file, and
    two writers of the same bytes race harmlessly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _manifest_path(prefix):
    return prefix + "-snapshot.json"


def _params_path(prefix, epoch):
    return "%s-%04d.params" % (prefix, epoch)


# ---------------------------------------------------------------- saving

def _save_model_snapshot(server, prefix, input_names, epoch):
    """A ModelServer's artifact: the export layout of its model and the
    manifest's config. Returns the manifest."""
    import numpy as np

    from ..checkpoint import save_for_serving
    from ..gluon.block import SymbolBlock

    model = server.model
    shapes = None
    if isinstance(model, SymbolBlock):
        if input_names is None:
            input_names = [s.name for s in model._inputs]
    else:
        if input_names is None:
            input_names = ["data"]
        shapes = [(server.buckets[-1],) + tuple(shape)
                  for shape, _ in server._specs]
    input_names = list(input_names)
    for lock in server._replica_locks:  # no swap writes mid-export
        lock.acquire()
    try:
        save_for_serving(prefix, model, epoch=epoch,
                         input_names=input_names, input_shapes=shapes)
    finally:
        for lock in reversed(server._replica_locks):
            lock.release()
    return {"kind": "model", "input_names": input_names,
            "input_specs": [[list(shape), str(np.dtype(dt))]
                            for shape, dt in server._specs],
            "buckets": list(server.buckets),
            "quantize": getattr(server, "quantize", None),
            "pool_state": {}, "executables": {},
            "format": FORMAT, "fingerprint": fingerprint(server.device),
            "name": server.name, "epoch": int(epoch)}


def save_snapshot(server, prefix, input_names=None, epoch=0):
    """Write the serving artifact of a warmed ``ModelServer`` (its export
    layout and config; ``input_names`` name the model's inputs) or
    ``GenerativeServer`` (its parameters, its config and the index of its
    live programs). Returns the manifest path."""
    from ..serve.decoder import GenerativeServer
    from ..serve.server import ModelServer

    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".",
                exist_ok=True)
    if isinstance(server, ModelServer):
        manifest = _save_model_snapshot(server, prefix, input_names, epoch)
        path = _manifest_path(prefix)
        atomic_write(path, (json.dumps(manifest, indent=1) + "\n").encode())
        return path
    if not isinstance(server, GenerativeServer):
        raise TypeError("serve.snapshot takes a ModelServer or "
                        "GenerativeServer, got %r" % type(server).__name__)
    with server._params_lock:
        server.model.save_parameters(_params_path(prefix, epoch))
    entries = server.export_executables()
    if not entries:
        _warn("snapshot of %r lists no programs: did warmup run? load will "
              "capture them at first use" % server.name)
    execs = {}
    for e in entries:
        fe = {"kind": e["kind"], "tp": e["tp"], "capacity": e["capacity"]}
        if e.get("sampling") is not None:
            fe["sampling"] = e["sampling"]
        execs[e["key"]] = fe
    manifest = {
        "kind": "generative", "slots": server.slots, "top_k": server.top_k,
        "eos_id": server.eos_id, "capacity": int(server.cache.capacity),
        "prefix_cache": server.prefix is not None,
        "quantize": server._quantize,
        # spec_k and prefill_chunk shape the verify and chunk programs, so
        # load rebuilds the server with them; the draft is code, passed to
        # load as draft=, and named here for information
        "spec_k": server.spec_k, "prefill_chunk": server._prefill_chunk,
        "draft": (type(server._draft).__name__
                  if server._draft is not None else None),
        "prompt_buckets": sorted({e["tp"] for e in entries
                                  if e["kind"] == "prefill"}),
        "executables": execs,
        "format": FORMAT, "fingerprint": fingerprint(server.device),
        "name": server.name, "epoch": int(epoch)}
    path = _manifest_path(prefix)
    atomic_write(path, (json.dumps(manifest, indent=1) + "\n").encode())
    return path


# --------------------------------------------------------------- loading

def load_manifest(prefix):
    with open(_manifest_path(prefix)) as fh:
        m = json.load(fh)
    if m.get("format") != FORMAT:
        raise ValueError("snapshot %r has format %r, this build reads %d"
                         % (prefix, m.get("format"), FORMAT))
    return m


def _load_model_snapshot(prefix, manifest, server_kwargs):
    """A warmed ModelServer over the artifact's export, one bucket graph
    captured a bucket before this returns."""
    from ..checkpoint import load_for_serving
    from ..serve.server import ModelServer

    device = resolve_device(server_kwargs.get("device"))
    if manifest.get("executables"):
        _warn("snapshot %r carries serialized executables: a CUDA graph "
              "cannot be read from a file, so its buckets are captured here"
              % prefix)
    block = load_for_serving(prefix, epoch=manifest.get("epoch", 0),
                             input_names=manifest["input_names"],
                             ctx=device)
    specs = [(tuple(shape), dt) for shape, dt in manifest["input_specs"]]
    server_kwargs.setdefault("buckets", tuple(manifest["buckets"]))
    server_kwargs.setdefault("device", device)
    return ModelServer(block, specs, **server_kwargs)


def load_snapshot(prefix, model=None, **server_kwargs):
    """A ready server from a snapshot (either package's): a model
    artifact gives a warmed ``ModelServer`` over its export. For a
    generative one, a ``GenerativeServer``: ``model`` is the skeleton
    (the decode protocol is code; its parameters come from the
    artifact); extra kwargs reach the server's constructor
    (queue and deadline knobs, ``device``, ``draft``). Every listed step
    program is captured before this returns (an eager entry is only kept
    for the next snapshot); a draft program is skipped, with one warning,
    when no ``draft=`` is given, a chunk program when chunking is off."""
    from ..quantization import quantize_model
    from ..serve.decoder import GenerativeServer

    manifest = load_manifest(prefix)
    if manifest["kind"] == "model":
        return _load_model_snapshot(prefix, manifest, server_kwargs)
    if manifest["kind"] != "generative":
        raise ValueError("unknown snapshot kind %r" % manifest["kind"])
    if model is None:
        raise TypeError(
            "generative snapshots need the model instance: "
            "serve.load(prefix, snapshot=True, model=my_model); the decode "
            "protocol is code, only parameters, config and the program list "
            "are in the artifact")
    device = resolve_device(server_kwargs.get("device"))
    fp = fingerprint(device)
    if manifest.get("fingerprint") != fp:
        _warn("snapshot %r was made by %r, this process is %r: nothing "
              "compiled is read, so its programs are captured here all the "
              "same" % (prefix, manifest.get("fingerprint"), fp))
    execs = manifest.get("executables", {})
    files = sorted(k for k, fe in execs.items() if "file" in fe)
    if files:
        _warn("snapshot %r carries %d serialized executables (%s...): a "
              "CUDA graph holds one process's device addresses and cannot "
              "be read from a file, so they are ignored and their programs "
              "captured here" % (prefix, len(files), files[0]))
    quantize = manifest.get("quantize") or server_kwargs.get("quantize")
    server_kwargs.pop("quantize", None)
    if quantize:
        # the checkpoint holds the quantized parameter tree: swap the layers
        # first so load_parameters finds their slots. A bare skeleton gets
        # throwaway values on the server's device first (QuantizedDense
        # derives qweight from a materialized weight); load_parameters
        # overwrites every slot bit for bit
        if any(p._data is None and p._deferred_init is None
               for p in model.collect_params().values()):
            model.initialize(device=device)
        quantize_model(model, mode=quantize)
    # dtype-exact: each parameter takes the file's dtype (a bare fp32
    # skeleton must not upcast a bf16 checkpoint)
    model.load_parameters(_params_path(prefix, manifest.get("epoch", 0)),
                          ctx=device, cast_dtype=True, dtype_source="saved")
    server_kwargs.setdefault("spec_k", manifest.get("spec_k", 4))
    server_kwargs.setdefault("prefill_chunk", manifest.get("prefill_chunk"))
    srv = GenerativeServer(model, slots=manifest["slots"],
                           top_k=manifest["top_k"],
                           eos_id=manifest["eos_id"],
                           prefix_cache=manifest.get("prefix_cache", True),
                           quantize=quantize, **server_kwargs)
    if manifest.get("draft") and srv._draft is None:
        _warn("snapshot %r was made with a %s draft but load got no draft=: "
              "its speculative programs are skipped and the server decodes "
              "plain" % (prefix, manifest["draft"]))
    if manifest.get("capacity"):
        # the cache at the snapshot's capacity first, so the programs are
        # captured on the pages traffic will use (no migration after)
        srv.cache.ensure_capacity(manifest["capacity"])
    other = []
    for key, fe in sorted(execs.items()):
        if fe["kind"] in _DRAFT_KINDS and srv._draft is None:
            continue
        if fe["kind"] == "chunk" and srv._prefill_chunk != fe["tp"]:
            continue   # chunking off, or another chunk length asked for
        if fe["capacity"] != srv.cache.capacity:
            other.append(key)
            continue
        srv.preload_executable(fe["kind"], fe["tp"], fe["capacity"],
                               sampling=fe.get("sampling"))
    if other:
        _warn("snapshot %r lists %d programs at another capacity than its "
              "cache's %d (%s...): the port's programs live at one capacity "
              "(a migration drops them), so they are skipped"
              % (prefix, len(other), srv.cache.capacity, other[0]))
    return srv
