"""The model store's entry points (ref: python/mxnet/gluon/model_zoo/
model_store.py; counterpart of ``mxnet_tpu/gluon/model_zoo/
model_store.py``).

No store is reachable, so nothing is downloaded: every entry point exists
for code written against the store, and points at the converter instead.
Convert a torchvision checkpoint once with ``gluon.model_zoo.convert``,
then load the native ``.params`` file.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "mark_managed", "purge"]

_MARKER_SUFFIX = ".mxnet-store"

_HELP = (
    "the model store is unreachable; convert a checkpoint you have "
    "instead: get_model(%r, pretrained='/path/to/ckpt.pth') or "
    "`python -m mxnet_tpu_torch.gluon.model_zoo.convert %s ckpt.pth "
    "out.params` (see gluon.model_zoo.convert)")


def mark_managed(path):
    """Record that ``path`` was written by the converter (a zero-byte
    sidecar), which makes it eligible for :func:`purge`."""
    open(path + _MARKER_SUFFIX, "w").close()


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """``<root>/<name>.params`` if it exists; otherwise raise with the
    converter's recipe (no download)."""
    root = os.path.expanduser(root)
    path = os.path.join(root, "%s.params" % name)
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        ("%s not found in %s; " % (name, root)) + _HELP % (name, name))


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Remove the ``.params`` files of ``root`` that carry the converter's
    sidecar marker, and markers whose file is gone; a ``.params`` placed by
    hand stays, with a warning naming it."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    skipped = []
    for f in sorted(os.listdir(root)):
        if f.endswith(".params"):
            if os.path.exists(os.path.join(root, f + _MARKER_SUFFIX)):
                os.remove(os.path.join(root, f))
                os.remove(os.path.join(root, f + _MARKER_SUFFIX))
            else:
                skipped.append(f)
    for f in os.listdir(root):
        if f.endswith(_MARKER_SUFFIX) and not os.path.exists(
                os.path.join(root, f[:-len(_MARKER_SUFFIX)])):
            os.remove(os.path.join(root, f))
    if skipped:
        import warnings

        warnings.warn(
            "model_store.purge left %d unmanaged .params in place (%s...): "
            "the store only deletes files it wrote; remove by hand or "
            "mark_managed() first" % (len(skipped), skipped[0]))
