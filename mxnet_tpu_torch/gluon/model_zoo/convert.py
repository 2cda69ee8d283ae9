"""Pretrained weights for the vision zoo (counterpart of the path through
``mxnet_tpu/gluon/model_zoo/convert.py`` that every zoo factory takes).

No model store is reachable, so ``pretrained`` is a path to a native
parameter file (``.params``/``.npz``, either package's
``save_parameters``), loaded by structural name; ``pretrained=True``
raises. The JAX package's converters of torchvision and HuggingFace
checkpoints are not ported yet (ROADMAP.md A.11).
"""
from __future__ import annotations


def resolve_pretrained(pretrained):
    """Check a factory's ``pretrained`` before the network is built:
    ``True`` raises (no model store), a path passes, a false value gives
    None."""
    if pretrained is True:
        raise ValueError(
            "no model store is reachable; pass pretrained=<path> to a "
            "native .params or .npz file")
    return pretrained or None


def load_pretrained(net, path, ctx=None):
    """Load the native parameter file ``path`` into ``net``, its tensors on
    ``ctx`` (default: the current CUDA device)."""
    p = str(path)
    if p.endswith((".params", ".npz")):
        net.load_parameters(p, ctx=ctx)
        return net
    if p.endswith((".pth", ".pt", ".bin")):
        raise NotImplementedError(
            "%r is a torch checkpoint: its torchvision converter is not "
            "ported yet (ROADMAP.md A.11); convert it to a .params file with "
            "the JAX package" % p)
    raise ValueError("unrecognized checkpoint extension in %r (.params or "
                     ".npz)" % p)


def build_with_pretrained(factory, pretrained, ctx=None, **kwargs):
    """The one pretrained path of every zoo factory: check ``pretrained``,
    build ``factory(**kwargs)``, then load the file on ``ctx``."""
    path = resolve_pretrained(pretrained)
    net = factory(**kwargs)
    if path:
        load_pretrained(net, path, ctx)
    return net
