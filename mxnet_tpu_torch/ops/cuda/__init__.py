"""The port's hand-written CUDA kernels: one Python wrapper module per
kernel (with the kernel's plain PyTorch version beside it), sources under
``mxnet_tpu_torch/csrc``, built by ``_build.py`` at first launch.

A kernel's backward is not differentiable: under
``autograd.grad(create_graph=True)`` (a backward that runs with grad mode
on) a kernel Function's backward on a CUDA tensor raises
:class:`SecondOrderError`, as the JAX package's Pallas kernels refuse a
second derivative on its chip. On a CPU tensor it recomputes what the
forward saved with differentiable torch ops, so the plain path's second
order is exact, as the JAX package's CPU path is.

Each kernel entry is a ``torch.library`` custom op in the namespace
``mxnet_tpu_torch::`` (the counterpart of a ``pallas_call`` being an opaque
primitive to ``jax.jit``): ``torch.compile`` and compiled autograd trace it
through its fake implementation, without a graph break, and a ``meta``
tensor gets its output shapes and dtypes from the same fake (symbolic shape
inference). The public wrappers call through the ops; an op's
implementation calls the entry of :data:`IMPLS` under the wrapper's name,
which takes the plain version for a CPU tensor and launches the kernel,
counting it, for a CUDA tensor. A check that runs a model without the
kernels (or with a planted fault) swaps those entries."""

import threading

# {public wrapper name: the function that wrapper's op calls}
IMPLS = {}

_meta = threading.local()


class shape_inference:
    """Within the block, a kernel op called on ``meta`` tensors answers
    with its fake implementation's shapes and dtypes (the symbolic shape
    inference, ``shape_inference.py``). Outside it a ``meta`` tensor raises
    in the op, as any device without a kernel does."""

    def __enter__(self):
        self._prev = getattr(_meta, "on", False)
        _meta.on = True
        return self

    def __exit__(self, *exc):
        _meta.on = self._prev


def fake_check(name, t):
    """Raise for a ``meta`` tensor outside :class:`shape_inference` (a fake
    tensor of ``torch.compile`` reports its real device and passes), and
    for a CUDA tensor where there is no CUDA device, as the kernel's build
    would."""
    if t.device.type == "cuda":
        import torch

        from ...base import DeviceError

        if not torch.cuda.is_available():
            raise DeviceError("the CUDA kernels need a CUDA device (%s)"
                              % name)
    if t.device.type == "meta" and not getattr(_meta, "on", False):
        raise ValueError("%s: no kernel for device meta (meta tensors take "
                         "the op's shapes inside ops.cuda.shape_inference "
                         "only)" % name)


def implementation(name):
    """Register the decorated function as the implementation behind the
    public wrapper ``name``."""
    def deco(fn):
        IMPLS[name] = fn
        return fn

    return deco


class SecondOrderError(NotImplementedError):
    """A second derivative asked through a hand-written CUDA kernel."""


def no_second_order(kernel, t):
    """Raise :class:`SecondOrderError` naming ``kernel`` unless ``t`` lies
    on the CPU."""
    if t.device.type != "cpu":
        raise SecondOrderError(
            "second order is not supported through the %s CUDA kernel "
            "(autograd.grad(create_graph=True) reached its backward on %s)"
            % (kernel, t.device))


def launch_counters():
    """{name: the wrapper whose ``launches`` attribute counts that
    kernel's launches}, for every kernel of the port."""
    from . import flash_attention as fa
    from . import layernorm as ln
    from . import softmax_xent as sx

    return {"layernorm": ln.fused_layernorm,
            "layernorm_bwd": ln.fused_layernorm_bwd,
            "flash_attention_fwd": fa.flash_attention,
            "flash_attention_fwd_f32": fa.flash_attention_f32,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "softmax_xent_fwd": sx.softmax_xent_fwd,
            "softmax_xent_bwd": sx.softmax_xent_bwd}
