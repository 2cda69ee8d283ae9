"""The port's hand-written CUDA kernels: one Python wrapper module per
kernel (with the kernel's plain PyTorch version beside it), sources under
``mxnet_tpu_torch/csrc``, built by ``_build.py`` at first launch.

A kernel's backward is not differentiable: under
``autograd.grad(create_graph=True)`` (a backward that runs with grad mode
on) a kernel Function's backward on a CUDA tensor raises
:class:`SecondOrderError`, as the JAX package's Pallas kernels refuse a
second derivative on its chip. On a CPU tensor it recomputes what the
forward saved with differentiable torch ops, so the plain path's second
order is exact, as the JAX package's CPU path is."""


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
