"""The port's hand-written CUDA kernels: one Python wrapper module per
kernel (with the kernel's plain PyTorch version beside it), sources under
``mxnet_tpu_torch/csrc``, built by ``_build.py`` at first launch."""


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
