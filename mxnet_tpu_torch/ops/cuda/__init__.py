"""The port's hand-written CUDA kernels: one Python wrapper module per
kernel (with the kernel's plain PyTorch version beside it), sources under
``mxnet_tpu_torch/csrc``, built by ``_build.py`` at first launch."""
