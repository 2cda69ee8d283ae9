"""Mixed precision (counterpart of ``mxnet_tpu/amp.py``
``convert_hybrid_block``): cast a block's parameters to bfloat16 and keep
the normalization parameters (BatchNorm's moving statistics among them) in
float32."""
from __future__ import annotations

import torch


def convert_hybrid_block(block, target_dtype="bfloat16"):
    block.cast(target_dtype)
    _fix_norms(block)
    return block


def _fix_norms(block):
    from .gluon.nn.basic_layers import (BatchNorm, GroupNorm, InstanceNorm,
                                        LayerNorm)

    if isinstance(block, (BatchNorm, LayerNorm, InstanceNorm, GroupNorm)):
        for p in block._reg_params.values():
            p.cast(torch.float32)
    for child in block._children.values():
        _fix_norms(child)
