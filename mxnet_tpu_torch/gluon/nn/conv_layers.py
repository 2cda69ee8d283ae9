"""Convolution and pooling layers (ref: python/mxnet/gluon/nn/conv_layers.py;
the JAX package's ``mxnet_tpu/gluon/nn/conv_layers.py``), with the same
parameter names, shapes and defaults. ``layout`` and ``ceil_mode`` are
accepted and not used, as in the JAX package: the layout is NC..., and a
pooled size is floor((size + 2 pad - kernel) / stride) + 1 (ROADMAP.md
C.2)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """(ref: conv_layers.py:_Conv → src/operator/nn/convolution.cc). The
    weight is (channels, in_channels / groups, k...), or (in_channels,
    channels / groups, k...) for a transposed convolution; ``in_channels``
    0 is inferred at the first forward."""

    _ndim = 2
    _transpose = False

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", output_padding=0, **kwargs):
        super().__init__(**kwargs)
        nd = self._ndim
        self._channels = channels
        self._groups = groups
        self._kwargs = dict(stride=_tuple(strides, nd),
                            pad=_tuple(padding, nd),
                            dilate=_tuple(dilation, nd), num_group=groups)
        if self._transpose:
            self._kwargs["adj"] = _tuple(output_padding, nd)
        kernel = _tuple(kernel_size, nd)
        with self.name_scope():
            if self._transpose:
                wshape = (in_channels, channels // groups) + kernel
            else:
                wshape = (channels, in_channels // groups) + kernel
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None
            from .basic_layers import Activation

            self.act = Activation(activation, prefix=activation + "_") \
                if activation else None

    def infer_shape(self, x, *args):
        c = x.shape[1]
        if self._transpose:
            self.weight.shape = (c, self._channels // self._groups) \
                + self.weight.shape[2:]
        else:
            self.weight.shape = (self._channels, c // self._groups) \
                + self.weight.shape[2:]

    def hybrid_forward(self, F, x, weight, bias=None):
        op = F.Deconvolution if self._transpose else F.Convolution
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out


class Conv1D(_Conv):
    _ndim = 1


class Conv2D(_Conv):
    _ndim = 2


class Conv3D(_Conv):
    _ndim = 3


class Conv1DTranspose(_Conv):
    _ndim = 1
    _transpose = True


class Conv2DTranspose(_Conv):
    _ndim = 2
    _transpose = True


class Conv3DTranspose(_Conv):
    _ndim = 3
    _transpose = True


class _Pooling(HybridBlock):
    _pool_type = "max"
    _ndim = 2
    _global = False

    def __init__(self, pool_size=2, strides=None, padding=0, ceil_mode=False,
                 count_include_pad=True, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        nd = self._ndim
        self._kwargs = dict(
            kernel=_tuple(pool_size, nd),
            stride=_tuple(strides if strides is not None else pool_size, nd),
            pad=_tuple(padding, nd), pool_type=self._pool_type,
            global_pool=self._global, count_include_pad=count_include_pad)

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    _ndim = 1


class MaxPool2D(_Pooling):
    _ndim = 2


class MaxPool3D(_Pooling):
    _ndim = 3


class AvgPool1D(_Pooling):
    _pool_type = "avg"
    _ndim = 1


class AvgPool2D(_Pooling):
    _pool_type = "avg"
    _ndim = 2


class AvgPool3D(_Pooling):
    _pool_type = "avg"
    _ndim = 3


class GlobalMaxPool1D(_Pooling):
    _ndim = 1
    _global = True


class GlobalMaxPool2D(_Pooling):
    _ndim = 2
    _global = True


class GlobalMaxPool3D(_Pooling):
    _ndim = 3
    _global = True


class GlobalAvgPool1D(_Pooling):
    _pool_type = "avg"
    _ndim = 1
    _global = True


class GlobalAvgPool2D(_Pooling):
    _pool_type = "avg"
    _ndim = 2
    _global = True


class GlobalAvgPool3D(_Pooling):
    _pool_type = "avg"
    _ndim = 3
    _global = True


class ReflectionPad2D(HybridBlock):
    """Reflection padding on H and W of NCHW input (ref:
    conv_layers.py:ReflectionPad2D). ``padding`` is an int (all four
    spatial edges) or upstream's 8-tuple of NCHW (before, after) pairs."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise ValueError("ReflectionPad2D takes an int or 8 pad widths, "
                             "got %r" % (padding,))
        self._pad_width = tuple(int(p) for p in padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._pad_width)
