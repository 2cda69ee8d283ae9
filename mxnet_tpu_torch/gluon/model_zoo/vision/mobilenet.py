"""MobileNet v1/v2 (ref: python/mxnet/gluon/model_zoo/vision/mobilenet.py;
the JAX package's ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``).

A depthwise convolution is a grouped ``Conv2D`` (groups = channels).
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "MobileNetV2", "MobileNetV2TV", "mobilenet1_0",
           "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_5", "mobilenet_v2_tv"]


def _conv_block(out, channels, kernel=3, stride=1, pad=1, num_group=1, active=True):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group, use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu"))


def _dw_block(out, dw_channels, channels, stride):
    _conv_block(out, dw_channels, stride=stride, num_group=dw_channels)
    _conv_block(out, channels, kernel=1, pad=0)


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _conv_block(self.features, int(32 * multiplier), stride=2)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
            strides = [1, 2] * 3 + [1] * 5 + [2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _dw_block(self.features, dwc, c, s)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _conv_block(self.out, in_channels * t, kernel=1, pad=0)
            _conv_block(self.out, in_channels * t, stride=stride, num_group=in_channels * t)
            _conv_block(self.out, channels, kernel=1, pad=0, active=False)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            _conv_block(self.features, int(32 * multiplier), stride=2)
            in_c = [int(multiplier * x) for x in
                    [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 + [160] * 3]
            channels = [int(multiplier * x) for x in
                        [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3 + [160] * 3 + [320]]
            ts = [1] + [6] * 16
            strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
            for ic, c, t, s in zip(in_c, channels, ts, strides):
                self.features.add(LinearBottleneck(ic, c, t, s))
            last = int(1280 * multiplier) if multiplier > 1.0 else 1280
            _conv_block(self.features, last, kernel=1, pad=0)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Conv2D(classes, 1, use_bias=False, prefix="pred_")
            self.flat = nn.Flatten()

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return self.flat(x)


def _conv_bn_relu6(channels, kernel=3, stride=1, pad=1, groups=1):
    """torchvision's ConvBNReLU triple as one HybridSequential, so the
    structural indices (.0 conv, .1 bn) line up with its state_dict."""
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=groups,
                      use_bias=False))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu6"))
    return out


class InvertedResidualTV(HybridBlock):
    """torchvision MobileNetV2 block: relu6, NO expansion conv at t=1, and
    the exact submodule layout (``conv.0`` expand / ``conv.1`` depthwise /
    trailing project conv + bn) of torchvision.models.mobilenetv2: the
    layout of torchvision's checkpoints, which the upstream-layout
    ``LinearBottleneck`` (always-expand, plain relu) is not."""

    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        hidden = in_channels * t
        with self.name_scope():
            self.conv = nn.HybridSequential(prefix="")
            if t != 1:
                self.conv.add(_conv_bn_relu6(hidden, kernel=1, pad=0))
            self.conv.add(_conv_bn_relu6(hidden, stride=stride, groups=hidden))
            self.conv.add(nn.Conv2D(channels, 1, use_bias=False))
            self.conv.add(nn.BatchNorm())

    def hybrid_forward(self, F, x):
        out = self.conv(x)
        return out + x if self.use_shortcut else out


class MobileNetV2TV(HybridBlock):
    """MobileNetV2 in torchvision's exact layout (ref: upstream ships this
    family pretrained via the model store; torchvision.models.mobilenet_v2
    is the checkpoint source reachable offline). features.0 stem /
    features.1-17 inverted residuals / features.18 head mirror the
    torchvision indices, so its weights map one to one."""

    # (t, c, n, s) — torchvision inverted_residual_setting
    _SETTING = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)

        def _c(ch):
            # torchvision _make_divisible(ch * multiplier, 8)
            v = max(8, int(ch * multiplier + 4) // 8 * 8)
            if v < 0.9 * ch * multiplier:
                v += 8
            return v

        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            in_c = _c(32)
            self.features.add(_conv_bn_relu6(in_c, stride=2))
            for t, c, n, s in self._SETTING:
                out_c = _c(c)
                for i in range(n):
                    self.features.add(InvertedResidualTV(
                        in_c, out_c, t, s if i == 0 else 1))
                    in_c = out_c
            last = _c(1280) if multiplier > 1.0 else 1280
            self.features.add(_conv_bn_relu6(last, kernel=1, pad=0))
            self.output = nn.Dense(classes, in_units=last)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = F.mean(x, axis=(2, 3))  # torchvision adaptive avg pool to 1x1
        return self.output(x)


def mobilenet_v2_tv(**kw):
    return MobileNetV2TV(1.0, **kw)


def mobilenet1_0(**kw):
    return MobileNet(1.0, **kw)


def mobilenet0_75(**kw):
    return MobileNet(0.75, **kw)


def mobilenet0_5(**kw):
    return MobileNet(0.5, **kw)


def mobilenet0_25(**kw):
    return MobileNet(0.25, **kw)


def mobilenet_v2_1_0(**kw):
    return MobileNetV2(1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return MobileNetV2(0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return MobileNetV2(0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return MobileNetV2(0.25, **kw)
