"""SqueezeNet (ref: python/mxnet/gluon/model_zoo/vision/squeezenet.py).

Upstream's pools take ``ceil_mode=True``; as in the JAX package, the pooled
sizes follow floor here (ROADMAP.md C.2)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, kernel_size=1, activation="relu")
            self.expand1 = nn.Conv2D(expand1x1, kernel_size=1, activation="relu")
            self.expand3 = nn.Conv2D(expand3x3, kernel_size=3, padding=1,
                                     activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1(x), self.expand3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2, activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(16, 64, 64), _Fire(16, 64, 64), _Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(32, 128, 128), _Fire(48, 192, 192),
                                  _Fire(48, 192, 192), _Fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2, activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(16, 64, 64), _Fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(32, 128, 128), _Fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(48, 192, 192), _Fire(48, 192, 192),
                                  _Fire(64, 256, 256), _Fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)
