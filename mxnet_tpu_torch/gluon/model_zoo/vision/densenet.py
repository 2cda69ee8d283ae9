"""DenseNet (ref: python/mxnet/gluon/model_zoo/vision/densenet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169", "densenet201"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False))
            self.body.add(nn.BatchNorm())
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
            if dropout:
                self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _transition(channels):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(channels, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                blk = nn.HybridSequential(prefix="block%d_" % (i + 1))
                with blk.name_scope():
                    for _ in range(num_layers):
                        blk.add(_DenseLayer(growth_rate, bn_size, dropout))
                self.features.add(blk)
                num_features += num_layers * growth_rate
                if i != len(block_config) - 1:
                    num_features //= 2
                    self.features.add(_transition(num_features))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _make(n):
    def f(**kw):
        a, b, c = densenet_spec[n]
        return DenseNet(a, b, c, **kw)

    return f


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
