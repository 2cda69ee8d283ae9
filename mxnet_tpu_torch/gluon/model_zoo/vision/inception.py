"""Inception-v3 (ref: python/mxnet/gluon/model_zoo/vision/inception.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, strides, padding, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branch(HybridBlock):
    """Parallel branches concatenated along channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._branches = []
            for i, b in enumerate(branches):
                self.register_child(b, "branch%d" % i)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._children.values()], dim=1)


def _inc_a(pool_features):
    def branch(*convs):
        s = nn.HybridSequential(prefix="")
        for c in convs:
            s.add(c)
        return s

    return _Branch([
        _conv(64, 1),
        branch(_conv(48, 1), _conv(64, 5, padding=2)),
        branch(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, padding=1)),
        branch(nn.AvgPool2D(3, 1, 1), _conv(pool_features, 1)),
    ])


def _inc_b():
    s = nn.HybridSequential(prefix="")
    s.add(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, strides=2))
    return _Branch([_conv(384, 3, strides=2), s, nn.MaxPool2D(3, 2)])


def _inc_c(c7):
    def seq(*blocks):
        s = nn.HybridSequential(prefix="")
        for b in blocks:
            s.add(b)
        return s

    return _Branch([
        _conv(192, 1),
        seq(_conv(c7, 1), _conv(c7, (1, 7), padding=(0, 3)), _conv(192, (7, 1), padding=(3, 0))),
        seq(_conv(c7, 1), _conv(c7, (7, 1), padding=(3, 0)), _conv(c7, (1, 7), padding=(0, 3)),
            _conv(c7, (7, 1), padding=(3, 0)), _conv(192, (1, 7), padding=(0, 3))),
        seq(nn.AvgPool2D(3, 1, 1), _conv(192, 1)),
    ])


def _inc_d():
    def seq(*blocks):
        s = nn.HybridSequential(prefix="")
        for b in blocks:
            s.add(b)
        return s

    return _Branch([
        seq(_conv(192, 1), _conv(320, 3, strides=2)),
        seq(_conv(192, 1), _conv(192, (1, 7), padding=(0, 3)),
            _conv(192, (7, 1), padding=(3, 0)), _conv(192, 3, strides=2)),
        nn.MaxPool2D(3, 2),
    ])


class _IncE2(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.pre = _conv(384, 1)
            self.a = _conv(384, (1, 3), padding=(0, 1))
            self.b = _conv(384, (3, 1), padding=(1, 0))

    def hybrid_forward(self, F, x):
        x = self.pre(x)
        return F.concat(self.a(x), self.b(x), dim=1)


class _IncE3(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.p1 = _conv(448, 1)
            self.p2 = _conv(384, 3, padding=1)
            self.a = _conv(384, (1, 3), padding=(0, 1))
            self.b = _conv(384, (3, 1), padding=(1, 0))

    def hybrid_forward(self, F, x):
        x = self.p2(self.p1(x))
        return F.concat(self.a(x), self.b(x), dim=1)


def _inc_e():
    s = nn.HybridSequential(prefix="")
    s.add(nn.AvgPool2D(3, 1, 1), _conv(192, 1))
    return _Branch([_conv(320, 1), _IncE2(), _IncE3(), s])


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_conv(32, 3, strides=2))
            self.features.add(_conv(32, 3))
            self.features.add(_conv(64, 3, padding=1))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_conv(80, 1))
            self.features.add(_conv(192, 3))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(_inc_a(32), _inc_a(64), _inc_a(64))
            self.features.add(_inc_b())
            self.features.add(_inc_c(128), _inc_c(160), _inc_c(160), _inc_c(192))
            self.features.add(_inc_d())
            self.features.add(_inc_e(), _inc_e())
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(**kw):
    return Inception3(**kw)
