"""``mx.npx``: the neural-net extensions of the numpy namespace
(counterpart of ``mxnet_tpu/npx.py``; ref:
python/mxnet/ndarray/numpy_extension), and the numpy-mode flag that
``util.set_np``/``reset_np`` switch."""
from __future__ import annotations

from .ndarray import invoke

_np_mode = [False]


def set_np(shape=True, array=True):
    _np_mode[0] = True


def reset_np():
    _np_mode[0] = False


def is_np_array():
    return _np_mode[0]


def _op(name):
    def f(*args, **kwargs):
        return invoke(name, args, kwargs)

    f.__name__ = name
    return f


softmax = _op("softmax")
log_softmax = _op("log_softmax")
relu = _op("relu")
sigmoid = _op("sigmoid")
batch_norm = _op("BatchNorm")
layer_norm = _op("LayerNorm")
fully_connected = _op("FullyConnected")
convolution = _op("Convolution")
pooling = _op("Pooling")
dropout = _op("Dropout")
embedding = _op("Embedding")
one_hot = _op("one_hot")
pick = _op("pick")
topk = _op("topk")
batch_dot = _op("batch_dot")
gamma = _op("gamma")
gammaln = _op("gammaln")
erf = _op("erf")
erfinv = _op("erfinv")
smooth_l1 = _op("smooth_l1")
sequence_mask = _op("SequenceMask")
gather_nd = _op("gather_nd")
scatter_nd = _op("scatter_nd")
leaky_relu = _op("LeakyReLU")
activation = _op("Activation")
rnn = _op("RNN")
broadcast_like = _op("broadcast_like")
reshape_like = _op("reshape_like")
sequence_last = _op("SequenceLast")
sequence_reverse = _op("SequenceReverse")
multibox_prior = _op("multibox_prior")
multibox_detection = _op("multibox_detection")
box_nms = _op("box_nms")
box_iou = _op("box_iou")
ctc_loss = _op("CTCLoss")


def __getattr__(name):
    """Any registry op is ``npx.<name>`` (ref: MXNet 2.x generates mx.npx
    from the operator registry the same way)."""
    import sys

    from .base import OP_REGISTRY

    if name in OP_REGISTRY:
        f = _op(name)
        setattr(sys.modules[__name__], name, f)
        return f
    raise AttributeError("npx has no op %r" % name)
