"""SSD object detection (counterpart of ``mxnet_tpu/models/ssd.py``; ref:
gluon-cv gluoncv/model_zoo/ssd/ssd.py).

A VGG-style base, four stride-2 down blocks and a class and a box head
per scale; anchors from ``F.multibox_prior``; training targets from
``F.multibox_target`` inside ``SSDLoss``; ``detect`` decodes with
``F.multibox_detection`` (per-class greedy NMS on the device). The
parameter names are the JAX package's.
"""
from __future__ import annotations

import torch

from ..base import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray, unwrap, wrap
from ..ops import functional as F

__all__ = ["SSD", "ssd_512", "SSDLoss"]


def _vgg_base(filters=(64, 128, 256, 512)):
    net = nn.HybridSequential(prefix="base_")
    with net.name_scope():
        for f in filters:
            net.add(nn.Conv2D(f, 3, padding=1, activation="relu"))
            net.add(nn.Conv2D(f, 3, padding=1, activation="relu"))
            net.add(nn.BatchNorm())
            net.add(nn.MaxPool2D(2))
    return net


class _DownBlock(HybridBlock):
    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(channels // 2, 1, activation="relu"))
            self.body.add(nn.Conv2D(channels, 3, strides=2, padding=1,
                                    activation="relu"))
            self.body.add(nn.BatchNorm())

    def hybrid_forward(self, F, x):
        return self.body(x)


class SSD(HybridBlock):
    def __init__(self, num_classes=20, image_size=512,
                 sizes=((0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                        (0.54, 0.619), (0.71, 0.79)),
                 ratios=((1, 2, 0.5),) * 5, **kwargs):
        super().__init__(**kwargs)
        self._num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        num_scales = len(sizes)
        with self.name_scope():
            self.base = _vgg_base()
            self.downs = nn.HybridSequential(prefix="down_")
            for _ in range(num_scales - 1):
                self.downs.add(_DownBlock(512))
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.box_heads = nn.HybridSequential(prefix="box_")
            for i in range(num_scales):
                a = len(sizes[i]) + len(ratios[i]) - 1
                self.cls_heads.add(nn.Conv2D(a * (num_classes + 1), 3,
                                             padding=1))
                self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1))

    def hybrid_forward(self, F, x):
        """x (B, 3, H, W) -> (cls_preds (B, N, C + 1), box_preds (B, N*4),
        anchors (1, N, 4) fp32)."""
        feats = [self.base(x)]
        for down in self.downs:
            feats.append(down(feats[-1]))
        cls_preds, box_preds, anchors = [], [], []
        for i, feat in enumerate(feats):
            cp = self.cls_heads[i](feat)  # (B, A*(C+1), H, W)
            bp = self.box_heads[i](feat)
            B = cp.shape[0]
            cls_preds.append(cp.permute(0, 2, 3, 1).reshape(
                B, -1, self._num_classes + 1))
            box_preds.append(bp.permute(0, 2, 3, 1).reshape(B, -1))
            anchors.append(F.multibox_prior(feat, sizes=tuple(self._sizes[i]),
                                            ratios=tuple(self._ratios[i])))
        return (torch.cat(cls_preds, dim=1), torch.cat(box_preds, dim=1),
                torch.cat(anchors, dim=1))

    def detect(self, x, nms_thresh=0.45, score_thresh=0.01, device=None):
        """(B, N, 6) detections [class id, score, x1, y1, x2, y2], -1 ids
        and scores for the suppressed and the ones under ``score_thresh``,
        on ``device`` (default: the current CUDA device; the parameters
        and x must be there). An NDArray x gives an NDArray."""
        device = resolve_device(device)
        as_nd = isinstance(x, NDArray)
        x = unwrap(x, False)
        if x.device != device:
            raise ValueError("detect on %s, but x is on %s"
                             % (device, x.device))
        with torch.no_grad():
            cls_preds, box_preds, anchors = self(x)
            cls_prob = F.softmax(cls_preds, axis=-1).transpose(1, 2)
            det = F.multibox_detection(cls_prob, box_preds, anchors,
                                       nms_threshold=nms_thresh,
                                       threshold=score_thresh)
        return wrap(det) if as_nd else det


class SSDLoss(HybridBlock):
    """The classification cross-entropy over the anchors with a target
    (positives and mined negatives) plus the smooth-L1 box loss over the
    positives, each averaged per image (ref: gluoncv ssd/target.py and
    the training script). Returns the per-image loss (B,)."""

    def __init__(self, num_classes, **kwargs):
        super().__init__(**kwargs)
        self._num_classes = num_classes

    def hybrid_forward(self, F, cls_preds, box_preds, labels, anchors):
        cls_prob_t = F.softmax(cls_preds, axis=-1).transpose(1, 2)
        box_t, box_m, cls_t = F.multibox_target(anchors, labels, cls_prob_t)
        logp = F.log_softmax(cls_preds, axis=-1)
        picked = F.pick(logp, F.maximum(cls_t, 0.0), axis=-1)
        valid = (cls_t >= 0.0).to(torch.float32)
        cls_loss = -F.sum(picked * valid, axis=1) / F.maximum(
            F.sum(valid, axis=1), 1.0)
        box_l = F.smooth_l1(box_preds - box_t, scalar=1.0) * box_m
        box_loss = F.sum(box_l, axis=1) / F.maximum(F.sum(box_m, axis=1),
                                                    1.0)
        return cls_loss + box_loss


def ssd_512(num_classes=20, **kwargs):
    """``bench.py``'s ``ssd512`` model: SSD at 512 x 512, 5456 anchors."""
    return SSD(num_classes=num_classes, image_size=512, **kwargs)
