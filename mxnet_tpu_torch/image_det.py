"""Detection augmenters (counterpart of ``mxnet_tpu/image_det.py``; ref:
python/mxnet/image/detection.py).

Labels are 2D float arrays, one object per row: ``[cls, xmin, ymin, xmax,
ymax, ...]`` with coordinates normalized to [0, 1] relative to the image.
Host numpy, like the classification augmenters; images come back as
NDArrays on ``mx.cpu()`` (ROADMAP C.2, the host rule). Each random
augmenter draws from ``rng`` (numpy's global state by default) in the JAX
package's order.
"""
from __future__ import annotations

import json

import numpy as np


def _asnp(img):
    from .ndarray import NDArray
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def _wrap(a):
    from .image import _host
    return _host(a)


class DetAugmenter:
    """Detection augmenter base (ref: detection.py:DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __getstate__(self):
        from .image import _getstate
        return _getstate(self)

    def __setstate__(self, d):
        from .image import _setstate
        _setstate(self, d)

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Borrow a plain image Augmenter; label passes through
    (ref: detection.py:DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly pick one augmenter from a list, or skip
    (ref: detection.py:DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0, rng=None):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob
        self.rng = rng or np.random

    def __call__(self, src, label):
        if self.rng.random_sample() < self.skip_prob or not self.aug_list:
            return src, label
        i = self.rng.randint(0, len(self.aug_list))
        return self.aug_list[i](src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and box x-coordinates (ref: detection.py:DetHorizontalFlipAug)."""

    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng or np.random

    def __call__(self, src, label):
        if self.rng.random_sample() < self.p:
            a = _asnp(src)
            src = _wrap(a[:, ::-1].copy())
            label = np.asarray(label, np.float32).copy()
            tmp = 1.0 - label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = tmp
        return src, label


def _box_iou_1many(crop, boxes):
    """IoU of one [x0,y0,x1,y1] crop against N boxes (normalized coords)."""
    ix0 = np.maximum(crop[0], boxes[:, 0])
    iy0 = np.maximum(crop[1], boxes[:, 1])
    ix1 = np.minimum(crop[2], boxes[:, 2])
    iy1 = np.minimum(crop[3], boxes[:, 3])
    iw = np.clip(ix1 - ix0, 0, None)
    ih = np.clip(iy1 - iy0, 0, None)
    inter = iw * ih
    area_c = (crop[2] - crop[0]) * (crop[3] - crop[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area_c + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _coverage(crop, boxes):
    """Fraction of each box's area covered by the crop."""
    ix0 = np.maximum(crop[0], boxes[:, 0])
    iy0 = np.maximum(crop[1], boxes[:, 1])
    ix1 = np.minimum(crop[2], boxes[:, 2])
    iy1 = np.minimum(crop[3], boxes[:, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return np.where(area_b > 0, inter / np.maximum(area_b, 1e-12), 0.0)


def _update_labels(label, crop, min_eject_coverage):
    """Transform labels into crop coordinates; eject boxes whose retained
    coverage falls below min_eject_coverage. Returns None if no box survives.
    """
    label = np.asarray(label, np.float32)
    cov = _coverage(crop, label[:, 1:5])
    keep = cov >= min_eject_coverage
    if not keep.any():
        return None
    out = label[keep].copy()
    cw, ch = crop[2] - crop[0], crop[3] - crop[1]
    out[:, 1] = np.clip((out[:, 1] - crop[0]) / cw, 0, 1)
    out[:, 2] = np.clip((out[:, 2] - crop[1]) / ch, 0, 1)
    out[:, 3] = np.clip((out[:, 3] - crop[0]) / cw, 0, 1)
    out[:, 4] = np.clip((out[:, 4] - crop[1]) / ch, 0, 1)
    return out


class DetRandomCropAug(DetAugmenter):
    """SSD-style constrained random crop (ref: detection.py:DetRandomCropAug).

    Samples a crop whose IoU with at least one box exceeds
    ``min_object_covered``; boxes covered below ``min_eject_coverage`` are
    dropped, survivors re-projected into crop coordinates.
    """

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50, rng=None):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.rng = rng or np.random

    def __call__(self, src, label):
        a = _asnp(src)
        h, w = a.shape[:2]
        label = np.asarray(label, np.float32)
        for _ in range(self.max_attempts):
            area = self.rng.uniform(*self.area_range)
            ratio = self.rng.uniform(*self.aspect_ratio_range)
            cw = np.sqrt(area * ratio)
            ch = np.sqrt(area / ratio)
            if cw > 1 or ch > 1:
                continue
            x0 = self.rng.uniform(0, 1 - cw)
            y0 = self.rng.uniform(0, 1 - ch)
            crop = np.array([x0, y0, x0 + cw, y0 + ch], np.float32)
            ious = _box_iou_1many(crop, label[:, 1:5])
            if ious.max(initial=0.0) < self.min_object_covered:
                continue
            new_label = _update_labels(label, crop, self.min_eject_coverage)
            if new_label is None:
                continue
            px0, py0 = int(x0 * w), int(y0 * h)
            pw, ph = max(1, int(cw * w)), max(1, int(ch * h))
            return _wrap(a[py0:py0 + ph, px0:px0 + pw].copy()), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion pad (ref: detection.py:DetRandomPadAug): place the
    image inside a larger canvas filled with ``pad_val``; boxes shrink
    accordingly."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127), rng=None):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=list(pad_val))
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = np.asarray(pad_val)
        self.rng = rng or np.random

    def __call__(self, src, label):
        a = _asnp(src)
        h, w = a.shape[:2]
        label = np.asarray(label, np.float32)
        for _ in range(self.max_attempts):
            area = self.rng.uniform(*self.area_range)
            ratio = self.rng.uniform(*self.aspect_ratio_range) * (w / h)
            nh = int(np.sqrt(h * w * area / ratio))
            nw = int(nh * ratio)
            if nh < h or nw < w:
                continue
            x0 = self.rng.randint(0, nw - w + 1)
            y0 = self.rng.randint(0, nh - h + 1)
            canvas = np.empty((nh, nw) + a.shape[2:], a.dtype)
            canvas[...] = self.pad_val.astype(a.dtype)
            canvas[y0:y0 + h, x0:x0 + w] = a
            out = label.copy()
            out[:, 1] = (out[:, 1] * w + x0) / nw
            out[:, 2] = (out[:, 2] * h + y0) / nh
            out[:, 3] = (out[:, 3] * w + x0) / nw
            out[:, 4] = (out[:, 4] * h + y0) / nh
            return _wrap(canvas), out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127), rng=None):
    """Build the standard detection augmenter list
    (ref: detection.py:CreateDetAugmenter)."""
    from . import image as I

    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(I.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (min(area_range[0], 1.0),
                                 min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts, rng=rng)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop, rng=rng))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0),
                               max(area_range[1], 1.0)),
                              max_attempts, pad_val, rng=rng)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad, rng=rng))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5, rng=rng))
    auglist.append(DetBorrowAug(I.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(I.CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            I.ColorJitterAug(brightness, contrast, saturation, rng=rng)))
    if hue:
        auglist.append(DetBorrowAug(I.HueJitterAug(hue, rng=rng)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(I.LightingAug(pca_noise, rng=rng)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(I.RandomGrayAug(rand_gray, rng=rng)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(I.ColorNormalizeAug(mean, std)))
    return auglist
