"""Image utilities (counterpart of ``mxnet_tpu/image.py``; ref:
python/mxnet/image/image.py).

Decoding, resizing, cropping and every augmenter run on the host, in
numpy, and return NDArrays on ``mx.cpu()`` whatever the current context
is: an iterator or a ``DataLoader`` makes one device copy a batch
(ROADMAP C.2, the host rule). The JAX package returns them on its default
device.

Decode route: PIL, as in the JAX package, fixed once a process by what is
installed (``decode_route()``); a process without PIL raises, as the JAX
package does. Every decode is counted in ``counters``.

Resize follows ``jax.image.resize``: bilinear (any ``interp`` but 0) is
its triangle kernel with antialiasing when shrinking, the weights made in
float32 as it makes them and applied in float64, rounded to float32;
nearest (``interp=0``) takes its floor((i + 0.5) * in / out) indices in
float32. A uint8 image comes back clipped and truncated to uint8. Where
the JAX package's float32 sum and this one land on either side of an
integer, a uint8 pixel parts by one level (the tests hold the share).
"""
from __future__ import annotations

import io as _io
import json
import os

import numpy as np
import torch

from .ndarray import _NARROW, NDArray

try:
    from PIL import Image as _PIL
except ImportError:  # a machine without PIL has no decoder
    _PIL = None

__all__ = ["imdecode", "imread", "imread_np", "imresize", "imresize_np",
           "fixed_crop", "center_crop", "random_crop", "color_normalize",
           "resize_short", "scale_down", "random_size_crop", "Augmenter",
           "SequentialAug", "RandomOrderAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "ColorNormalizeAug", "CreateAugmenter", "ImageIter",
           "decode_route", "counters", "DetAugmenter", "DetBorrowAug",
           "DetRandomSelectAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug", "CreateDetAugmenter"]

# decodes a route took, this process
counters = {"decode_pil": 0}

def decode_route():
    """The JPEG decoder of this process: ``"pil"``, or None where PIL is
    not installed (then ``imdecode`` raises)."""
    return "pil" if _PIL is not None else None


def _host(a):
    """An NDArray on the CPU over a fresh numpy array (float64 as float32,
    int64 as int32, as ``nd.array`` narrows)."""
    a = np.asarray(a)
    a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
    if not (a.flags.c_contiguous and a.flags.owndata):
        a = np.array(a, order="C", copy=True)
    return NDArray(torch.from_numpy(a))


def _asnp(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def _decode_pil(buf, flag):
    if _PIL is None:
        raise RuntimeError("PIL unavailable for imdecode: no JPEG decoder "
                           "on this machine")
    img = _PIL.open(_io.BytesIO(buf))
    a = np.asarray(img.convert("RGB" if flag else "L"))
    counters["decode_pil"] += 1
    return a[:, :, None] if a.ndim == 2 else a


def imread_np(path, flag=1):
    """HWC uint8 numpy of an image file (``.npy`` loads as it is)."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        return _decode_pil(f.read(), flag)


def imread(path, flag=1, to_rgb=True):
    return _host(imread_np(path, flag))


def imdecode_np(buf, flag=1):
    """HWC uint8 numpy of an encoded image (RGB, or one channel at
    ``flag=0``)."""
    return _decode_pil(bytes(buf), flag)


def imdecode(buf, flag=1, to_rgb=True):
    return _host(imdecode_np(buf, flag))


def _weight_mat(m, n):
    """``jax.image.resize``'s (m, n) bilinear weights in float32: the
    triangle kernel widened by in/out when shrinking, each column
    normalized, columns sampling outside the input zeroed. XLA's fused
    reduction sums a column in its own order: about 0.1% of the weights
    part from its by an ulp."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n / m)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    # XLA folds the division into a product with the reciprocal
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(m) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _nearest_index(m, n):
    """floor((i + 0.5) * in / out) in float32 as XLA computes it: the
    constant folded to in * (1 / out) (plain (i + 0.5) * in / out parts
    from it at 20 -> 45 rows)."""
    f32 = np.float32
    off = (np.arange(n, dtype=f32) + f32(0.5)) * (f32(m) * (f32(1) / f32(n)))
    return np.floor(off).astype(np.int64)


def imresize_np(img, w, h, interp=1):
    """``img`` (H, W[, C]) resized to (h, w) as ``jax.image.resize`` does;
    uint8 in, uint8 out (clipped, truncated), else float32."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    if not interp:
        out = img
        if h != H:
            out = out[_nearest_index(H, h)]
        if w != W:
            out = out[:, _nearest_index(W, w)]
        out = out.astype(np.float32)
    else:
        out = img.astype(np.float64)
        if h != H:
            out = np.tensordot(_weight_mat(H, h).astype(np.float64), out,
                               axes=([0], [0]))
        if w != W:
            out = np.moveaxis(np.tensordot(
                _weight_mat(W, w).astype(np.float64), out, axes=([0], [1])),
                0, 1)
        out = out.astype(np.float32)
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(out)


def imresize(src, w, h, interp=1):
    return _host(imresize_np(_asnp(src), w, h, interp))


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    a = _asnp(src)
    out = a[y0:y0 + h, x0:x0 + w]
    if size is not None:
        out = imresize_np(out, size[0], size[1], interp)
    return _host(out)


def center_crop(src, size, interp=1):
    a = _asnp(src)
    h, w = a.shape[:2]
    tw, th = size
    x0 = max((w - tw) // 2, 0)
    y0 = max((h - th) // 2, 0)
    return fixed_crop(a, x0, y0, min(tw, w), min(th, h), size, interp), \
        (x0, y0, tw, th)


def random_crop(src, size, interp=1):
    a = _asnp(src)
    h, w = a.shape[:2]
    tw, th = size
    x0 = np.random.randint(0, max(w - tw, 0) + 1)
    y0 = np.random.randint(0, max(h - th, 0) + 1)
    return fixed_crop(a, x0, y0, min(tw, w), min(th, h), size, interp), \
        (x0, y0, tw, th)


def color_normalize(src, mean, std=None):
    a = _asnp(src).astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        a = a / np.asarray(std, np.float32)
    return _host(a)


def resize_short(src, size, interp=2):
    """The shorter edge to ``size``, the aspect kept (ref:
    image.py:resize_short)."""
    a = _asnp(src)
    h, w = a.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return _host(imresize_np(a, new_w, new_h, interp))


def scale_down(src_size, size):
    """``size`` scaled down to fit in ``src_size``, the aspect kept."""
    w, h = src_size
    sw, sh = size
    if sh > h:
        sw, sh = sw * h // sh, h
    if sw > w:
        sw, sh = w, sh * w // sw
    return sw, sh


def random_size_crop(src, size, area, ratio, interp=2, rng=None):
    """A crop of ``area`` fraction and ``ratio`` aspect, resized to
    ``size`` (ten tries, then a center crop)."""
    rng = rng or np.random
    a = _asnp(src)
    h, w = a.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = rng.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(rng.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w + 1)
            y0 = rng.randint(0, h - new_h + 1)
            return fixed_crop(a, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(a, size, interp)


# ---------------------------------------------------------------------------
# Augmenters (ref: image.py's Augmenter family): host numpy, each random one
# drawing from ``rng`` (numpy's global state by default), in the JAX
# package's order, so one seed gives one image in both packages.
# ---------------------------------------------------------------------------

def _getstate(obj):
    # numpy's global state is a module: pickle it by name, so a process
    # worker's augmenter draws from its own process's global state
    d = dict(obj.__dict__)
    if d.get("rng") is np.random:
        d["rng"] = "np.random"
    return d


def _setstate(obj, d):
    if d.get("rng") == "np.random":
        d["rng"] = np.random
    obj.__dict__.update(d)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    __getstate__ = _getstate
    __setstate__ = _setstate

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts, rng=None):
        super().__init__()
        self.ts = ts
        self.rng = rng or np.random

    def __call__(self, src):
        for i in self.rng.permutation(len(self.ts)):
            src = self.ts[int(i)](src)
        return src


class ResizeAug(Augmenter):
    """The shorter edge to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """To (w, h), the aspect not kept."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return _host(imresize_np(_asnp(src), self.size[0], self.size[1],
                                 self.interp))


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2, rng=None):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src)
        h, w = a.shape[:2]
        tw, th = self.size
        x0 = self.rng.randint(0, max(w - tw, 0) + 1)
        y0 = self.rng.randint(0, max(h - th, 0) + 1)
        return fixed_crop(a, x0, y0, min(tw, w), min(th, h), self.size,
                          self.interp)


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2, rng=None):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = size, area, ratio, \
            interp
        self.rng = rng or np.random

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp, rng=self.rng)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(_asnp(src), self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src)
        if self.rng.random_sample() < self.p:
            a = a[:, ::-1]
        return _host(a)


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_asnp(src).astype(self.typ))


class BrightnessJitterAug(Augmenter):
    """src * (1 + U(-b, b))."""

    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self.brightness = brightness
        self.rng = rng or np.random

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.brightness, self.brightness)
        return _host(_asnp(src).astype(np.float32) * alpha)


_GRAY_COEF = np.array([0.299, 0.587, 0.114], np.float32)


class ContrastJitterAug(Augmenter):
    """A blend with the mean gray level."""

    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        alpha = 1.0 + self.rng.uniform(-self.contrast, self.contrast)
        gray = (a * _GRAY_COEF).sum(axis=-1).mean() * (1.0 - alpha)
        return _host(a * alpha + gray)


class SaturationJitterAug(Augmenter):
    """A blend with each pixel's gray."""

    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        alpha = 1.0 + self.rng.uniform(-self.saturation, self.saturation)
        gray = (a * _GRAY_COEF).sum(axis=-1, keepdims=True) * (1.0 - alpha)
        return _host(a * alpha + gray)


_TYIQ = np.array([[0.299, 0.587, 0.114],
                  [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]], np.float32)
_ITYIQ = np.array([[1.0, 0.956, 0.621],
                   [1.0, -0.272, -0.647],
                   [1.0, -1.107, 1.705]], np.float32)


class HueJitterAug(Augmenter):
    """A hue rotation in YIQ space."""

    def __init__(self, hue, rng=None):
        super().__init__(hue=hue)
        self.hue = hue
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        alpha = self.rng.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        return _host(a @ (_ITYIQ @ bt @ _TYIQ).T)


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitter in a random order."""

    def __init__(self, brightness, contrast, saturation, rng=None):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness, rng=rng))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast, rng=rng))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation, rng=rng))
        super().__init__(ts, rng=rng)


# ImageNet's PCA eigenvalues and eigenvectors (AlexNet's lighting noise)
_IMAGENET_EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
_IMAGENET_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]], np.float32)


class LightingAug(Augmenter):
    """PCA lighting noise."""

    def __init__(self, alphastd, eigval=None, eigvec=None, rng=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _IMAGENET_EIGVAL if eigval is None \
            else np.asarray(eigval, np.float32)
        self.eigvec = _IMAGENET_EIGVEC if eigvec is None \
            else np.asarray(eigvec, np.float32)
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        alpha = self.rng.normal(0, self.alphastd, size=(3,)).astype(
            np.float32)
        return _host(a + self.eigvec @ (self.eigval * alpha))


_GRAY_MAT = np.array([[0.21, 0.21, 0.21],
                      [0.72, 0.72, 0.72],
                      [0.07, 0.07, 0.07]], np.float32)


class RandomGrayAug(Augmenter):
    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng or np.random

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        if self.rng.random_sample() < self.p:
            a = a @ _GRAY_MAT
        return _host(a)


class ColorNormalizeAug(Augmenter):
    """(src - mean) / std."""

    def __init__(self, mean, std):
        super().__init__(mean=mean if mean is None else list(np.ravel(mean)),
                         std=std if std is None else list(np.ravel(std)))
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def __call__(self, src):
        a = _asnp(src).astype(np.float32)
        if self.mean is not None:
            a = a - self.mean
        if self.std is not None:
            a = a / self.std
        return _host(a)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2, rng=None):
    """The standard augmenter list, ending in float32 HWC (the iterator
    makes it CHW)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method, rng=rng))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method, rng=rng))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng=rng))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation,
                                      rng=rng))
    if hue:
        auglist.append(HueJitterAug(hue, rng=rng))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, rng=rng))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray, rng=rng))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


from .image_det import (  # noqa: E402,F401  (the detection augmenters)
    CreateDetAugmenter, DetAugmenter, DetBorrowAug, DetHorizontalFlipAug,
    DetRandomCropAug, DetRandomPadAug, DetRandomSelectAug,
)


class ImageIter:
    """Augmenting image iterator (ref: image.py:ImageIter) over a packed
    ``path_imgrec`` or a ``.lst``/``imglist`` with ``path_root``; yields
    NCHW float32 batches, one device copy each, on the current context.
    A partial last batch is dropped."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 imglist=None, shuffle=False, aug_list=None,
                 data_name="data", label_name="softmax_label",
                 path_imgidx=None, rng=None, **kwargs):
        from .io import DataDesc

        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise ValueError("data_shape must be (channels, H, W)")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._rng = rng or np.random.RandomState(0)
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape, rng=self._rng,
                                             **kwargs))
        self._shuffle = shuffle
        self._rec = None
        if path_imgrec is not None:
            from .recordio import RecordSource

            self._rec = RecordSource(path_imgrec, path_imgidx)
            self._n = len(self._rec)
        else:
            entries = []
            if path_imglist is not None:
                with open(path_imglist) as f:
                    for lineno, line in enumerate(f, 1):
                        if not line.strip():
                            continue
                        parts = line.strip().split("\t")
                        if len(parts) < 3:
                            raise ValueError(
                                "%s:%d: malformed .lst line (need "
                                "index\\tlabel...\\tpath, tab-separated): %r"
                                % (path_imglist, lineno, line.rstrip()))
                        entries.append((np.asarray(parts[1:-1], np.float32),
                                        parts[-1]))
            elif imglist is not None:
                for item in imglist:
                    entries.append((np.asarray(item[:-1],
                                               np.float32).ravel(), item[-1]))
            else:
                raise ValueError("one of path_imgrec, path_imglist, imglist "
                                 "is required")
            self._root = path_root
            self._entries = entries
            self._n = len(entries)
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        lshape = (batch_size,) if label_width == 1 else (batch_size,
                                                         label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._order = np.arange(self._n)
        self.reset()

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def _read(self, i):
        flag = 1 if self.data_shape[0] == 3 else 0
        if self._rec is not None:
            header, img_bytes = self._rec.read(i)
            img = imdecode_np(img_bytes, flag=flag)
            label = np.asarray(header.label, np.float32).ravel()
        else:
            label, relpath = self._entries[i]
            img = imread_np(os.path.join(self._root, relpath), flag=flag)
        if label.size < self.label_width:
            raise ValueError(
                "record %d carries %d label value(s) but label_width=%d"
                % (i, label.size, self.label_width))
        return img, label

    def iter_next(self):
        return self._cursor + self.batch_size <= self._n

    def getpad(self):
        return 0

    def getindex(self):
        return None

    def next(self):
        from .io import DataBatch
        from .ndarray import array

        if not self.iter_next():
            raise StopIteration
        datas, labels = [], []
        for i in self._order[self._cursor:self._cursor + self.batch_size]:
            img, label = self._read(i)
            for aug in self.auglist:
                img = aug(img)
            datas.append(_asnp(img).transpose(2, 0, 1))
            labels.append(label[0] if self.label_width == 1
                          else label[:self.label_width])
        self._cursor += self.batch_size
        return DataBatch([array(np.stack(datas))],
                         [array(np.asarray(labels, np.float32))],
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def __getattr__(name):
    if name == "ImageDetIter":
        # the upstream name of the detection iterator (ref: image/
        # detection.py:ImageDetIter), the record-backed one in io
        from .io import ImageDetRecordIter

        return ImageDetRecordIter
    raise AttributeError(name)
