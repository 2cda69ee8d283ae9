"""Vision transforms (counterpart of ``mxnet_tpu/gluon/data/vision/
transforms.py``; ref: python/mxnet/gluon/data/vision/transforms.py).

Per-sample host numpy, returning NDArrays on ``mx.cpu()`` whatever the
current context is (ROADMAP C.2, the host rule): the ``DataLoader`` makes
one device copy a batch. The random transforms draw from numpy's global
state (the jitter ones from ``rng``), in the JAX package's order.
"""
from __future__ import annotations

import numpy as np

from ....image import _host as array
from ....ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "CropResize", "RandomCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting", "RandomGray"]


def _np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class Compose:
    def __init__(self, transforms):
        self._transforms = transforms

    def __call__(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, x):
        return array(_np(x).astype(self._dtype))


class ToTensor:
    """HWC uint8 [0,255] → CHW float32 [0,1] (ref: transforms.py:ToTensor)."""

    def __call__(self, x):
        a = _np(x).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        return array(a)


class Normalize:
    def __init__(self, mean=0.0, std=1.0):
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, x):
        return array((_np(x) - self._mean) / self._std)


def _resize(img, size):
    from ....image import imresize_np

    return imresize_np(img, size[0], size[1])


class Resize:
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size

    def __call__(self, x):
        return array(_resize(_np(x), self._size))


class CenterCrop:
    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size

    def __call__(self, x):
        a = _np(x)
        h, w = a.shape[:2]
        tw, th = self._size
        x0 = max((w - tw) // 2, 0)
        y0 = max((h - th) // 2, 0)
        return array(a[y0:y0 + th, x0:x0 + tw])


class CropResize:
    """Crop the region (x, y, width, height) and optionally resize to ``size``
    (ref: gluon/data/vision/transforms.py CropResize)."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        self._box = (x, y, width, height)
        self._size = ((size, size) if isinstance(size, int) else size) \
            if size is not None else None

    def __call__(self, img):
        a = _np(img)
        x0, y0, w, h = self._box
        a = a[y0:y0 + h, x0:x0 + w]
        if self._size is not None:
            a = _resize(a, self._size)
        return array(a)


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation=1):
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def __call__(self, x):
        a = _np(x)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            nw = int(round(np.sqrt(target_area * aspect)))
            nh = int(round(np.sqrt(target_area / aspect)))
            if nw <= w and nh <= h:
                x0 = np.random.randint(0, w - nw + 1)
                y0 = np.random.randint(0, h - nh + 1)
                crop = a[y0:y0 + nh, x0:x0 + nw]
                return array(_resize(crop, self._size))
        return array(_resize(a, self._size))


class RandomFlipLeftRight:
    def __call__(self, x):
        a = _np(x)
        if np.random.rand() < 0.5:
            a = a[:, ::-1].copy()
        return array(a)


class RandomFlipTopBottom:
    def __call__(self, x):
        a = _np(x)
        if np.random.rand() < 0.5:
            a = a[::-1].copy()
        return array(a)


def _jitter_transform(name, aug_name):
    """Transform class delegating to a mx.image augmenter
    (ref: transforms.py Random* — upstream also shares the augmenter impls)."""

    def __init__(self, value, rng=None):
        from .... import image as _image
        self._aug = getattr(_image, aug_name)(value, rng=rng)

    def __call__(self, x):
        return self._aug(x)

    return type(name, (), {"__init__": __init__, "__call__": __call__,
                           "__doc__": "Delegates to image.%s." % aug_name})


RandomBrightness = _jitter_transform("RandomBrightness", "BrightnessJitterAug")
RandomContrast = _jitter_transform("RandomContrast", "ContrastJitterAug")
RandomSaturation = _jitter_transform("RandomSaturation", "SaturationJitterAug")
RandomHue = _jitter_transform("RandomHue", "HueJitterAug")
RandomLighting = _jitter_transform("RandomLighting", "LightingAug")
RandomGray = _jitter_transform("RandomGray", "RandomGrayAug")


class RandomColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None):
        from ....image import ColorJitterAug, HueJitterAug
        self._aug = ColorJitterAug(brightness, contrast, saturation, rng=rng)
        self._hue = HueJitterAug(hue, rng=rng) if hue else None

    def __call__(self, x):
        x = self._aug(x)
        return self._hue(x) if self._hue is not None else x


class RandomCrop:
    """(ref: transforms.py:RandomCrop) random (th, tw) crop, optionally
    zero-padding all four sides first (the CIFAR pad-4-crop-32 recipe)."""

    def __init__(self, size, pad=None, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._interp = interpolation

    def __call__(self, x):
        a = _np(x)
        if self._pad:
            p = self._pad
            a = np.pad(a, ((p, p), (p, p)) + ((0, 0),) * (a.ndim - 2))
        h, w = a.shape[:2]
        tw, th = self._size
        if h < th or w < tw:
            # upstream upscales so the crop always has the requested size
            a = _resize(a, (max(w, tw), max(h, th)))
            h, w = a.shape[:2]
        y0 = np.random.randint(0, h - th + 1)
        x0 = np.random.randint(0, w - tw + 1)
        return array(a[y0:y0 + th, x0:x0 + tw])
