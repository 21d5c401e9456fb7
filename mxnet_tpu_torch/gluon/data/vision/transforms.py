"""Vision transforms (≙ ``gluon/data/vision/transforms``): numpy on
the host, HWC, drawing from numpy's global generator as the
reference's; ``Resize`` is the reference's numpy nearest."""
from __future__ import annotations

import numpy as onp

__all__ = ["Compose", "ToTensor", "Normalize", "Cast", "Resize",
           "RandomFlipLeftRight", "RandomCrop"]


class Compose:
    def __init__(self, transforms):
        self._transforms = transforms

    def __call__(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class ToTensor:
    """To float32 in [0, 1] (divided by 255 where the values exceed
    1.5), keeping HWC as the reference's does."""

    def __call__(self, x):
        x = onp.asarray(x, dtype="float32")
        if x.max() > 1.5:
            x = x / 255.0
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0):
        self._mean = onp.asarray(mean, dtype="float32")
        self._std = onp.asarray(std, dtype="float32")

    def __call__(self, x):
        return (onp.asarray(x, dtype="float32") - self._mean) / self._std


class Cast:
    def __init__(self, dtype="float32"):
        self._dtype = dtype

    def __call__(self, x):
        return onp.asarray(x).astype(self._dtype)


class Resize:
    def __init__(self, size, keep_ratio=False, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        x = onp.asarray(x)
        h, w = x.shape[0], x.shape[1]
        th, tw = self._size
        ri = (onp.arange(th) * (h / th)).astype(int).clip(0, h - 1)
        ci = (onp.arange(tw) * (w / tw)).astype(int).clip(0, w - 1)
        return x[ri][:, ci]


class RandomFlipLeftRight:
    def __call__(self, x):
        if onp.random.rand() < 0.5:
            return onp.asarray(x)[:, ::-1].copy()
        return onp.asarray(x)


class RandomCrop:
    def __init__(self, size, pad=None):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def __call__(self, x):
        x = onp.asarray(x)
        if self._pad:
            p = self._pad
            x = onp.pad(x, ((p, p), (p, p), (0, 0)), mode="constant")
        h, w = x.shape[0], x.shape[1]
        th, tw = self._size
        i = onp.random.randint(0, h - th + 1)
        j = onp.random.randint(0, w - tw + 1)
        return x[i:i + th, j:j + tw]


class CenterCrop:
    """≙ transforms.CenterCrop (size (w, h) like the reference)."""

    def __init__(self, size, interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        from ....image import center_crop
        return center_crop(onp.asarray(x), self._size)[0]


class RandomResizedCrop:
    """≙ transforms.RandomResizedCrop."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def __call__(self, x):
        from ....image import random_size_crop
        return random_size_crop(onp.asarray(x), self._size, self._scale,
                                self._ratio)[0]


class RandomBrightness:
    def __init__(self, brightness):
        from ....image import BrightnessJitterAug
        self._aug = BrightnessJitterAug(brightness)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomContrast:
    def __init__(self, contrast):
        from ....image import ContrastJitterAug
        self._aug = ContrastJitterAug(contrast)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomSaturation:
    def __init__(self, saturation):
        from ....image import SaturationJitterAug
        self._aug = SaturationJitterAug(saturation)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomHue:
    def __init__(self, hue):
        from ....image import HueJitterAug
        self._aug = HueJitterAug(hue)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomColorJitter:
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        from ....image import ColorJitterAug, HueJitterAug
        self._aug = ColorJitterAug(brightness, contrast, saturation)
        self._hue = HueJitterAug(hue) if hue else None

    def __call__(self, x):
        x = self._aug(onp.asarray(x))
        if self._hue is not None:
            x = self._hue(x)
        return x


class RandomLighting:
    def __init__(self, alpha):
        from ....image import LightingAug
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        self._aug = LightingAug(alpha, eigval, eigvec)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomGray:
    def __init__(self, p=0.5):
        from ....image import RandomGrayAug
        self._aug = RandomGrayAug(p)

    def __call__(self, x):
        return self._aug(onp.asarray(x))


class RandomFlipTopBottom:
    def __init__(self, p=0.5):
        self._p = p

    def __call__(self, x):
        if onp.random.rand() < self._p:
            return onp.asarray(x)[::-1].copy()
        return onp.asarray(x)


__all__ += ["CenterCrop", "RandomResizedCrop", "RandomBrightness",
            "RandomContrast", "RandomSaturation", "RandomHue",
            "RandomColorJitter", "RandomLighting", "RandomGray",
            "RandomFlipTopBottom"]
