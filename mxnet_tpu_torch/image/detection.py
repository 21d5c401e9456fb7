"""mx.image.detection for the port — the detection augmenters and
``ImageDetIter`` (≙ ``mxnet_tpu/image/detection.py``).  Labels are
(N, 5+) arrays of [class_id, xmin, ymin, xmax, ymax, ...] with
coordinates normalized to [0, 1], as the reference's.  Randomness comes
from Python's ``random`` (or a sample's ``image.sample_rng``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import (_py, imread, imresize, fixed_crop, CreateAugmenter,
               ImageIter)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Image+label transform (≙ detection.py DetAugmenter)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter, passing labels through."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _py().random() < self.p:
            src = np.asarray(src)[:, ::-1].copy()
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping boxes whose center survives (simplified IoU
    criteria vs the reference's min_object_covered sampling loop)."""

    def __init__(self, min_crop_size=0.5, max_attempts=10):
        self.min_crop_size = min_crop_size
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[:2]
        for _ in range(self.max_attempts):
            scale = _py().uniform(self.min_crop_size, 1.0)
            cw, ch = int(w * scale), int(h * scale)
            x0 = _py().randint(0, w - cw)
            y0 = _py().randint(0, h - ch)
            cx = (label[:, 1] + label[:, 3]) / 2 * w
            cy = (label[:, 2] + label[:, 4]) / 2 * h
            keep = ((cx >= x0) & (cx < x0 + cw) &
                    (cy >= y0) & (cy < y0 + ch))
            if keep.any():
                out = fixed_crop(src, x0, y0, cw, ch)
                lab = label[keep].copy()
                lab[:, 1] = np.clip((lab[:, 1] * w - x0) / cw, 0, 1)
                lab[:, 3] = np.clip((lab[:, 3] * w - x0) / cw, 0, 1)
                lab[:, 2] = np.clip((lab[:, 2] * h - y0) / ch, 0, 1)
                lab[:, 4] = np.clip((lab[:, 4] * h - y0) / ch, 0, 1)
                return out, lab
        return src, label


class DetRandomPadAug(DetAugmenter):
    def __init__(self, max_pad_scale=2.0, fill=127):
        self.max_pad_scale = max_pad_scale
        self.fill = fill

    def __call__(self, src, label):
        h, w = src.shape[:2]
        scale = _py().uniform(1.0, self.max_pad_scale)
        nw, nh = int(w * scale), int(h * scale)
        x0 = _py().randint(0, nw - w)
        y0 = _py().randint(0, nh - h)
        canvas = np.full((nh, nw) + src.shape[2:], self.fill, src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        lab = label.copy()
        lab[:, 1] = (lab[:, 1] * w + x0) / nw
        lab[:, 3] = (lab[:, 3] * w + x0) / nw
        lab[:, 2] = (lab[:, 2] * h + y0) / nh
        lab[:, 4] = (lab[:, 4] * h + y0) / nh
        return canvas, lab


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       inter_method=2, **kwargs):
    """≙ detection.py CreateDetAugmenter (subset of knobs)."""
    auglist = []
    if rand_crop > 0:
        auglist.append(DetRandomCropAug())
    if rand_pad > 0:
        auglist.append(DetRandomPadAug())
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # borrow plain image augs for resize/color/normalize
    borrow = CreateAugmenter(data_shape, resize=resize, mean=mean, std=std,
                             brightness=brightness, contrast=contrast,
                             saturation=saturation,
                             inter_method=inter_method)
    auglist.extend(DetBorrowAug(a) for a in borrow)
    return auglist


class ImageDetIter(ImageIter):
    """≙ detection.py ImageDetIter — batches with (B, max_objs, 5) labels."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 imglist=None, path_root="", shuffle=False, aug_list=None,
                 max_objects=16, **kwargs):
        self.max_objects = max_objects
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        self._det_augs = aug_list
        super().__init__(batch_size, data_shape, label_width=5,
                         path_imgrec=path_imgrec, imglist=imglist,
                         path_root=path_root, shuffle=shuffle, aug_list=[])

    @property
    def provide_label(self):
        return [self._io.DataDesc(
            "label", (self.batch_size, self.max_objects, 5))]

    def next(self):
        n = len(self.seq)
        if self._cursor >= n:
            raise StopIteration
        H, W, C = self.data_shape
        data = np.zeros((self.batch_size, H, W, C), np.float32)
        label = np.full((self.batch_size, self.max_objects, 5), -1.0,
                        np.float32)
        filled = 0
        while filled < self.batch_size and self._cursor < n:
            idx = self.seq[self._cursor]
            self._cursor += 1
            lab, path = self.imglist[idx]
            img = imread(path if not self.path_root else
                         f"{self.path_root}/{path}")
            lab = np.asarray(lab, np.float32).reshape(-1, 5)
            for aug in self._det_augs:
                img, lab = aug(img, lab)
            img = np.asarray(imresize(img, W, H), np.float32)
            data[filled] = img.reshape(H, W, C)
            k = min(len(lab), self.max_objects)
            label[filled, :k] = lab[:k]
            filled += 1
        pad = self.batch_size - filled
        return self._io.DataBatch(data=[torch.from_numpy(data)],
                                  label=[torch.from_numpy(label)], pad=pad)
