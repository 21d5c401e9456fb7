"""mx.image for the port — image loading and augmentation (≙
``mxnet_tpu/image/__init__.py``): ``imdecode``, ``imresize``, the crop
helpers, the ``Augmenter`` family, ``CreateAugmenter`` and ``ImageIter``.

Decode, encode and resize run in the port's host decode stage
(``csrc_host/dataio.cc``, see ``_host_build``), one ctypes call each,
which drops the GIL: libjpeg where the machine has it, nvJPEG on a card
whose host has no libjpeg, zlib for PNG.  A missing library raises with
its name.  ``imresize`` is OpenCV's ``cv::resize`` in its fixed-point
form (nearest, linear, cubic).  Arrays are numpy HWC until a batch,
which becomes a ``torch`` tensor on the host (NHWC, as the reference's).

Randomness: an augmenter draws from Python's ``random`` and numpy's
global state, as the reference's do, unless :func:`sample_rng` has set
a sample's own generators on this thread; ``ImageIter`` sets them from
the per-sample seed it draws serially, so a sample's augmentation does
not depend on the thread that runs it.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import random as pyrandom
import threading

import numpy as np
import torch

from .. import recordio as _recordio

__all__ = [
    "imread", "imdecode", "imencode", "imresize", "copyMakeBorder",
    "resize_short", "fixed_crop", "random_crop", "center_crop",
    "random_size_crop", "color_normalize", "sample_rng",
    "Augmenter", "SequentialAug", "RandomOrderAug", "ResizeAug",
    "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
    "HorizontalFlipAug", "CastAug", "BrightnessJitterAug",
    "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
    "ColorJitterAug", "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
    "CreateAugmenter", "ImageIter",
]

# ------------------------------------------------------------ randomness

_local = threading.local()


def _py():
    """This sample's ``random.Random``, else the ``random`` module."""
    return getattr(_local, "py", None) or pyrandom


def _np():
    """This sample's ``numpy.random.RandomState``, else numpy's global."""
    return getattr(_local, "np", None) or np.random


@contextlib.contextmanager
def sample_rng(seed):
    """Draw this thread's augmentation randomness from
    ``random.Random(seed)`` and ``numpy.random.RandomState(seed)``: the
    streams the reference's globals give after ``random.seed(seed)`` and
    ``numpy.random.seed(seed)``."""
    prev = getattr(_local, "py", None), getattr(_local, "np", None)
    _local.py = pyrandom.Random(seed)
    _local.np = np.random.RandomState(seed)
    try:
        yield
    finally:
        _local.py, _local.np = prev


# ---------------------------------------------------------------- codec

def _stage():
    from .. import _host_build
    return _host_build


def _take(L, ptr, n):
    """Copy ``n`` bytes the stage malloc'd into numpy and free them."""
    try:
        return np.frombuffer(ctypes.string_at(ptr, n), np.uint8).copy()
    finally:
        L.mxt_free(ptr)


def imdecode(buf, to_rgb=True, flag=1):
    """Decode an encoded image (JPEG or PNG) to an HWC uint8 array (≙
    ``mx.image.imdecode``): RGB by default, BGR with ``to_rgb=False``;
    ``flag=0`` gives a gray HW array, ``flag=-1`` the stream's own
    channels."""
    hb = _stage()
    L = hb.lib()
    data = np.frombuffer(bytes(buf), np.uint8)
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = L.mxt_imdecode(data.ctypes.data, data.size, int(flag),
                        ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"imdecode: {L.mxt_last_error().decode()}")
    img = _take(L, out, h.value * w.value * c.value)
    if c.value == 1:
        return img.reshape(h.value, w.value)
    img = img.reshape(h.value, w.value, c.value)
    if not to_rgb and c.value >= 3:
        img = np.ascontiguousarray(img[:, :, [2, 1, 0] +
                                       list(range(3, c.value))])
    return img


def imencode(img, img_fmt=".jpg", quality=95, progressive=False):
    """Encode an HWC (or HW) uint8 RGB array as JPEG (``quality``,
    baseline or ``progressive``) or PNG; → bytes.  The stage's encoder:
    libjpeg, or nvJPEG where the build decodes with it."""
    arr = np.ascontiguousarray(np.asarray(img))
    if arr.dtype != np.uint8:
        raise TypeError(f"imencode takes uint8 images, got {arr.dtype}")
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    if img_fmt in (".jpg", ".jpeg"):
        fmt, q = (2 if progressive else 0), int(quality)
    elif img_fmt == ".png":
        fmt, q = 1, 3               # OpenCV's default PNG compression
    else:
        raise ValueError(f"imencode: unsupported format {img_fmt!r}")
    hb = _stage()
    L = hb.lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    hb.check(L.mxt_imencode(arr.ctypes.data, h, w, c, fmt, q,
                            ctypes.byref(out), ctypes.byref(n)))
    return _take(L, out, n.value).tobytes()


def decoder_info():
    """The decode stage's libraries: ``{"jpeg": "libjpeg" | "nvjpeg" |
    "none", "jpeg_version", "png", "zlib"}``."""
    return _stage().info()


def imread(filename, to_rgb=True, flag=1):
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def imresize(src, w, h, interp=1):
    """Resize to ``w`` x ``h`` (≙ ``cv2.resize``): ``interp`` 0 nearest,
    1 linear, 2 cubic (A = -0.75), in OpenCV's fixed-point form on uint8
    and in float on float32."""
    arr = np.ascontiguousarray(np.asarray(src))
    if arr.dtype not in (np.uint8, np.float32):
        raise TypeError(f"imresize takes uint8 or float32 images, got "
                        f"{arr.dtype}")
    sh, sw = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    out = np.empty((h, w) + arr.shape[2:], arr.dtype)
    hb = _stage()
    L = hb.lib()
    fn = L.mxt_imresize_u8 if arr.dtype == np.uint8 else L.mxt_imresize_f32
    hb.check(fn(arr.ctypes.data, sh, sw, c, out.ctypes.data, int(h),
                int(w), int(interp)))
    return out


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0):
    """Pad an image with a border (≙ ``cv::copyMakeBorder``):
    ``border_type`` 0 fills with ``value``, 1 replicates the edge."""
    arr = np.asarray(src)
    pads = ((top, bot), (left, right)) + ((0, 0),) * (arr.ndim - 2)
    if border_type == 0:
        return np.pad(arr, pads, mode="constant", constant_values=value)
    return np.pad(arr, pads, mode="edge")


def resize_short(src, size, interp=2):
    """Resize so the shorter edge equals ``size``, keeping the aspect."""
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = np.asarray(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != tuple(size):
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    tw, th = size
    tw, th = min(tw, w), min(th, h)
    x0 = _py().randint(0, w - tw)
    y0 = _py().randint(0, h - th)
    out = fixed_crop(src, x0, y0, tw, th, size, interp)
    return out, (x0, y0, tw, th)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    tw, th = size
    tw, th = min(tw, w), min(th, h)
    x0 = (w - tw) // 2
    y0 = (h - th) // 2
    return fixed_crop(src, x0, y0, tw, th, size, interp), (x0, y0, tw, th)


def random_size_crop(src, size, area, ratio, interp=2, max_attempts=10):
    """Random crop with area in ``area`` of the source's and aspect in
    ``ratio``, then resize to ``size``."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    rnd = _py()
    for _ in range(max_attempts):
        target_area = rnd.uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rnd.uniform(*log_ratio))
        tw = int(round(np.sqrt(target_area * aspect)))
        th = int(round(np.sqrt(target_area / aspect)))
        if tw <= w and th <= h:
            x0 = rnd.randint(0, w - tw)
            y0 = rnd.randint(0, h - th)
            return fixed_crop(src, x0, y0, tw, th, size, interp), \
                (x0, y0, tw, th)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) - np.asarray(mean, np.float32)
    if std is not None:
        src /= np.asarray(std, np.float32)
    return src


# ------------------------------------------------------------ augmenters

class Augmenter:
    """≙ ``mx.image.Augmenter``: a callable transform with serializable
    parameters."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        ts = self.ts[:]
        _py().shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _py().random() < self.p:
            return np.asarray(src)[:, ::-1].copy()
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return np.asarray(src).astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _py().uniform(-self.brightness, self.brightness)
        return np.asarray(src).astype(np.float32) * alpha


_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class ContrastJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        src = np.asarray(src).astype(np.float32)
        alpha = 1.0 + _py().uniform(-self.contrast, self.contrast)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray.mean() * (1 - alpha)


class SaturationJitterAug(Augmenter):
    _coef = _GRAY

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        src = np.asarray(src).astype(np.float32)
        alpha = 1.0 + _py().uniform(-self.saturation, self.saturation)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1 - alpha)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        src = np.asarray(src).astype(np.float32)
        alpha = _py().uniform(-self.hue, self.hue)
        # the YIQ rotation of the reference's HueJitterAug
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], np.float32)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], np.float32)
        t_rgb = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        t = t_rgb @ bt @ t_yiq
        return src @ t.T


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        ts = []
        if brightness:
            ts.append(BrightnessJitterAug(brightness))
        if contrast:
            ts.append(ContrastJitterAug(contrast))
        if saturation:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA-based noise (AlexNet-style, ≙ image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _np().normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha) @ self.eigval
        return np.asarray(src).astype(np.float32) + rgb


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    _coef = _GRAY

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _py().random() < self.p:
            src = np.asarray(src).astype(np.float32)
            gray = (src * self._coef).sum(axis=2, keepdims=True)
            return np.broadcast_to(gray, src.shape).copy()
        return src


IMAGENET_MEAN = np.array([123.68, 116.28, 103.53])
IMAGENET_STD = np.array([58.395, 57.12, 57.375])


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """≙ ``mx.image.CreateAugmenter``: the standard augmenter list.
    ``data_shape`` is (H, W, C), NHWC as the reference's; ``mean=True``
    and ``std=True`` take ImageNet's."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[1], data_shape[0])  # (w, h)
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = IMAGENET_MEAN
    if std is True:
        std = IMAGENET_STD
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ------------------------------------------------------------- ImageIter

class ImageIter:
    """≙ ``mx.image.ImageIter``: a python iterator over a ``.rec`` file or
    an image list, yielding ``io.DataBatch``es of NHWC images (float32,
    or the uint8 / int8 wires) as host ``torch`` tensors.

    Decode (the stage's, GIL-free) and augmentation fan out over
    ``preprocess_threads`` threads; the record reads and each sample's
    seed stay serial, so batches do not depend on the threads.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 last_batch_handle="pad", preprocess_threads=0,
                 dtype="float32", **kwargs):
        from .. import io as _io
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)  # (H, W, C)
        self.label_width = label_width
        # uint8 and int8 wires carry a quarter of float32's bytes; the
        # cast belongs on the device.  int8 with a mean augmenter carries
        # mean-subtracted pixels saturated to [-128, 127], the reference's
        # contract; int8 without one shifts raw pixels by -128 (the
        # reference saturates them at 127 instead), lossless.
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.float32, np.uint8, np.int8):
            raise ValueError(f"unsupported iterator dtype {dtype}")
        self._io = _io
        self._pool = None
        if preprocess_threads and preprocess_threads > 1:
            import weakref
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=int(preprocess_threads))
            self._pool_finalizer = weakref.finalize(
                self, self._pool.shutdown, wait=False)
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape, **kwargs)
        self.auglist = aug_list
        self._mean_subtracted = False
        if self.dtype != np.float32:
            norm = [a for a in self.auglist
                    if type(a).__name__ == "ColorNormalizeAug"]
            if any(getattr(a, "std", None) is not None for a in norm):
                raise ValueError(
                    f"dtype={self.dtype} cannot carry std-normalized "
                    "pixels (they no longer span the integer range); "
                    "normalize on device instead — put the scaling in the "
                    "net or drop std from the augmenter chain")
            if norm and self.dtype == np.uint8:
                raise ValueError(
                    "dtype=uint8 cannot carry mean-subtracted pixels "
                    "(negative values saturate to 0); use dtype=int8 for "
                    "mean subtraction on the wire, or normalize on device")
            self._mean_subtracted = bool(norm)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.imgrec = None
        self.seq = None
        self.imglist = {}
        if path_imgrec is not None:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = _recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                      "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist is not None or imglist is not None:
            entries = []
            if path_imglist is not None:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        entries.append((int(parts[0]),
                                        [float(x) for x in parts[1:-1]],
                                        parts[-1]))
            else:
                for i, item in enumerate(imglist):
                    lab = item[0]
                    lab = [float(lab)] if np.isscalar(lab) \
                        else [float(x) for x in lab]
                    entries.append((i, lab, item[1]))
            self.imglist = {i: (lab, path) for i, lab, path in entries}
            self.seq = [i for i, _, _ in entries]
            self.path_root = path_root
        else:
            raise ValueError(
                "ImageIter needs path_imgrec, path_imglist, or imglist")
        self.reset()

    @property
    def provide_data(self):
        return [self._io.DataDesc(
            "data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [self._io.DataDesc(
            "softmax_label", (self.batch_size, self.label_width))]

    def reset(self):
        if self.shuffle:
            pyrandom.shuffle(self.seq)
        self._cursor = 0

    def _read_raw(self, idx):
        """The serial part: the record (or path) for ``idx`` and the
        sample's augmentation seed, drawn here in order."""
        seed = pyrandom.getrandbits(31)
        if self.imgrec is not None:
            rec = self.imgrec.read_idx(idx)
            header, buf = _recordio.unpack(rec)
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            return ("rec", buf, lab, seed)
        lab, path = self.imglist[idx]
        return ("file", os.path.join(self.path_root, path),
                np.asarray(lab, np.float32), seed)

    def _decode_augment(self, raw):
        """The parallel part: decode, then the augmenter chain on the
        sample's own generators."""
        kind, payload, lab, seed = raw
        img = imdecode(payload) if kind == "rec" else imread(payload)
        with sample_rng(seed):
            for aug in self.auglist:
                img = aug(img)
        return img, lab

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        n = len(self.seq)
        if self._cursor >= n:
            raise StopIteration
        batch_idx = []
        pad = 0
        while len(batch_idx) < self.batch_size:
            if self._cursor >= n:
                if self.last_batch_handle == "discard":
                    raise StopIteration
                if not batch_idx:
                    raise StopIteration
                pad = self.batch_size - len(batch_idx)
                batch_idx.extend(batch_idx[:1] * pad)
                break
            batch_idx.append(self.seq[self._cursor])
            self._cursor += 1
        data = np.zeros((self.batch_size,) + self.data_shape, self.dtype)
        label = np.zeros((self.batch_size, self.label_width), np.float32)
        raws = [self._read_raw(idx) for idx in batch_idx]
        if self._pool is not None:
            samples = list(self._pool.map(self._decode_augment, raws))
        else:
            samples = [self._decode_augment(r) for r in raws]
        for i, (img, lab) in enumerate(samples):
            img = np.asarray(img, np.float32).reshape(self.data_shape)
            if self.dtype == np.uint8:
                img = np.clip(np.rint(img), 0, 255)
            elif self.dtype == np.int8:
                if self._mean_subtracted:
                    img = np.clip(np.rint(img), -128, 127)
                else:
                    img = np.clip(np.rint(img) - 128, -128, 127)
            data[i] = img.astype(self.dtype)
            label[i, :len(lab)] = lab[:self.label_width]
        return self._io.DataBatch(
            data=[torch.from_numpy(data)], label=[torch.from_numpy(label)],
            pad=pad)
