"""Vision datasets (≙ ``gluon/data/vision/datasets.py``).

Each dataset reads local files only (the original on-disk formats:
idx-ubyte for MNIST and Fashion-MNIST, the binary batches of CIFAR-10)
and, where they are absent, a deterministic synthetic set of the same
shapes and classes, as the reference's.  ``ImageFolderDataset`` and
``ImageRecordDataset`` decode through the port's ``image.imdecode``.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "SyntheticImageDataset",
           "ImageFolderDataset", "ImageRecordDataset"]


class SyntheticImageDataset(Dataset):
    """Deterministic class-separable synthetic images (label-dependent
    means + noise), so optimization tests can actually converge."""

    def __init__(self, num_samples=1024, shape=(28, 28, 1), num_classes=10,
                 seed=42, template_seed=100):
        # class templates are split-independent (template_seed) so a model
        # trained on the train split generalizes to the test split; only the
        # per-sample noise differs by `seed`.
        base = onp.random.RandomState(template_seed).randn(
            num_classes, *shape).astype("float32")
        rng = onp.random.RandomState(seed)
        self._labels = rng.randint(0, num_classes, size=num_samples).astype("int32")
        noise = rng.randn(num_samples, *shape).astype("float32") * 0.3
        self._data = base[self._labels] + noise
        self._num_classes = num_classes

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        return self._data[idx], self._labels[idx]


class MNIST(Dataset):
    """≙ gluon.data.vision.MNIST: idx-ubyte format reader w/ synthetic
    fallback. Images returned HWC uint8-scaled float32 in [0,1]."""

    _FILES = {
        True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        root = os.path.expanduser(root)
        img_f, lbl_f = self._FILES[train]
        img_p, lbl_p = os.path.join(root, img_f), os.path.join(root, lbl_f)
        if os.path.exists(img_p) and os.path.exists(lbl_p):
            self._data, self._labels = self._read_idx(img_p, lbl_p)
        else:
            synth = SyntheticImageDataset(4096 if train else 512,
                                          (28, 28, 1), 10,
                                          seed=1 if train else 2)
            self._data = ((synth._data - synth._data.min()) /
                          (onp.ptp(synth._data) + 1e-6))
            self._labels = synth._labels
        self._transform = transform

    @staticmethod
    def _read_idx(img_p, lbl_p):
        with gzip.open(lbl_p, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = onp.frombuffer(f.read(), dtype=onp.uint8).astype("int32")
        with gzip.open(img_p, "rb") as f:
            magic, n, h, w = struct.unpack(">IIII", f.read(16))
            images = onp.frombuffer(f.read(), dtype=onp.uint8)
            images = images.reshape(n, h, w, 1).astype("float32") / 255.0
        return images, labels

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        img, lbl = self._data[idx], self._labels[idx]
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(Dataset):
    """≙ gluon.data.vision.CIFAR10 (binary batches) w/ synthetic fallback."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        root = os.path.expanduser(root)
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        paths = [os.path.join(root, "cifar-10-batches-bin", f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, labels = [], []
            for p in paths:
                raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0].astype("int32"))
                imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                data.append(imgs.astype("float32") / 255.0)
            self._data = onp.concatenate(data)
            self._labels = onp.concatenate(labels)
        else:
            synth = SyntheticImageDataset(4096 if train else 512,
                                          (32, 32, 3), 10,
                                          seed=3 if train else 4)
            self._data = ((synth._data - synth._data.min()) /
                          (onp.ptp(synth._data) + 1e-6))
            self._labels = synth._labels
        self._transform = transform

    def __len__(self):
        return len(self._labels)

    def __getitem__(self, idx):
        img, lbl = self._data[idx], self._labels[idx]
        if self._transform is not None:
            return self._transform(img, lbl)
        return img, lbl


class ImageFolderDataset(Dataset):
    """≙ gluon.data.vision.ImageFolderDataset: root/<class>/<img> layout."""

    def __init__(self, root, flag=1, transform=None):
        self._root = root
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for cls in sorted(os.listdir(root)):
            d = os.path.join(root, cls)
            if not os.path.isdir(d):
                continue
            label = len(self.synsets)
            self.synsets.append(cls)
            for f in sorted(os.listdir(d)):
                if os.path.splitext(f)[1].lower() in \
                        (".jpg", ".jpeg", ".png", ".bmp"):
                    self.items.append((os.path.join(d, f), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, flag=self._flag)
        if self._transform is not None:
            img = self._transform(img)
        return img, label


class ImageRecordDataset(Dataset):
    """≙ gluon.data.vision.ImageRecordDataset over a .rec/.idx pair."""

    def __init__(self, filename, flag=1, transform=None):
        from .... import recordio as _rec
        idx_path = os.path.splitext(filename)[0] + ".idx"
        self._record = _rec.MXIndexedRecordIO(idx_path, filename, "r")
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        from .... import recordio as _rec
        from ....image import imdecode
        rec = self._record.read_idx(self._record.keys[idx])
        header, buf = _rec.unpack(rec)
        img = imdecode(buf, flag=self._flag)
        if self._transform is not None:
            img = self._transform(img)
        label = header.label
        if hasattr(label, "__len__") and len(onp.atleast_1d(label)) == 1:
            label = float(onp.atleast_1d(label)[0])
        return img, label
