"""The port's ``gluon.data`` against the JAX package's on the CPU: every
sampler's order, the ``DataLoader``'s batches (0 and 2 worker processes;
``last_batch`` keep, discard and rollover, over two epochs), every vision
transform, the vision datasets from local files, and the
``pipeline=True`` route through ``DataFeed`` — bit for bit, with numpy's
global generator seeded alike.  ``ImageRecordDataset`` decodes through
the reference's ``imdecode`` on ``test_torch_io.Cv2StandIn``."""
import gzip
import pickle
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from mxnet_tpu.gluon import data as jdata  # noqa: E402
from mxnet_tpu_torch.gluon import data as tdata  # noqa: E402
from test_torch_io import (as_np, cv2_standin, jpeg_bytes,  # noqa: E402,F401
                           png_bytes, smooth_image, write_rec)

torch.set_num_threads(1)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _flat(t)]
    if isinstance(tree, torch.Tensor) or hasattr(tree, "asnumpy"):
        return [as_np(tree)]
    return [np.asarray(tree)]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        fx, fy = _flat(x), _flat(y)
        assert len(fx) == len(fy)
        for u, v in zip(fx, fy):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


# -------------------------------------------------------------- samplers --
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_reference(last):
    got = []
    for m in (jdata, tdata):
        np.random.seed(30)
        seq = list(m.SequentialSampler(7, start=2))
        rnd = [list(m.RandomSampler(9)) for _ in range(2)]
        bs = m.BatchSampler(m.RandomSampler(10), 4, last)
        batches = [list(bs) for _ in range(3)]
        lens = len(bs)
        ds = m.SimpleDataset(list(range(12)))
        filt = list(m.sampler.FilterSampler(lambda x: x % 3 == 1, ds))
        iv = [list(m.sampler.IntervalSampler(10, 3, rollover=r))
              for r in (True, False)]
        got.append((seq, rnd, batches, lens, filt, iv))
    assert got[0] == got[1]


# ------------------------------------------------------------ DataLoader --
def _arrays(n):
    rs = np.random.RandomState(31)
    return (rs.randint(0, 256, (n, 6, 5, 3)).astype(np.uint8),
            rs.randint(0, 10, (n,)).astype(np.int32))


def _loader_epochs(m, dataset, workers, last, epochs=2, **kw):
    np.random.seed(32)
    dl = m.DataLoader(dataset, batch_size=4, shuffle=True, last_batch=last,
                      num_workers=workers, **kw)
    out = [list(dl) for _ in range(epochs)]
    if hasattr(dl, "close"):
        dl.close()
    return out


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_dataloader_matches_reference(workers, last):
    x, y = _arrays(11)
    ref = _loader_epochs(jdata, jdata.ArrayDataset(x, y), 0, last)
    got = _loader_epochs(tdata, tdata.ArrayDataset(x, y), workers, last)
    for a, b in zip(ref, got):
        _same_batches(a, b)
    assert all(isinstance(t, torch.Tensor) for e in got for b in e for t in b)


def test_dataloader_thread_pool_and_pipeline_route_on_the_cpu():
    ds = tdata.ArrayDataset(np.arange(10, dtype=np.float32).reshape(5, 2),
                            np.arange(5))
    plain = list(tdata.DataLoader(ds, batch_size=2))
    threads = list(tdata.DataLoader(ds, batch_size=2, num_workers=2,
                                    thread_pool=True))
    fed = list(tdata.DataLoader(ds, batch_size=2, pipeline=True,
                                device="cpu"))
    _same_batches(plain, threads)
    _same_batches(plain, fed)


def test_dataloader_unpicklable_dataset_takes_threads():
    base = tdata.ArrayDataset(np.arange(6, dtype=np.float32))
    ds = base.transform(lambda x: x * 2)        # a lambda: no pickle
    with pytest.raises((pickle.PicklingError, AttributeError)):
        pickle.dumps(ds)
    got = list(tdata.DataLoader(ds, batch_size=4, num_workers=2))
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  np.arange(6, dtype=np.float32) * 2)


# ------------------------------------------------------------ transforms --
def _transforms(m):
    t = m.vision.transforms
    return {
        "ToTensor": t.ToTensor(), "Normalize": t.Normalize(0.5, 0.25),
        "Cast": t.Cast("float16"), "Resize": t.Resize((7, 9)),
        "RandomFlipLeftRight": t.RandomFlipLeftRight(),
        "RandomCrop": t.RandomCrop(10, pad=2),
        "CenterCrop": t.CenterCrop((12, 10)),
        "RandomBrightness": t.RandomBrightness(0.3),
        "RandomContrast": t.RandomContrast(0.3),
        "RandomSaturation": t.RandomSaturation(0.3),
        "RandomHue": t.RandomHue(0.2),
        "RandomColorJitter": t.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
        "RandomLighting": t.RandomLighting(0.1),
        "RandomGray": t.RandomGray(0.5),
        "RandomFlipTopBottom": t.RandomFlipTopBottom(),
        "Compose": t.Compose([t.RandomCrop(12), t.ToTensor(),
                              t.Normalize([0.4, 0.5, 0.6], 0.2)]),
    }


@pytest.mark.parametrize("name", sorted(_transforms(jdata)))
def test_transform_matches_reference(name):
    img = smooth_image(np.random.RandomState(33), 16, 18)
    import random
    for seed in (1, 2, 3):
        out = []
        for m in (jdata, tdata):
            np.random.seed(seed)
            random.seed(seed)
            out.append(np.asarray(_transforms(m)[name](img.copy())))
        assert out[1].dtype == out[0].dtype and out[1].shape == out[0].shape
        np.testing.assert_array_equal(out[1], out[0])


def test_random_resized_crop_matches_reference(monkeypatch):
    """Its draws and crop, with the reference given the port's resize."""
    from mxnet_tpu import image as jimage
    from mxnet_tpu_torch import image as timage
    monkeypatch.setattr(jimage, "imresize", timage.imresize)
    img = smooth_image(np.random.RandomState(34), 30, 36)
    import random
    for seed in (4, 5):
        out = []
        for m in (jdata, tdata):
            random.seed(seed)
            out.append(m.vision.transforms.RandomResizedCrop(14)(img))
        np.testing.assert_array_equal(out[1], out[0])


# -------------------------------------------------------------- datasets --
def _mnist_files(root, n, rs):
    imgs = rs.randint(0, 256, (n, 28, 28), np.uint8)
    labs = rs.randint(0, 10, (n,), np.uint8)
    for split, k in (("train", n), ("t10k", n)):
        with gzip.open(root / f"{split}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 2051, k, 28, 28) + imgs.tobytes())
        with gzip.open(root / f"{split}-labels-idx1-ubyte.gz", "wb") as f:
            f.write(struct.pack(">II", 2049, k) + labs.tobytes())


def _items(ds, idx=(0, 1, -1)):
    return [ds[i % len(ds)] for i in idx] + [len(ds)]


def test_vision_datasets_match_reference(tmp_path):
    rs = np.random.RandomState(35)
    (tmp_path / "m").mkdir()
    _mnist_files(tmp_path / "m", 9, rs)
    cdir = tmp_path / "c" / "cifar-10-batches-bin"
    cdir.mkdir(parents=True)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rows = np.concatenate([rs.randint(0, 10, (4, 1)),
                               rs.randint(0, 256, (4, 3072))], 1)
        rows.astype(np.uint8).tofile(cdir / name)
    cases = [
        lambda m: m.vision.MNIST(str(tmp_path / "m"), train=True),
        lambda m: m.vision.FashionMNIST(str(tmp_path / "m"), train=False),
        lambda m: m.vision.CIFAR10(str(tmp_path / "c"), train=True),
        lambda m: m.vision.CIFAR10(str(tmp_path / "c"), train=False),
        lambda m: m.vision.MNIST(str(tmp_path / "absent"), train=False),
        lambda m: m.vision.SyntheticImageDataset(16, (4, 4, 3), 5, seed=3),
    ]
    for make in cases:
        _same_batches(_items(make(jdata)), _items(make(tdata)))


def test_image_folder_and_record_datasets_match_reference(tmp_path,
                                                          cv2_standin):
    rs = np.random.RandomState(36)
    imgs = [smooth_image(rs, 20, 24) for _ in range(5)]
    for i, im in enumerate(imgs):
        d = tmp_path / "folder" / ("cat" if i % 2 else "dog")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(im).save(d / f"{i}.png")
    (tmp_path / "folder" / "notes.txt").write_text("not a class")
    rec = write_rec(str(tmp_path / "d.rec"),
                    [jpeg_bytes(im, 90) for im in imgs], range(5))
    for make in (lambda m: m.vision.ImageFolderDataset(
                     str(tmp_path / "folder")),
                 lambda m: m.vision.ImageRecordDataset(rec)):
        a, b = make(jdata), make(tdata)
        if hasattr(a, "synsets"):
            assert a.synsets == b.synsets
        _same_batches(_items(a, range(5)), _items(b, range(5)))
