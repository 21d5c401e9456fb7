"""The port's ``image`` module, its ``ImageIter`` / ``ImageRecordIter``,
``image.detection``, the native loader and the example's ``--rec`` route
against the JAX package's on the CPU.

The oracle for decoding is PIL (libjpeg's ISLOW IDCT and fancy
upsampling, as OpenCV's ``imdecode``): the port's ``imdecode`` equals
it bit for bit, and the reference's iterators run with
``test_torch_io.Cv2StandIn`` (PIL) in ``sys.modules``.  The stand-in has
no ``resize``, so the iterator cases crop without resizing; the
resizing augmenters are held against the reference's with the port's
``imresize`` put in the reference's module.  ``imresize`` itself is held
within one level of a float64 evaluation of OpenCV's linear and cubic
kernels, and of ``cv2.resize`` where OpenCV is installed.
"""
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu import image as jimage  # noqa: E402
from mxnet_tpu import io as jio  # noqa: E402
from mxnet_tpu_torch import image as timage  # noqa: E402
from mxnet_tpu_torch import io as tio  # noqa: E402
from test_torch_io import (as_np, cv2_standin, jpeg_bytes,  # noqa: E402,F401
                           png_bytes, smooth_image, write_rec)

torch.set_num_threads(1)

REC_N = 20          # records of the iterator cases
REC_HW = (64, 72)
CROP = (3, 48, 56)  # (C, H, W): no resize


# --------------------------------------------------------------- decode --
def _pil(b, gray):
    import io as _bio
    from PIL import Image
    im = Image.open(_bio.BytesIO(b))
    return np.asarray(im.convert("L" if gray else "RGB"))


@pytest.mark.parametrize("fmt", ["baseline", "progressive", "png"])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_imdecode_equals_pil_bit_for_bit(fmt, gray):
    img = smooth_image(np.random.RandomState(8), 61, 83, gray=gray)
    b = png_bytes(img) if fmt == "png" else \
        jpeg_bytes(img, 85, progressive=fmt == "progressive")
    got = timage.imdecode(b)
    assert got.shape == (61, 83, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil(b, gray=False))
    np.testing.assert_array_equal(timage.imdecode(b, to_rgb=False),
                                  got[:, :, ::-1])
    if gray:
        np.testing.assert_array_equal(timage.imdecode(b, flag=0),
                                      _pil(b, gray=True))


def test_imdecode_raises_on_bytes_that_are_no_image():
    with pytest.raises(ValueError, match="neither JPEG nor PNG"):
        timage.imdecode(b"GIF89a....")
    with pytest.raises(ValueError, match="JPEG"):
        timage.imdecode(b"\xff\xd8\xff" + b"\x00" * 64)


def test_imencode_round_trips():
    img = smooth_image(np.random.RandomState(9), 30, 40)
    np.testing.assert_array_equal(
        timage.imdecode(timage.imencode(img, ".png")), img)
    j = timage.imencode(img, ".jpg", 95)
    np.testing.assert_array_equal(timage.imdecode(j), _pil(j, False))
    assert np.abs(timage.imdecode(j).astype(int) - img).mean() < 3


# --------------------------------------------------------------- resize --
def _cubic(x):
    a = -0.75
    return [((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a,
            ((a + 2) * x - (a + 3)) * x * x + 1,
            ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1]


def _axis(ssize, dsize, interp):
    """OpenCV's interpolation matrix along one axis, in float64."""
    m = np.zeros((dsize, ssize))
    scale = 1.0 / (dsize / ssize)
    for d in range(dsize):
        fx = (d + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        fx -= sx
        if interp == 1:
            if sx < 0:
                fx, sx = 0.0, 0
            if sx >= ssize - 1:
                fx, sx = 0.0, ssize - 1
            taps, w = [sx, sx + 1], [1 - fx, fx]
        else:
            c = _cubic(fx)
            taps, w = [sx - 1, sx, sx + 1, sx + 2], c + [1 - sum(c)]
        for t, v in zip(taps, w):
            m[d, min(max(t, 0), ssize - 1)] += v
    return m


def _formula(img, w, h, interp):
    my, mx = _axis(img.shape[0], h, interp), _axis(img.shape[1], w, interp)
    return np.einsum("yi,ijc,xj->yxc", my, img.astype(np.float64), mx)


SIZES = [(40, 30), (97, 71), (56, 56), (13, 50)]


@pytest.mark.parametrize("interp", [1, 2], ids=["linear", "cubic"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_imresize_within_one_level_of_opencv_formula(interp, size):
    """OpenCV's kernels in float64, without its fixed-point coefficients
    and roundings: the oracle on a machine without OpenCV."""
    img = smooth_image(np.random.RandomState(10), 47, 59)
    w, h = size
    got = timage.imresize(img, w, h, interp)
    want = np.clip(np.round(_formula(img, w, h, interp)), 0, 255)
    assert got.shape == (h, w, 3)
    assert np.abs(got.astype(np.float64) - want).max() <= 1
    f = timage.imresize(img.astype(np.float32), w, h, interp)
    assert np.abs(f - _formula(img, w, h, interp)).max() <= 1e-3


def test_imresize_nearest_and_resize_short():
    img = smooth_image(np.random.RandomState(11), 30, 45)
    got = timage.imresize(img, 20, 17, 0)
    ri = (np.arange(17) * (30 / 17)).astype(int)
    ci = (np.arange(20) * (45 / 20)).astype(int)
    np.testing.assert_array_equal(got, img[ri][:, ci])
    short = timage.resize_short(img, 24)
    assert short.shape == (24, 36, 3)
    want = np.clip(np.round(_formula(img, 36, 24, 2)), 0, 255)
    assert np.abs(short.astype(np.float64) - want).max() <= 1


def test_imresize_within_one_level_of_cv2_where_installed():
    cv2 = pytest.importorskip("cv2")
    img = smooth_image(np.random.RandomState(12), 47, 59)
    for w, h in SIZES:
        for interp in (0, 1, 2):
            got = timage.imresize(img, w, h, interp)
            ref = cv2.resize(img, (w, h), interpolation=interp)
            assert np.abs(got.astype(int) - ref).max() <= (interp > 0)


# ----------------------------------------------------------- augmenters --
def _augs(m):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return {
        "Sequential": m.SequentialAug([m.CastAug(),
                                       m.BrightnessJitterAug(0.3)]),
        "RandomOrder": m.RandomOrderAug([m.BrightnessJitterAug(0.3),
                                         m.ContrastJitterAug(0.3),
                                         m.SaturationJitterAug(0.3)]),
        "Resize": m.ResizeAug(30, 2),
        "ForceResize": m.ForceResizeAug((33, 21), 1),
        "RandomCrop": m.RandomCropAug((30, 22), 2),
        "RandomSizedCrop": m.RandomSizedCropAug((28, 28), (0.08, 1.0),
                                                (3 / 4, 4 / 3), 2),
        "CenterCrop": m.CenterCropAug((30, 22), 2),
        "HorizontalFlip": m.HorizontalFlipAug(0.5),
        "Cast": m.CastAug(),
        "Brightness": m.BrightnessJitterAug(0.4),
        "Contrast": m.ContrastJitterAug(0.4),
        "Saturation": m.SaturationJitterAug(0.4),
        "Hue": m.HueJitterAug(0.3),
        "ColorJitter": m.ColorJitterAug(0.3, 0.3, 0.3),
        "Lighting": m.LightingAug(0.1, eigval, eigvec),
        "ColorNormalize": m.ColorNormalizeAug([123.68, 116.28, 103.53],
                                              [58.395, 57.12, 57.375]),
        "RandomGray": m.RandomGrayAug(0.5),
    }


@pytest.mark.parametrize("name", sorted(_augs(jimage)))
def test_augmenter_matches_reference(name, monkeypatch):
    """Each augmenter on the same image with the same seed: the
    reference under reseeded globals, the port under ``sample_rng``."""
    monkeypatch.setattr(jimage, "imresize", timage.imresize)
    img = smooth_image(np.random.RandomState(13), 40, 48)
    for seed in (1, 2, 3, 4):
        random.seed(seed)
        np.random.seed(seed)
        want = np.asarray(_augs(jimage)[name](img.copy()))
        with timage.sample_rng(seed):
            got = np.asarray(_augs(timage)[name](img.copy()))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_create_augmenter_chain_matches_reference(monkeypatch):
    monkeypatch.setattr(jimage, "imresize", timage.imresize)
    kw = dict(resize=36, rand_crop=True, rand_resize=True, rand_mirror=True,
              mean=True, std=True, brightness=0.2, contrast=0.2,
              saturation=0.2, hue=0.1, pca_noise=0.1, rand_gray=0.2)
    ja = jimage.CreateAugmenter((24, 28, 3), **kw)
    ta = timage.CreateAugmenter((24, 28, 3), **kw)
    assert [type(a).__name__ for a in ja] == [type(a).__name__ for a in ta]
    img = smooth_image(np.random.RandomState(14), 40, 52)
    for seed in (5, 6):
        random.seed(seed)
        np.random.seed(seed)
        want = img
        for a in ja:
            want = a(want)
        with timage.sample_rng(seed):
            got = img
            for a in ta:
                got = a(got)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ iterators --
@pytest.fixture
def rec_file(tmp_path):
    rs = np.random.RandomState(15)
    imgs = [smooth_image(rs, *REC_HW, gray=(i == 3)) for i in range(REC_N)]
    payloads = [png_bytes(im) if i % 5 == 4 else jpeg_bytes(im, 90)
                for i, im in enumerate(imgs)]
    return write_rec(str(tmp_path / "t.rec"), payloads,
                     [i % 7 for i in range(REC_N)])


CASES = {
    "float32_rand_crop_mirror_norm": dict(
        dtype="float32", rand_crop=True, rand_mirror=True,
        mean=[123.68, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
    "uint8_rand_crop_mirror": dict(dtype="uint8", rand_crop=True,
                                   rand_mirror=True),
    "int8_mean": dict(dtype="int8", mean_r=120.0, mean_g=110.0,
                      mean_b=100.0),
    "int8_shift": dict(dtype="int8", rand_mirror=True),
    "float32_center": dict(dtype="float32", brightness=0.3, contrast=0.3,
                           pca_noise=0.1, rand_gray=0.3),
}


def _run_epochs(it, n):
    out = []
    for _ in range(n):
        for b in it:
            out.append((as_np(b.data[0]), as_np(b.label[0]), b.pad))
        it.reset()
    it.close() if hasattr(it, "close") else None
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_record_iter_matches_reference(case, rec_file, cv2_standin):
    """The python tier, shuffled, two epochs, both packages seeded
    alike: every batch, label and pad bit for bit."""
    kw = CASES[case]
    got = []
    for m in (jio, tio):
        random.seed(21)
        it = m.ImageRecordIter(rec_file, CROP, 6, shuffle=True,
                               preprocess_threads=2, **kw)
        got.append(_run_epochs(it, 2))
    ref, ours = got
    assert len(ours) == len(ref) == 8
    for (a, la, pa), (b, lb, pb) in zip(ref, ours):
        assert pb == pa and b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)


@pytest.mark.parametrize("last", ["pad", "discard"])
def test_image_iter_imglist_matches_reference(last, tmp_path, cv2_standin):
    rs = np.random.RandomState(16)
    imglist = []
    for i in range(7):
        p = tmp_path / f"im{i}.jpg"
        p.write_bytes(jpeg_bytes(smooth_image(rs, 40, 44), 90))
        imglist.append([float(i % 3), p.name])
    got = []
    for m in (jimage, timage):
        random.seed(22)
        it = m.ImageIter(3, (32, 36, 3), imglist=imglist,
                         path_root=str(tmp_path), shuffle=True,
                         last_batch_handle=last, rand_crop=True)
        got.append(_run_epochs(it, 2))
    assert len(got[0]) == len(got[1]) == (6 if last == "pad" else 4)
    for (a, la, pa), (b, lb, pb) in zip(*got):
        assert pb == pa
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)


def test_image_iter_threads_do_not_change_batches(rec_file):
    kw = dict(rand_crop=True, rand_mirror=True, brightness=0.3)
    outs = []
    for threads in (0, 3):
        random.seed(23)
        it = timage.ImageIter(5, (48, 56, 3), path_imgrec=rec_file,
                              shuffle=True, preprocess_threads=threads,
                              **kw)
        outs.append(_run_epochs(it, 1))
    for (a, _, _), (b, _, _) in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _native_epoch(it):
    out = []
    while True:
        try:
            d, lab, pad = it.next_raw()
        except StopIteration:
            return out
        out.append((d.copy(), lab.copy(), pad))


def test_native_tier_at_8_8_equals_python_tier(rec_file):
    """No resize, center crop: the native loader's pixels are the python
    tier's, bit for bit, whatever its worker count; its float32 output
    is the uint8 one cast."""
    it = tio.ImageRecordIter(rec_file, CROP, 6, dtype="uint8")
    py = [(as_np(b.data[0]).transpose(0, 3, 1, 2), as_np(b.label[0]), b.pad)
          for b in it]
    it.close()
    for workers in (1, 3):
        nat = tio.NativeImageRecordIter(rec_file, CROP, 6,
                                        preprocess_threads=workers,
                                        dtype="uint8")
        got = _native_epoch(nat)
        assert len(got) == len(py) == 4
        for (a, la, pa), (b, lb, pb) in zip(py, got):
            assert pb == pa
            n = 6 - pa
            np.testing.assert_array_equal(b[:n], a[:n])
            np.testing.assert_array_equal(lb[:n], la[:n])
        st = nat.stats()
        assert st["samples"] == REC_N and st["decode_backend"] == "libjpeg"
        assert st["png_decodes"] == 4 and st["jpeg_decodes"] == 16
        nat.close()
    f32 = _native_epoch(tio.NativeImageRecordIter(rec_file, CROP, 6,
                                                  dtype="float32"))
    np.testing.assert_array_equal(f32[0][0], got[0][0].astype(np.float32))


def test_native_loader_is_deterministic_and_reshuffles(rec_file):
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, resize=50,
              seed=3, dtype="uint8")
    a = tio.NativeImageRecordIter(rec_file, (3, 40, 40), 4,
                                  preprocess_threads=1, **kw)
    b = tio.NativeImageRecordIter(rec_file, (3, 40, 40), 4,
                                  preprocess_threads=4, **kw)
    e1a, e1b = _native_epoch(a), _native_epoch(b)
    a.reset()
    e2a = _native_epoch(a)
    for (x, lx, _), (y, ly, _) in zip(e1a, e1b):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(lx, ly)
    assert not all((x[1] == y[1]).all() for x, y in zip(e1a, e2a))
    assert sorted(np.concatenate([lab for _, lab, _ in e1a]).ravel()) == \
        sorted(float(i % 7) for i in range(REC_N))
    with pytest.raises(RuntimeError, match="nvjpeg"):
        tio.NativeImageRecordIter(rec_file, (3, 40, 40), 4, decode="nvjpeg")


def test_datafeed_route_normalizes_the_native_batches(rec_file):
    mean = [123.68, 116.28, 103.53]
    std = [58.395, 57.12, 57.375]
    feed = tio.ImageRecordIter(rec_file, CROP, 6, pipeline="datafeed",
                               device="cpu", mean=mean, std=std)
    nat = tio.NativeImageRecordIter(rec_file, CROP, 6, dtype="uint8")
    for b, (d, lab, pad) in zip(feed, _native_epoch(nat)):
        want = feed.finalize(torch.from_numpy(d)).numpy()
        assert b.data[0].shape == (6, 48, 56, 3) and b.pad == pad
        np.testing.assert_array_equal(b.data[0].numpy(), want)
        np.testing.assert_array_equal(b.label[0].numpy(), lab)
    st = feed.stats()
    assert st["h2d_bytes"] == st["staged_batches"] * (6 * 48 * 56 * 3 +
                                                      6 * 4)
    feed.close()


# --------------------------------------------------------------- example --
def test_example_trains_on_the_record_iter_batches(rec_file, monkeypatch):
    """``--rec`` on the CPU: the batches the example trains on are the
    ones ``io.ImageRecordIter`` yields for the same records and seed
    (shuffled, epoch after epoch), and the losses are finite."""
    from mxnet_tpu_torch.examples import image_classification as ic
    seen = []
    real = ic.train_step

    def spy(net, trainer, loss_fn, x, y):
        seen.append((x.numpy().copy(), y.numpy().copy()))
        return real(net, trainer, loss_fn, x, y)

    monkeypatch.setattr(ic, "train_step", spy)
    out = ic.main(["--rec", rec_file, "--device", "cpu", "--model",
                   "resnet18_v1", "--image-size", "32", "--batch-size", "8",
                   "--iters", "2", "--classes", "7", "--seed", "4"])
    assert out["steps"] == 4 and len(seen) == 4
    assert all(np.isfinite(v) for v in out["losses"])
    random.seed(4)
    it = tio.ImageRecordIter(rec_file, (3, 32, 32), 8, shuffle=True)
    want = []
    while len(want) < 4:
        it.reset()
        want += [(as_np(b.data[0]), as_np(b.label[0]).ravel())
                 for b in it]
    it.close()
    for (x, y), (wx, wy) in zip(seen, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy.astype(np.int64))


# ------------------------------------------------------------- detection --
def _det_label(rs, n=3):
    xy = np.sort(rs.uniform(0, 1, (n, 2, 2)), axis=1)
    return np.concatenate([rs.randint(0, 5, (n, 1)), xy[:, 0], xy[:, 1]],
                          1).astype(np.float32)[:, [0, 1, 3, 2, 4]]


@pytest.mark.parametrize("name", ["flip", "crop", "pad", "borrow"])
def test_detection_augmenter_matches_reference(name):
    from mxnet_tpu.image import detection as jdet
    from mxnet_tpu_torch.image import detection as tdet
    rs = np.random.RandomState(40)
    img, lab = smooth_image(rs, 30, 40), _det_label(rs)
    for seed in (1, 2, 3):
        out = []
        for m, im in ((jdet, jimage), (tdet, timage)):
            aug = {"flip": lambda: m.DetHorizontalFlipAug(0.5),
                   "crop": lambda: m.DetRandomCropAug(0.5),
                   "pad": lambda: m.DetRandomPadAug(1.5),
                   "borrow": lambda: m.DetBorrowAug(
                       im.BrightnessJitterAug(0.3))}[name]()
            random.seed(seed)
            out.append(aug(img.copy(), lab.copy()))
        for a, b in zip(*out):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_image_det_iter_matches_reference(tmp_path, cv2_standin,
                                          monkeypatch):
    """Its batches and (B, max_objects, 5) labels, with the reference
    given the port's resize."""
    from mxnet_tpu.image import detection as jdet
    from mxnet_tpu_torch.image import detection as tdet
    monkeypatch.setattr(jdet, "imresize", timage.imresize)
    monkeypatch.setattr(jimage, "imresize", timage.imresize)
    rs = np.random.RandomState(41)
    imglist = []
    for i in range(5):
        p = tmp_path / f"d{i}.png"
        p.write_bytes(png_bytes(smooth_image(rs, 30, 36)))
        imglist.append([_det_label(rs, 2).ravel().tolist(), p.name])
    got = []
    for m in (jdet, tdet):
        random.seed(42)
        it = m.ImageDetIter(2, (24, 28, 3), imglist=imglist,
                            path_root=str(tmp_path), shuffle=True,
                            rand_crop=1, rand_pad=1, rand_mirror=True,
                            max_objects=4)
        got.append([(as_np(b.data[0]), as_np(b.label[0]), b.pad)
                    for b in it])
    assert len(got[0]) == len(got[1]) == 3
    for (a, la, pa), (b, lb, pb) in zip(*got):
        assert pa == pb
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(lb, la)
