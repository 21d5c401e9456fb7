"""The port's RecordIO, storage pools, ``io`` iterators and ``DataFeed``
against the JAX package's on the CPU.

- ``.rec`` and ``.idx`` bytes: the port's writer against the reference's
  native one (``src/recordio.cc``, multi-part records included), each
  reading the other's files; ``pack`` / ``unpack`` and the ``.npy``
  payload of ``pack_img``.
- ``NDArrayIter``, ``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
  ``PrefetchingIter`` and ``ResizeIter``: the reference's batches, ``pad``
  and order, bit for bit, over several epochs.
- ``DataFeed``'s finalize (cast, scale, mean, std, NCHW → NHWC) on the
  CPU: the reference's jitted ``finalize``, fp32 exact; its ring's
  ``close()`` / ``reset()`` mid-epoch, each under a timeout of its own.

Where the reference needs OpenCV, it gets :class:`Cv2StandIn` in
``sys.modules``: ``imdecode`` through PIL, which decodes JPEG with
libjpeg's ISLOW IDCT and fancy upsampling as OpenCV does, so the
stand-in is the oracle for decoding; it has no ``resize``.
"""
import io as _bio
import os
import struct
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import io as jio  # noqa: E402
from mxnet_tpu import recordio as jrec  # noqa: E402
from mxnet_tpu_torch import io as tio  # noqa: E402
from mxnet_tpu_torch import recordio as trec  # noqa: E402
from mxnet_tpu_torch.storage import StoragePool  # noqa: E402

torch.set_num_threads(1)

LIVENESS_S = 20.0           # a ring's close / reset must finish inside


class Cv2StandIn(types.ModuleType):
    """The few ``cv2`` calls the reference's input path makes, through
    PIL (BGR in and out, as OpenCV's)."""
    IMREAD_GRAYSCALE, IMREAD_COLOR, IMREAD_UNCHANGED = 0, 1, -1
    IMWRITE_JPEG_QUALITY = 1

    def __init__(self):
        super().__init__("cv2")

    @staticmethod
    def imdecode(arr, flag):
        im = Image.open(_bio.BytesIO(np.asarray(arr).tobytes()))
        if flag == 0:
            return np.asarray(im.convert("L")).copy()
        if im.mode == "L" and flag == -1:
            return np.asarray(im).copy()
        return np.asarray(im.convert("RGB"))[:, :, ::-1].copy()

    @staticmethod
    def imencode(ext, img, params=()):
        q = dict(zip(params[::2], params[1::2])).get(1, 95)
        arr = np.asarray(img)
        if arr.ndim == 3:
            arr = arr[:, :, ::-1]
        bio = _bio.BytesIO()
        Image.fromarray(arr).save(bio, "JPEG" if ext in (".jpg", ".jpeg")
                                  else "PNG", quality=q)
        return True, np.frombuffer(bio.getvalue(), np.uint8)

    @staticmethod
    def resize(*a, **k):
        raise NotImplementedError("the cv2 stand-in has no resize")


@pytest.fixture
def cv2_standin(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", Cv2StandIn())


def jpeg_bytes(img, quality=90, progressive=False):
    bio = _bio.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", quality=quality,
                              progressive=progressive)
    return bio.getvalue()


def png_bytes(img):
    bio = _bio.BytesIO()
    Image.fromarray(img).save(bio, "PNG")
    return bio.getvalue()


def smooth_image(rs, h, w, gray=False):
    """A smooth field with an edge and mild noise, uint8 HWC (HW)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rs.uniform(0, 255)
    img = np.stack([(xx * 3 + ph) % 256, (yy * 2 + ph) % 256,
                    (xx + yy + 2 * ph) % 256], -1)
    img[:, rs.randint(w // 4, 3 * w // 4):] *= 0.5
    img = np.clip(img + rs.randn(h, w, 3) * 3, 0, 255).astype(np.uint8)
    return img[:, :, 0].copy() if gray else img


def write_rec(path, payloads, labels):
    w = trec.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx", path,
                               "w")
    for i, (p, lab) in enumerate(zip(payloads, labels)):
        w.write_idx(i, trec.pack(trec.IRHeader(0, float(lab), i, 0), p))
    w.close()
    return path


def as_np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


# ------------------------------------------------------------- recordio --
def _payloads():
    rs = np.random.RandomState(0)
    magic = struct.pack("<I", 0xCED7230A)
    return [b"", b"abc", rs.bytes(37),
            b"head" + magic + rs.bytes(9) + magic + b"tail",   # 2 splits
            b"x" + magic + b"yyy",                             # unaligned
            magic, rs.bytes(4096)]


def _write(mod, tmp_path, name):
    rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    for i, p in enumerate(_payloads()):
        w.write_idx(i, p)
    w.close()
    return rec, idx


def test_rec_and_idx_bytes_equal_the_reference_native_writer(tmp_path):
    from mxnet_tpu.base import LIB
    assert LIB is not None, "the reference's native writer is not built"
    jr, ji = _write(jrec, tmp_path, "ref")
    tr, ti = _write(trec, tmp_path, "port")
    assert open(jr, "rb").read() == open(tr, "rb").read()
    assert open(ji).read() == open(ti).read()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["port_reads_reference", "reference_reads_port"])
def test_records_read_back_across_packages(tmp_path, writer, reader):
    rec, idx = _write(writer, tmp_path, "x")
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    want = _payloads()
    assert r.keys == list(range(len(want)))
    for i in reversed(range(len(want))):
        assert r.read_idx(i) == want[i]
    r.close()
    seq = reader.MXRecordIO(rec, "r")
    got = []
    while True:
        p = seq.read()
        if p is None:
            break
        got.append(p)
    assert got == want


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_pack_unpack_match_reference(label):
    h = (0, label, 7, 11)
    a, b = jrec.pack(h, b"payload"), trec.pack(h, b"payload")
    assert a == b
    (hj, pj), (ht, pt) = jrec.unpack(a), trec.unpack(b)
    assert pj == pt == b"payload"
    assert hj.flag == ht.flag and hj.id == ht.id and hj.id2 == ht.id2
    np.testing.assert_array_equal(np.asarray(hj.label), np.asarray(ht.label))


def test_npy_payload_of_pack_img_round_trips(monkeypatch):
    """The reference's ``pack_img`` without OpenCV writes ``.npy`` bytes;
    the port's ``unpack_img`` gives the array back exactly, and the port's
    ``pack_img`` (JPEG through its stage) unpacks to what the reference
    reads from the same record."""
    monkeypatch.setattr(jrec, "_cv2", lambda: None)
    img = smooth_image(np.random.RandomState(1), 20, 24)
    s = jrec.pack_img((0, 5.0, 1, 0), img)
    h, got = trec.unpack_img(s)
    assert h.label == 5.0
    np.testing.assert_array_equal(got, img)
    monkeypatch.setitem(sys.modules, "cv2", Cv2StandIn())
    monkeypatch.setattr(jrec, "_cv2", lambda: sys.modules["cv2"])
    s = trec.pack_img((0, 2.0, 3, 0), img, quality=95)
    assert trec.unpack(s)[1][:2] == b"\xff\xd8"
    (_, ours), (_, theirs) = trec.unpack_img(s, 1), jrec.unpack_img(s, 1)
    np.testing.assert_array_equal(ours, theirs)
    assert np.abs(ours.astype(int) - img).mean() < 3


# ---------------------------------------------------------------- pools --
@pytest.mark.parametrize("strategy,size,bucket", [
    ("Naive", 1000, 1000), ("Round", 1000, 1024),
    ("RoundMultiple", 1000, 4096)])
def test_storage_pool_size_classes_and_reuse(strategy, size, bucket):
    pool = StoragePool(strategy, pin_memory=False)
    a = pool.alloc(size)
    assert a.dtype == torch.uint8 and a.numel() == bucket
    ptr = a.data_ptr()
    pool.release(a)
    b = pool.alloc(size - 1)
    assert (b.data_ptr() == ptr) == (strategy != "Naive")
    st = pool.stats()
    assert st["n_alloc"] == 2 and st["n_pool_hit"] == int(strategy != "Naive")
    assert st["bytes_live"] == b.numel()
    pool.direct_free(b)
    assert pool.stats()["bytes_live"] == 0
    with pytest.raises(KeyError):
        pool.release(b)


# ------------------------------------------------------------ iterators --
def _epochs(it, n, reset=True):
    out = []
    for _ in range(n):
        for b in it:
            out.append(([as_np(d) for d in b.data],
                        [as_np(lab) for lab in b.label], b.pad))
        if reset:
            it.reset()
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(last, shuffle):
    rs = np.random.RandomState(2)
    data = rs.randn(11, 3, 2).astype(np.float32)
    label = rs.randint(0, 5, (11,)).astype(np.float32)
    got = []
    for io_mod in (jio, tio):
        np.random.seed(3)
        it = io_mod.NDArrayIter({"a": data, "b": data * 2}, label, 4,
                                shuffle=shuffle, last_batch_handle=last)
        got.append(_epochs(it, 3))
    _same(*got)


def test_csv_libsvm_mnist_iters_match_reference(tmp_path):
    import gzip
    rs = np.random.RandomState(4)
    d = rs.rand(7, 6).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", d, delimiter=",")
    np.savetxt(tmp_path / "l.csv", rs.randint(0, 3, (7, 1)), delimiter=",")
    with open(tmp_path / "s.svm", "w") as f:
        for i in range(6):
            f.write(f"{i % 2} 0:{rs.rand():.4f} 4:{rs.rand():.4f}\n")
    imgs = rs.randint(0, 256, (9, 5, 4), np.uint8)
    with gzip.open(tmp_path / "i.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 9, 5, 4) + imgs.tobytes())
    with open(tmp_path / "l.idx", "wb") as f:
        f.write(struct.pack(">II", 2049, 9) + bytes(range(9)))
    for make in (
            lambda m: m.CSVIter(str(tmp_path / "d.csv"), (2, 3),
                                label_csv=str(tmp_path / "l.csv"),
                                batch_size=3),
            lambda m: m.CSVIter(str(tmp_path / "d.csv"), (6,), batch_size=3,
                                round_batch=False),
            lambda m: m.LibSVMIter(str(tmp_path / "s.svm"), (5,),
                                   batch_size=4),
            lambda m: m.MNISTIter(str(tmp_path / "i.gz"),
                                  str(tmp_path / "l.idx"), batch_size=4),
            lambda m: m.MNISTIter(str(tmp_path / "i.gz"),
                                  str(tmp_path / "l.idx"), batch_size=4,
                                  flat=True)):
        _same(_epochs(make(jio), 2), _epochs(make(tio), 2))


def test_prefetching_and_resize_iters_match_reference():
    rs = np.random.RandomState(5)
    data = rs.randn(10, 3).astype(np.float32)
    got = []
    for m in (jio, tio):
        base = m.NDArrayIter(data, np.arange(10, dtype=np.float32), 3)
        pre = m.PrefetchingIter(base, buffer_size=2)
        a = _epochs(pre, 2)
        pre.close()
        b = _epochs(m.ResizeIter(m.NDArrayIter(data, None, 4), 5), 2)
        got.append(a + b)
    _same(*got)


def test_prefetching_iter_carries_the_source_error():
    def bad():
        yield tio.DataBatch([torch.zeros(1)], [torch.zeros(1)], pad=0)
        raise OSError("truncated")

    class Src(tio.DataIter):
        def __init__(self):
            super().__init__(1)
            self._g = bad()

        def next(self):
            return next(self._g)

    it = tio.PrefetchingIter(Src())
    next(it)
    with pytest.raises(OSError, match="truncated"):
        next(it)


def test_prefetch_to_device_on_the_cpu_gives_the_source_batches():
    rs = np.random.RandomState(6)
    src = [(rs.rand(2, 3).astype(np.float32), np.arange(2)) for _ in range(5)]
    got = list(tio.prefetch_to_device(iter(src), depth=2, device="cpu"))
    assert len(got) == 5
    for (x, y), (gx, gy) in zip(src, got):
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)


# ------------------------------------------------------------- DataFeed --
NORMS = [dict(), dict(mean=[10.0, 20.0, 30.0]),
         dict(mean=[123.68, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
         dict(scale=1 / 255.0, mean=[0.5, 0.4, 0.3], std=[0.2, 0.25, 0.3])]


@pytest.mark.parametrize("layout", [None, "NHWC"])
@pytest.mark.parametrize("norm", range(len(NORMS)))
def test_datafeed_finalize_matches_reference(norm, layout):
    """uint8 NCHW batches through both rings: every value fp32-equal."""
    rs = np.random.RandomState(7)
    batches = [(rs.randint(0, 256, (2, 3, 5, 4), np.uint8),
                rs.rand(2, 1).astype(np.float32), 0) for _ in range(3)]
    ref = mx.io.DataFeed(list(batches), depth=2, layout=layout,
                         **NORMS[norm])
    port = tio.DataFeed(list(batches), depth=2, device="cpu", layout=layout,
                        **NORMS[norm])
    a, b = list(ref), list(port)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert y.pad == x.pad
        want, got = x.data[0].asnumpy(), y.data[0].numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(y.label[0].numpy(),
                                      x.label[0].asnumpy())
    st = port.stats()
    assert st["staged_batches"] == 3 and st["consumed"] == 3
    assert st["h2d_bytes"] == 3 * (2 * 3 * 5 * 4 + 2 * 4)
    ref.close()
    port.close()


def _slow_source(n, started):
    for i in range(n):
        started.set()
        yield (np.full((2, 3, 4, 4), i, np.uint8),
               np.zeros((2, 1), np.float32), 0)


def _within(fn, seconds=LIVENESS_S):
    """Run ``fn`` on a thread; fail unless it ends within ``seconds``."""
    err = []

    def run():
        try:
            fn()
        except BaseException as e:   # noqa: BLE001 — re-raised below
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]


@pytest.mark.parametrize("action", ["close", "reset"])
def test_datafeed_close_and_reset_mid_epoch_do_not_deadlock(action):
    """A full ring with a blocked producer, then ``close()`` or
    ``reset()``: both return, and after ``reset()`` the epoch starts
    over from batch 0."""
    started = threading.Event()

    class Src:
        def __init__(self):
            self.resets = 0

        def __iter__(self):
            return _slow_source(50, started)

        def reset(self):
            self.resets += 1

    src = Src()
    feed = tio.DataFeed(src, depth=2, device="cpu")

    def body():
        started.wait(LIVENESS_S)
        first = next(feed)
        assert float(first.data[0][0, 0, 0, 0]) == 0.0
        if action == "close":
            feed.close()
            with pytest.raises(RuntimeError, match="closed"):
                next(feed)
        else:
            feed.reset()
            assert src.resets == 1
            again = next(feed)
            assert float(again.data[0][0, 0, 0, 0]) == 0.0
            assert feed.position() == {"epoch": 1, "batch": 1}
            feed.close()
    _within(body)


def test_datafeed_raises_the_source_error_and_syncs_at_depth_0():
    def bad():
        yield (np.zeros((1, 3, 2, 2), np.uint8), np.zeros((1, 1),
                                                          np.float32), 0)
        raise ValueError("corrupt record")

    for depth in (0, 2):
        feed = tio.DataFeed(bad(), depth=depth, device="cpu")
        next(feed)
        with pytest.raises(ValueError, match="corrupt record"):
            next(feed)
        assert feed.stats()["sync_mode"] == (depth == 0)
        feed.close()
