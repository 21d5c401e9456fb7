"""mx.io for the port — the legacy ``DataIter`` interface (≙
``mxnet_tpu/io/__init__.py``): ``DataDesc``, ``DataBatch``, the in-memory
and file iterators (``NDArrayIter``, ``CSVIter``, ``LibSVMIter``,
``MNISTIter``), ``ImageRecordIter`` over the python decode tier or the
native loader (``NativeImageRecordIter``, the host decode stage's worker
threads), the ``PrefetchingIter`` / ``ResizeIter`` wrappers, and
``prefetch_to_device``.

Batches are ``torch`` tensors on the host; ``DataFeed``
(``io/datafeed.py``) and ``prefetch_to_device`` move them to the card
through pinned buffers on a copy stream of their own.
"""
from __future__ import annotations

import collections
import ctypes
import gzip
import json
import os
import queue as _q
import struct
import sys
import threading

import numpy as np
import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ImageRecordIter", "PrefetchingIter",
           "ResizeIter", "MXDataIter", "prefetch_to_device",
           "NativeImageRecordIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """≙ ``io.DataDesc``: name and shape, with ``dtype`` and ``layout``."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        self = super().__new__(cls, name, tuple(shape))
        self.dtype = dtype
        self.layout = layout
        return self


class DataBatch:
    """≙ ``io.DataBatch``: lists of data and label tensors, ``pad`` and
    ``index``."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [tuple(getattr(d, "shape", ())) for d in (self.data or [])]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """≙ ``io.DataIter``: the ``next`` / ``reset`` / iterator protocol."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        raise StopIteration

    def __next__(self):
        return self.next()

    @property
    def provide_data(self):
        return None

    @property
    def provide_label(self):
        return None


def _asnp(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_list_of_pairs(data, default_name):
    """data as a tensor, an array, a dict or a list → [(name, array)]."""
    if data is None:
        return []
    if isinstance(data, (torch.Tensor, np.ndarray)):
        return [(default_name, data)]
    if isinstance(data, dict):
        return sorted(data.items())
    if isinstance(data, (list, tuple)):
        return [(f"{default_name}_{i}" if i else default_name, d)
                for i, d in enumerate(data)]
    raise TypeError(f"unsupported data type {type(data)}")


class NDArrayIter(DataIter):
    """≙ ``io.NDArrayIter``: batches of in-memory arrays, with shuffle
    (numpy's global generator) and ``pad`` / ``discard`` / ``roll_over``
    for the last batch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = [(k, _asnp(v)) for k, v in
                     _to_list_of_pairs(data, data_name)]
        self.label = [(k, _asnp(v)) for k, v in
                      _to_list_of_pairs(label, label_name)]
        self.num_data = self.data[0][1].shape[0]
        for _, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise ValueError("inconsistent first dim")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._roll_over_idx = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.label]

    def reset(self):
        self.idx = np.arange(self.num_data)
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self._roll_over_idx is not None:
            self.idx = np.concatenate([self._roll_over_idx, self.idx])
            self._roll_over_idx = None
        self.cursor = 0

    def next(self):
        n = len(self.idx)
        if self.cursor >= n:
            raise StopIteration
        end = self.cursor + self.batch_size
        sel = self.idx[self.cursor:end]
        pad = 0
        if end > n:
            if self.last_batch_handle == "discard":
                self.cursor = n
                raise StopIteration
            if self.last_batch_handle == "roll_over":
                self._roll_over_idx = sel
                self.cursor = n
                raise StopIteration
            pad = end - n
            sel = np.concatenate([sel, self.idx[:pad]])
        self.cursor = end
        data = [torch.from_numpy(v[sel]) for _, v in self.data]
        label = [torch.from_numpy(v[sel]) for _, v in self.label]
        return DataBatch(data=data, label=label, pad=pad, index=sel,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class CSVIter(NDArrayIter):
    """≙ ``src/io/iter_csv.cc``: a CSV file of rows of ``data_shape``."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0], 1), np.float32)
        super().__init__(data, label, batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard", **kwargs)


class LibSVMIter(NDArrayIter):
    """≙ ``src/io/iter_libsvm.cc``: libsvm text rows, made dense."""

    def __init__(self, data_libsvm, data_shape, batch_size=1, **kwargs):
        feats, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(tuple(data_shape), np.float32)
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    row[int(k)] = float(v)
                feats.append(row)
        super().__init__(np.stack(feats), np.asarray(labels, np.float32),
                         batch_size, **kwargs)


class MNISTIter(NDArrayIter):
    """≙ ``src/io/iter_mnist.cc``: the idx-ubyte MNIST files (gzipped or
    not), images in [0, 1], NHWC unless ``flat``."""

    def __init__(self, image, label, batch_size=1, shuffle=False,
                 flat=False, **kwargs):
        def _open(p):
            return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")

        with _open(image) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad MNIST image magic {magic}")
            imgs = np.frombuffer(f.read(), dtype=np.uint8)
            imgs = imgs.reshape(num, rows, cols).astype(np.float32) / 255.0
        with _open(label) as f:
            magic, num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad MNIST label magic {magic}")
            labs = np.frombuffer(f.read(), dtype=np.uint8).astype(np.float32)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs[..., None]
        super().__init__(imgs, labs, batch_size, shuffle=shuffle, **kwargs)


_AUG_KEYS = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
             "std", "brightness", "contrast", "saturation", "hue",
             "pca_noise", "rand_gray", "inter_method")

# the augmentations the native loader implements; any other routes the
# DataFeed path through the python decode tier
_NATIVE_AUG_KEYS = {"resize", "rand_crop", "rand_mirror", "mean", "std",
                    "mean_r", "mean_g", "mean_b", "std_r", "std_g",
                    "std_b", "seed", "path_imgidx"}


def _channel_spec(kwargs, name, fill):
    """The per-channel ``mean`` / ``std``, from the array argument or the
    reference's ``mean_r`` / ``mean_g`` / ``mean_b`` spelling."""
    v = kwargs.get(name)
    if v is None and any(k in kwargs for k in
                         (f"{name}_r", f"{name}_g", f"{name}_b")):
        v = [kwargs.get(f"{name}_r", fill), kwargs.get(f"{name}_g", fill),
             kwargs.get(f"{name}_b", fill)]
    return v


def ImageRecordIter(path_imgrec, data_shape, batch_size, label_width=1,
                    shuffle=False, preprocess_threads=4, prefetch_buffer=2,
                    dtype="float32", pipeline=None, **kwargs):
    """≙ ``src/io/iter_image_recordio_2.cc``: an image iterator over a
    ``.rec`` file.  ``data_shape`` is (C, H, W), as the reference's;
    batches are NHWC.  By default the python decode tier
    (``image.ImageIter``) behind a ``PrefetchingIter``.

    ``pipeline="datafeed"`` (or ``MXNET_DATAFEED=1``) routes onto
    ``DataFeed``: the native loader on a uint8 wire into the device
    staging ring, the cast and normalize on the card; the python tier
    feeds the ring instead when an augmentation the native loader lacks
    is asked for.
    """
    from .. import image as _image
    c, h, w = data_shape
    if pipeline is None:
        pipeline = os.environ.get("MXNET_DATAFEED", "0").lower() \
            in ("1", "true", "datafeed")
    if pipeline:
        return _datafeed_record_iter(
            path_imgrec, data_shape, batch_size, label_width, shuffle,
            preprocess_threads, prefetch_buffer, kwargs)
    aug_kwargs = {k: v for k, v in kwargs.items() if k in _AUG_KEYS}
    if "mean" not in aug_kwargs:
        mean = _channel_spec(kwargs, "mean", 0.0)
        if mean is not None:
            aug_kwargs["mean"] = mean
    if "std" not in aug_kwargs:
        std = _channel_spec(kwargs, "std", 1.0)
        if std is not None:
            aug_kwargs["std"] = std
            # std without mean still normalizes in the reference
            aug_kwargs.setdefault("mean", [0.0, 0.0, 0.0])
    it = _image.ImageIter(batch_size, (h, w, c), label_width=label_width,
                          path_imgrec=path_imgrec, shuffle=shuffle,
                          preprocess_threads=preprocess_threads,
                          dtype=dtype, **aug_kwargs)
    return PrefetchingIter(it, buffer_size=prefetch_buffer)


def _datafeed_record_iter(path_imgrec, data_shape, batch_size,
                          label_width, shuffle, preprocess_threads,
                          prefetch_buffer, kwargs):
    """``ImageRecordIter``'s ``pipeline="datafeed"`` route, keeping the
    NHWC float32 batch contract."""
    from .datafeed import DataFeed, _env_int

    c, h, w = data_shape
    mean = _channel_spec(kwargs, "mean", 0.0)
    std = _channel_spec(kwargs, "std", 1.0)
    device = kwargs.pop("device", None)
    workers = _env_int("MXNET_DATAFEED_WORKERS",
                       max(1, int(preprocess_threads or 1)))
    depth = _env_int("MXNET_DATAFEED_DEPTH", max(2, int(prefetch_buffer)))
    if set(kwargs) <= _NATIVE_AUG_KEYS and not isinstance(mean, bool):
        src = NativeImageRecordIter(
            path_imgrec, (c, h, w), batch_size,
            label_width=label_width, shuffle=shuffle,
            preprocess_threads=workers,
            prefetch_buffer=max(2, int(prefetch_buffer)),
            resize=int(kwargs.get("resize", -1)),
            rand_mirror=bool(kwargs.get("rand_mirror", False)),
            rand_crop=bool(kwargs.get("rand_crop", False)),
            seed=int(kwargs.get("seed", 0)),
            path_imgidx=kwargs.get("path_imgidx"),
            dtype="uint8")
        return DataFeed(src, depth=depth, device=device, mean=mean, std=std,
                        layout="NHWC")
    it = ImageRecordIter(path_imgrec, data_shape, batch_size,
                         label_width=label_width, shuffle=shuffle,
                         preprocess_threads=preprocess_threads,
                         prefetch_buffer=prefetch_buffer,
                         pipeline=False, **kwargs)
    return DataFeed(it, depth=depth, device=device)


class PrefetchingIter(DataIter):
    """≙ ``src/io/iter_prefetcher.h``: a background thread keeps
    ``buffer_size`` batches ready.  ``reset`` and ``close`` stop it at any
    point; an error of the base iterator is raised from ``next``."""

    def __init__(self, iters, buffer_size=2):
        self._base = iters
        super().__init__(getattr(iters, "batch_size", 0))
        self._buffer_size = buffer_size
        self._queue = None
        self._thread = None
        self._start()

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def _start(self):
        self._queue = _q.Queue(maxsize=self._buffer_size)
        self._stop = object()
        self._abandoned = threading.Event()
        self._err = None
        queue, stop, abandoned = self._queue, self._stop, self._abandoned

        def put(item):
            while not abandoned.is_set():
                try:
                    queue.put(item, timeout=0.1)
                    return
                except _q.Full:
                    continue

        def worker():
            try:
                for batch in self._base:
                    put(batch)
                    if abandoned.is_set():
                        return
            except BaseException as e:  # carried to the consumer
                if not sys.is_finalizing():
                    self._err = e
            finally:
                put(stop)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _join_worker(self):
        """Stop the producer even mid-epoch: flag it, drain the queue so
        a blocked put wakes, and join."""
        if self._thread is None:
            return
        self._abandoned.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except _q.Empty:
                self._thread.join(timeout=0.05)
        self._thread = None

    def reset(self):
        self._join_worker()
        self._base.reset()
        self._start()

    def close(self):
        """Stop the prefetch thread (idempotent)."""
        self._join_worker()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, RuntimeError):
            pass

    def next(self):
        item = self._queue.get()
        if item is self._stop:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item


class ResizeIter(DataIter):
    """≙ ``io.ResizeIter``: cap or extend an iterator to ``size``
    batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


MXDataIter = DataIter


class _DeviceCopier:
    """Host tensors to ``device`` on a copy stream of their own, from
    pinned sources (CPU: a plain ``to``)."""

    def __init__(self, device):
        from ..context import resolve
        self.device = resolve(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def copy(self, t):
        if not self.cuda:
            return t.to(self.device)
        src = t if t.is_pinned() else t.pin_memory()
        with torch.cuda.stream(self.stream):
            out = src.to(self.device, non_blocking=True)
        return out

    def fence(self):
        """An event after every copy so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


def _adopt(device, event, item):
    """The current stream of ``device`` waits for ``event`` (a copy
    stream's, None on the CPU) and owns ``item``'s tensors from here, so
    the caching allocator does not hand their memory to the copy stream
    while the consumer reads them; → ``item``."""
    if event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for t in _tensors(item):
            t.record_stream(cur)
    return item


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, DataBatch):
        return _tensors(list(x.data or [])) + _tensors(list(x.label or []))
    return []


def prefetch_to_device(it, depth=2, device=None):
    """Overlap host batch production and the copy to the card with
    compute: a background thread walks ``it`` and copies each batch
    (tensors, arrays, tuples or lists of them, or a ``DataBatch``)
    ``depth`` batches ahead, from pinned memory on a copy stream; the
    consumer's stream waits on the copy's event before it reads."""
    copier = _DeviceCopier(device)

    def to_dev(x):
        if isinstance(x, torch.Tensor):
            return copier.copy(x)
        if isinstance(x, DataBatch):
            x.data = [to_dev(v) for v in x.data]
            x.label = [to_dev(v) for v in (x.label or [])]
            return x
        if isinstance(x, (tuple, list)):
            return type(x)(to_dev(v) for v in x)
        arr = np.asarray(x)
        if arr.dtype == object:
            return x          # a payload that is not numbers rides along
        return copier.copy(torch.from_numpy(np.ascontiguousarray(arr)))

    q = _q.Queue(maxsize=depth)
    stop = object()
    abandoned = threading.Event()
    err = []

    def put(item):
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except _q.Full:
                continue

    def worker():
        try:
            for batch in it:
                item = to_dev(batch)
                put((item, copier.fence()))
                if abandoned.is_set():
                    return
        except BaseException as e:
            err.append(e)
        finally:
            put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is stop:
                break
            item, ev = got
            yield _adopt(copier.device, ev, item)
        if err:
            raise err[0]
    finally:
        abandoned.set()
        try:
            while True:
                q.get_nowait()
        except _q.Empty:
            pass


class NativeImageRecordIter(DataIter):
    """The native image loader (≙ the reference's C++ data tier over
    ``src/dataio.cc``) on the port's host decode stage: W worker threads
    with their own file handles decode, resize the short side
    (``resize``), crop (center, or random with ``rand_crop``), mirror
    (``rand_mirror``) and stack NCHW batches (float32, or uint8 for
    ``DataFeed``'s wire) outside Python.  Needs the ``.idx`` beside the
    ``.rec``.  ``decode`` ("auto", "libjpeg" or "nvjpeg"; default
    ``MXNET_DATAFEED_DECODE``) must name the stage's JPEG library or
    "auto".  A sample's randomness is seeded by (seed, epoch, index), so
    a batch does not depend on scheduling.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, preprocess_threads=4, prefetch_buffer=2,
                 resize=-1, rand_mirror=False, rand_crop=False, seed=0,
                 path_imgidx=None, dtype="float32", decode=None,
                 claim_window=None):
        from .. import _host_build
        from .datafeed import _env_int
        if dtype not in ("float32", "uint8"):
            raise ValueError("dtype must be 'float32' or 'uint8', got %r"
                             % (dtype,))
        if decode is None:
            decode = os.environ.get("MXNET_DATAFEED_DECODE", "auto")
        if claim_window is None:
            claim_window = _env_int("MXNET_DATAFEED_CLAIM_WINDOW", 0)
        super().__init__(batch_size)
        c, h, w = data_shape
        self._shape = (batch_size, c, h, w)
        self._label_width = label_width
        self._dtype = dtype
        idx = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        self._hb = _host_build
        self._lib = _host_build.lib()
        self._h = ctypes.c_void_p()
        _host_build.check(self._lib.mxt_loader_create(
            path_imgrec.encode(), idx.encode(), batch_size, c, h, w,
            int(resize), int(bool(shuffle)), int(seed),
            int(preprocess_threads), int(bool(rand_mirror)),
            int(bool(rand_crop)), int(label_width), int(prefetch_buffer),
            1 if dtype == "uint8" else 0, str(decode).encode(),
            int(claim_window), ctypes.byref(self._h)))

    def close(self):
        """Stop the workers and free the loader (idempotent)."""
        h, self._h = getattr(self, "_h", None), None
        if h and h.value:
            self._lib.mxt_loader_free(h)

    def __del__(self):
        self.close()

    @property
    def dtype(self):
        """The batches' dtype: "float32" or "uint8"."""
        return self._dtype

    @property
    def provide_data(self):
        return [DataDesc("data", self._shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label",
                         (self._shape[0], self._label_width))]

    def reset(self):
        self._hb.check(self._lib.mxt_loader_reset(self._h))

    def stats(self):
        """The loader's per-stage counters as a dict (read / decode /
        augment / batchify µs, samples, queue depth, backpressure and
        consumer waits, decode backend, DCT scales)."""
        buf = ctypes.create_string_buffer(2048)
        self._hb.check(self._lib.mxt_loader_stats(self._h, buf,
                                                   ctypes.sizeof(buf)))
        return json.loads(buf.value.decode())

    def stats_reset(self):
        """Zero the cumulative counters (the queue and epoch stay)."""
        self._hb.check(self._lib.mxt_loader_stats_reset(self._h))

    def next_raw(self, out=None):
        """One batch as ``(data, label, pad)`` numpy arrays, NCHW; ``out``
        (a uint8 host tensor of at least the batch's bytes, such as a
        pinned staging buffer) receives the data when given."""
        b, c, h, w = self._shape
        label = np.empty((b, self._label_width), np.float32)
        n_valid = ctypes.c_int(0)
        dt = np.uint8 if self._dtype == "uint8" else np.float32
        if out is not None:
            nbytes = b * c * h * w * np.dtype(dt).itemsize
            data = out[:nbytes].numpy().view(dt).reshape(b, c, h, w)
        else:
            data = np.empty((b, c, h, w), dt)
        self._hb.check(self._lib.mxt_loader_next(
            self._h, data.ctypes.data, int(dt == np.uint8),
            label.ctypes.data, ctypes.byref(n_valid)))
        if n_valid.value == 0:
            raise StopIteration
        return data, label, b - n_valid.value

    def next(self):
        data, label, pad = self.next_raw()
        return DataBatch(data=[torch.from_numpy(data)],
                         label=[torch.from_numpy(label)], pad=pad)


from .datafeed import DataFeed          # noqa: E402  (needs DataBatch)

__all__ += ["DataFeed"]
