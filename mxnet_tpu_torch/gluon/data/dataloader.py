"""DataLoader (≙ ``gluon/data/dataloader.py``): batches of a dataset,
built in the caller's thread, in a thread pool, or in worker processes.

- ``num_workers == 0``: batches are built in the caller's thread.
- ``num_workers > 0``: a pool of worker processes made with the
  ``spawn`` method, so no worker inherits the parent's threads or its
  CUDA context.  The dataset and the batchify function go to each worker
  once, pickled, when the pool starts (a dataset or a batchify that
  cannot be pickled, or samples that are CUDA tensors, take the thread
  pool instead).  Workers batchify to numpy (``default_mp_batchify_fn``)
  and hand each batch back through POSIX shared memory, so the pixels
  are never pickled.  Workers run host code only: under a script, the
  pool needs the script's ``if __name__ == "__main__"`` guard, as any
  ``spawn`` pool does.
- ``thread_pool=True``: a thread pool (for datasets that do their work
  in native code that drops the GIL, or that cannot be pickled).

Batches are host ``torch`` tensors; ``pin_memory=True`` pins them where
a card is present, and ``pipeline=True`` (or ``MXNET_DATAFEED=1``)
stages them to ``device`` (default the current card) through
``io.DataFeed``.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import torch

from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a host tensor batch (≙ ``Stack``)."""
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    if isinstance(data[0], torch.Tensor):
        return torch.stack(data)
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return torch.from_numpy(onp.ascontiguousarray(arr))


def default_mp_batchify_fn(data):
    """A worker's stack, to numpy."""
    if isinstance(data[0], tuple):
        return tuple(default_mp_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    if isinstance(data[0], torch.Tensor):
        data = [d.numpy() for d in data]
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return arr


# ------------------------------------------------- worker process plumbing
# set in each worker by _worker_init from the pickled arguments
_worker_dataset = None
_worker_batchify = None
_worker_shm_prefix = None


def _worker_init(dataset, batchify, shm_prefix):
    global _worker_dataset, _worker_batchify, _worker_shm_prefix
    _worker_dataset = dataset
    _worker_batchify = batchify
    _worker_shm_prefix = shm_prefix


def _to_shm(tree):
    """numpy tree → shared-memory descriptors (name, shape, dtype)."""
    from multiprocessing import resource_tracker, shared_memory
    if isinstance(tree, tuple):
        return ("__tuple__",) + tuple(_to_shm(t) for t in tree)
    arr = onp.ascontiguousarray(tree)
    name = f"{_worker_shm_prefix}-{uuid.uuid4().hex[:12]}"
    shm = shared_memory.SharedMemory(name=name, create=True,
                                     size=max(arr.nbytes, 1))
    onp.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    # the parent unlinks the segment once it has copied it out
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return ("__shm__", name, arr.shape, str(arr.dtype))


def _from_shm(desc, pin):
    """Shared-memory descriptors → host tensor tree (the parent's)."""
    from multiprocessing import shared_memory
    if desc[0] == "__tuple__":
        return tuple(_from_shm(d, pin) for d in desc[1:])
    _, name, shape, dtype = desc
    shm = shared_memory.SharedMemory(name=name)
    try:
        view = onp.ndarray(shape, dtype, buffer=shm.buf)
        out = torch.empty(tuple(shape), dtype=torch.from_numpy(
            onp.empty(0, dtype)).dtype, pin_memory=pin)
        out.numpy()[...] = view
        del view
    finally:
        shm.close()
        shm.unlink()
    return out


def _unlink_shm(desc):
    """Free the segments of a batch nobody will take."""
    from multiprocessing import shared_memory
    if desc[0] == "__tuple__":
        for d in desc[1:]:
            _unlink_shm(d)
        return
    try:
        shm = shared_memory.SharedMemory(name=desc[1])
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


def _worker_fn(indices):
    samples = [_worker_dataset[i] for i in indices]
    return _to_shm(_worker_batchify(samples))


def _pin(tree):
    if isinstance(tree, torch.Tensor):
        return tree.pin_memory()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pin(t) for t in tree)
    return tree


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=False, timeout=120,
                 pipeline=None, device=None):
        self._dataset = dataset
        if pipeline is None:
            pipeline = os.environ.get("MXNET_DATAFEED", "0").lower() \
                in ("1", "true", "datafeed")
        self._pipeline = bool(pipeline)
        self._device = device
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn
        self._num_workers = num_workers
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._pin = bool(pin_memory) and torch.cuda.is_available()
        self._prefetch = max(prefetch if prefetch is not None
                             else 2 * num_workers, 0)
        self._pool = None        # worker processes, built at first use
        self._mp_ok = None
        self._shm_prefix = f"mxtshm-{os.getpid()}-{id(self):x}"

    def __del__(self):
        self._shutdown_pool()

    def close(self):
        """Stop the worker processes (idempotent)."""
        self._shutdown_pool()

    def _shutdown_pool(self):
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.terminate()
            pool.join()

    def _sweep_shm(self):
        """Unlink segments left by killed workers (named with this
        loader's prefix, so nothing else can be hit)."""
        try:
            names = os.listdir("/dev/shm")
        except OSError:
            return
        for n in names:
            if n.startswith(self._shm_prefix + "-"):
                try:
                    os.unlink(os.path.join("/dev/shm", n))
                except OSError:
                    pass

    def _make_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        batch = (self._batchify_fn or default_batchify_fn)(samples)
        return _pin(batch) if self._pin else batch

    def __iter__(self):
        if self._pipeline:
            from ...io.datafeed import DataFeed
            feed = DataFeed(self._iter_host(), device=self._device,
                            name="dataloader")
            try:
                yield from feed
            finally:
                feed.close()
            return
        yield from self._iter_host()

    def _iter_host(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        if self._thread_pool or not self._mp_safe():
            yield from self._iter_threads()
        else:
            yield from self._iter_processes()

    def _mp_safe(self):
        """Worker processes need samples on the host and a dataset and
        batchify that pickle; the verdict is probed once."""
        if self._mp_ok is None:
            def host_only(x):
                if isinstance(x, torch.Tensor):
                    return not x.is_cuda
                if isinstance(x, (tuple, list)):
                    return all(host_only(v) for v in x)
                return True
            try:
                pickle.dumps((self._dataset, self._batchify_fn))
                self._mp_ok = host_only(self._dataset[0])
            except (pickle.PicklingError, AttributeError, TypeError):
                self._mp_ok = False
        return self._mp_ok

    # ------------------------------------------------------ thread workers
    def _iter_threads(self):
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = queue.Queue(maxsize=max(self._prefetch,
                                              self._num_workers))
            stop = threading.Event()
            it = iter(self._batch_sampler)

            def fill():
                for indices in it:
                    fut = pool.submit(self._make_batch, indices)
                    while not stop.is_set():
                        try:
                            futures.put(fut, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                futures.put(None)

            filler = threading.Thread(target=fill, daemon=True)
            filler.start()
            try:
                while True:
                    fut = futures.get()
                    if fut is None:
                        break
                    yield fut.result()
            finally:
                stop.set()
                filler.join(timeout=10)

    # ----------------------------------------------------- process workers
    def _iter_processes(self):
        batchify = self._batchify_fn or default_mp_batchify_fn
        if self._pool is None:
            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(
                self._num_workers, initializer=_worker_init,
                initargs=(self._dataset, batchify, self._shm_prefix))
        pool = self._pool
        it = iter(self._batch_sampler)
        pending = OrderedDict()     # submit order → AsyncResult
        nxt = 0
        submitted = 0
        depth = max(self._prefetch, self._num_workers)

        def submit_one():
            nonlocal submitted
            try:
                indices = next(it)
            except StopIteration:
                return False
            pending[submitted] = pool.apply_async(_worker_fn,
                                                  (list(indices),))
            submitted += 1
            return True

        try:
            for _ in range(depth):
                if not submit_one():
                    break
            while pending:
                desc = pending[nxt].get(self._timeout)
                del pending[nxt]
                nxt += 1
                submit_one()
                yield _from_shm(desc, self._pin)
        finally:
            # drain what is in flight (an early exit or an error), so no
            # segment outlives the loader; a hung worker gets the pool
            # killed and its segments swept by name
            stuck = False
            budget = max(10.0, 2.0 * len(pending))
            if self._timeout is not None:
                budget = min(budget, self._timeout)
            deadline = time.monotonic() + budget
            for res in pending.values():
                try:
                    _unlink_shm(res.get(max(deadline - time.monotonic(),
                                            0.1)))
                except multiprocessing.TimeoutError:
                    stuck = True
                except Exception:   # noqa: BLE001 — the worker raised;
                    pass            # its batch made no segment
            pending.clear()
            if stuck:
                self._shutdown_pool()
                self._sweep_shm()

    def __len__(self):
        return len(self._batch_sampler)
