"""gluon.utils for the port (≙ ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``
and ``download`` (retries, a sha1 check, an atomic rename; ``file://``
URLs serve air-gapped mirrors)."""
from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
from typing import List

import torch

from .. import context as _context
from ..ops import nn as _nn

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice: int, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis`` (the
    last takes the remainder); with ``even_split`` an uneven cut
    raises."""
    n = data.shape[batch_axis]
    if even_split and n % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}")
    step = n // num_slice
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step,
                                (i + 1) * step if i < num_slice - 1 else n)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list: List, batch_axis=0, even_split=True):
    """≙ ``gluon.utils.split_and_load``: a batch cut into one slice a
    device of ``ctx_list``, each slice on its device."""
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(data)
    if len(ctx_list) == 1:
        return [data.to(_context.resolve(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.to(_context.resolve(ctx)) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """≙ ``gluon.utils.clip_global_norm``: every tensor of ``arrays``
    scaled in place by min(1, max_norm / ‖all‖₂) → the norm (a float)."""
    clipped, total = _nn.clip_global_norm(list(arrays), max_norm)
    with torch.no_grad():
        for a, c in zip(arrays, clipped):
            a.copy_(c)
    total = float(total)
    if check_isfinite and not torch.isfinite(torch.tensor(total)):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    return total


def check_sha1(filename, sha1_hash):
    """Whether the sha1 of ``filename`` starts with ``sha1_hash`` (a full
    digest or a prefix), read in 1 MiB chunks."""
    h = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest().startswith(sha1_hash)


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """≙ ``gluon.utils.download``: ``url`` fetched to ``path`` (a file or
    a directory; default the URL's last component), ``retries``
    attempts, each checked against ``sha1_hash`` when one is given, the
    file renamed into place only whole (a per-process partial name, so
    concurrent downloaders never truncate each other's).  An existing
    file whose sha1 matches is kept unless ``overwrite``.  ``file://``
    URLs read a local mirror.  ``verify_ssl`` is accepted and ignored,
    as in the reference."""
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])

    def sha_ok(f):
        return sha1_hash is None or check_sha1(f, sha1_hash)

    if os.path.exists(fname) and not overwrite and sha_ok(fname):
        return fname
    tmp = f"{fname}.part.{os.getpid()}"
    last = None
    try:
        for attempt in range(max(1, retries)):
            try:
                urllib.request.urlretrieve(url, tmp)
                if not sha_ok(tmp):
                    os.unlink(tmp)
                    last = RuntimeError(
                        f"sha1 mismatch for {url} (attempt {attempt + 1})")
                    continue
                os.replace(tmp, fname)
                return fname
            except Exception as e:      # noqa: PERF203 — retry loop
                last = e
        raise RuntimeError(
            f"download of {url} failed after {retries} attempts "
            f"(offline environment?): {last}") from last
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
