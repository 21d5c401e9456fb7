"""Pretrained-weight store (≙ ``mxnet_tpu/models/model_store.py``).

Local first: weights live under ``$MXNET_TPU_HOME/models`` (default
``~/.mxnet_tpu/models``, the JAX package's store, so both packages read
one) as the ``{name}.params`` archives ``Block.save_parameters`` writes.
``get_model_file`` resolves a name there (sha1-checked when one is
registered), else downloads it from the weight repository
``MXNET_GLUON_REPO`` (a ``file://`` mirror serves air-gapped
installs); ``publish_model_file`` installs a file into the store.  A
missing file raises with the path to provision.
"""
from __future__ import annotations

import hashlib
import os
import shutil

__all__ = ["get_model_file", "publish_model_file", "purge", "data_dir",
           "register_model_sha1", "repo_url", "short_hash"]

# name -> sha1 of the registered artifact (filled as weights are published
# or registered from a repository manifest)
_model_sha1 = {}


def register_model_sha1(name, sha1):
    """Pin a model's expected sha1."""
    _model_sha1[name] = sha1


def repo_url():
    """Base URL of the weight repository: ``MXNET_GLUON_REPO``, else
    ``MXNET_TPU_REPO``, else empty (none)."""
    return os.environ.get("MXNET_GLUON_REPO",
                          os.environ.get("MXNET_TPU_REPO", ""))


def data_dir():
    return os.environ.get(
        "MXNET_TPU_HOME", os.path.join(os.path.expanduser("~"),
                                       ".mxnet_tpu"))


def _models_dir(root=None):
    return os.path.join(root or data_dir(), "models")


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError(f"model {name} has no registered checksum")
    return _model_sha1[name][:8]


def _check_sha1(filename, sha1_hash):
    from ..gluon.utils import check_sha1
    return check_sha1(filename, sha1_hash)


def get_model_file(name, root=None):
    """``name``'s params: the local store first, then the weight
    repository (``MXNET_GLUON_REPO``; a sha1-checked download with
    retries)."""
    d = _models_dir(root)
    sha1 = _model_sha1.get(name)
    for suffix in (".params", ".params.npz"):
        path = os.path.join(d, name + suffix)
        if os.path.exists(path):
            if sha1 and not _check_sha1(path, sha1):
                raise OSError(
                    f"{path} exists but its sha1 does not match the "
                    f"registered checksum; delete it and re-provision")
            return path
    repo = repo_url()
    if repo:
        from ..gluon.utils import download
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name + ".params")
        return download(f"{repo.rstrip('/')}/models/{name}.params",
                        path=path, sha1_hash=sha1)
    raise FileNotFoundError(
        f"pretrained weights for {name!r} not found under {d} and no "
        "weight repository is configured. Set MXNET_GLUON_REPO to a "
        "mirror (file:///path works offline), provision with "
        f"mx.models.model_store.publish_model_file({name!r}, <path>), or "
        "copy a .params file there manually")


def publish_model_file(name, path, root=None, register_sha1=True):
    """Install a params file into the local store (and register its
    sha1) → the installed path."""
    d = _models_dir(root)
    os.makedirs(d, exist_ok=True)
    suffix = ".params.npz" if path.endswith(".npz") else ".params"
    dst = os.path.join(d, name + suffix)
    shutil.copyfile(path, dst)
    if register_sha1:
        sha1 = hashlib.sha1()
        with open(dst, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha1.update(chunk)
        _model_sha1[name] = sha1.hexdigest()
    return dst


def purge(root=None):
    """Remove the store's model directory."""
    d = _models_dir(root)
    if os.path.isdir(d):
        shutil.rmtree(d)
