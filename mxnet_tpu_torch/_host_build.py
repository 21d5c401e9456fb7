"""Build and bind the host decode stage of ``csrc_host/`` (the input
path's native code: image decode, encode and resize, and the image
loader of ``io.NativeImageRecordIter``).

At its first use, ``csrc_host/dataio.cc`` is compiled by ``g++ -O3``
into ``build/mxnet_tpu_torch/libmxnet_tpu_torch_dataio.so`` at the root
of the checkout and loaded with ``ctypes``, whose calls drop the GIL.
Which JPEG library it binds is decided here, once, by what the machine
has:

- libjpeg (``jpeglib.h`` and ``-ljpeg``): decode and encode on the
  host's worker threads;
- else nvJPEG (``nvjpeg.h`` and ``libnvjpeg`` under ``CUDA_HOME``, by
  default ``/usr/local/cuda``): decode on the card (the native loader
  batches a ticket's JPEGs into one call) and encode with its encoder;
- else none: decoding or encoding a JPEG raises, naming both libraries.

PNG goes through zlib (``zlib.h`` and ``-lz``) where it is found, and
raises, naming zlib, where it is not.  A stamp file holds a hash of the
sources and the command, so an unchanged checkout reuses its library; a
file lock keeps concurrent processes from building over each other.
``import mxnet_tpu_torch`` builds nothing.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

from ._build import BUILD_DIR

__all__ = ["build", "lib", "check", "info", "LIB_PATH", "SOURCES"]

_PKG = Path(__file__).resolve().parent
CSRC_HOST = _PKG / "csrc_host"
SOURCES = (CSRC_HOST / "dataio.cc",)
HEADERS = (CSRC_HOST / "recordio_format.h",)
LIB_PATH = BUILD_DIR / "libmxnet_tpu_torch_dataio.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "mxt_backend_info": [ctypes.c_char_p, ctypes.c_size_t],
    # buf, len, flag, out (uint8**), h, w, c
    "mxt_imdecode": [_P, ctypes.c_size_t, _I, ctypes.POINTER(_U8P),
                     ctypes.POINTER(_I), ctypes.POINTER(_I),
                     ctypes.POINTER(_I)],
    # src, h, w, c, fmt (0 jpeg, 1 png), quality, out, len
    "mxt_imencode": [_P, _I, _I, _I, _I, _I, ctypes.POINTER(_U8P),
                     ctypes.POINTER(ctypes.c_size_t)],
    # src, sh, sw, c, dst, dh, dw, interp
    "mxt_imresize_u8": [_P, _I, _I, _I, _P, _I, _I, _I],
    "mxt_imresize_f32": [_P, _I, _I, _I, _P, _I, _I, _I],
    # rec, idx, batch, c, h, w, resize, shuffle, seed, threads, mirror,
    # rand_crop, label_width, prefetch, out_dtype, backend, claim_window,
    # out handle
    "mxt_loader_create": [ctypes.c_char_p, ctypes.c_char_p] + [_I] * 6 +
                         [ctypes.c_uint64] + [_I] * 6 + [ctypes.c_char_p,
                                                         _I,
                                                         ctypes.POINTER(_P)],
    # handle, data, is_u8, label, n_valid
    "mxt_loader_next": [_P, _P, _I, _P, ctypes.POINTER(_I)],
    "mxt_loader_stats": [_P, ctypes.c_char_p, ctypes.c_size_t],
    "mxt_loader_stats_reset": [_P],
    "mxt_loader_reset": [_P],
    "mxt_loader_free": [_P],
}

_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _has_header(cxx: str, header: str, extra: List[str] = ()) -> bool:
    """Whether ``#include <header>`` preprocesses with ``cxx``."""
    try:
        r = subprocess.run([cxx, "-x", "c++", "-E", "-", *extra],
                           input=f"#include <{header}>\n", text=True,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


def _command(cxx: str, out: Path) -> List[str]:
    """The compile command for this machine: the JPEG library by the
    module's rule, zlib where it is found."""
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           "-Wall", f"-I{CSRC_HOST}"]
    libs: List[str] = []
    cuda = _cuda_home()
    if _has_header(cxx, "jpeglib.h"):
        cmd.append("-DMXT_JPEG_LIBJPEG")
        libs.append("-ljpeg")
    elif (cuda / "include" / "nvjpeg.h").exists() and \
            any((cuda / d).glob("libnvjpeg.so*")
                for d in ("lib64", "lib")):
        lib_dir = next(str(cuda / d) for d in ("lib64", "lib")
                       if any((cuda / d).glob("libnvjpeg.so*")))
        cmd += ["-DMXT_JPEG_NVJPEG", f"-I{cuda / 'include'}"]
        libs += [f"-L{lib_dir}", f"-Wl,-rpath,{lib_dir}", "-lnvjpeg",
                 "-lcudart"]
    if _has_header(cxx, "zlib.h"):
        cmd.append("-DMXT_WITH_ZLIB")
        libs.append("-lz")
    return cmd + [str(s) for s in SOURCES] + ["-o", str(out)] + libs


def _cxx(what: str = "the host decode stage (csrc_host/dataio.cc)") -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"),
                 shutil.which("c++")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"g++ not found: {what} is built at first use")


def stamped_build(lib_path: Path, tag: str, what: str, command,
                  inputs, force: bool = False) -> Path:
    """Compile ``command(out)`` (an argv that writes the library to
    ``out``) into ``lib_path`` unless the stamp ``<tag>.sha256`` holds the
    hash of that command and of ``inputs``' bytes; → ``lib_path``.  The
    compiler writes a private temporary that is renamed over the library,
    under the file lock ``<tag>.lock``, so a concurrent process neither
    builds over this one nor loads a half-written file.  A failed build
    raises with the command and the compiler's output; the last build's
    are in ``<tag>_build.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib_path.name}.{os.getpid()}"
    cmd = command(tmp)
    h = hashlib.sha256(" ".join(cmd).replace(str(tmp), "").encode())
    for src in inputs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    want = h.hexdigest()
    stamp = BUILD_DIR / f"{tag}.sha256"
    with open(BUILD_DIR / f"{tag}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not force and lib_path.exists() and stamp.exists() and \
                stamp.read_text() == want:
            return lib_path
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {what} failed:\n" +
                               " ".join(cmd) + "\n" + r.stdout)
        os.replace(tmp, lib_path)
        stamp.write_text(want)
        (BUILD_DIR / f"{tag}_build.log").write_text(
            " ".join(cmd) + "\n" + r.stdout)
        return lib_path


def build(force: bool = False) -> Path:
    """Compile ``csrc_host/dataio.cc`` into :data:`LIB_PATH` unless the
    stamped library matches the sources and the command; → its path."""
    cxx = _cxx()
    return stamped_build(LIB_PATH, "dataio", "the host decode stage",
                         lambda out: _command(cxx, out), SOURCES + HEADERS,
                         force)


def lib() -> ctypes.CDLL:
    """The decode stage's library, built and loaded on first call."""
    global _lib
    with _mu:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mxt_last_error.argtypes = []
            handle.mxt_last_error.restype = ctypes.c_char_p
            handle.mxt_free.argtypes = [_P]
            handle.mxt_free.restype = None
            _lib = handle
        return _lib


def check(rc: int):
    """Raise the decode stage's error when a call returned non-zero."""
    if rc != 0:
        raise RuntimeError(_lib.mxt_last_error().decode())


def info() -> dict:
    """``{"jpeg": "libjpeg" | "nvjpeg" | "none", "jpeg_version",
    "png", "zlib"}`` of the built stage."""
    buf = ctypes.create_string_buffer(256)
    L = lib()
    check(L.mxt_backend_info(buf, ctypes.sizeof(buf)))
    return json.loads(buf.value.decode())
