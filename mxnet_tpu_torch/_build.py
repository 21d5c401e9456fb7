"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The kernels are plain CUDA C++ with a C interface.  At the first launch
on a CUDA tensor, each ``csrc/*.cu`` file is compiled by its own
``nvcc`` process (all started together) for ``sm_90a``, the objects are
linked into ``build/mxnet_tpu_torch/libmxnet_tpu_torch_kernels.so`` at
the root of the checkout, and the library is loaded with ``ctypes``.
A stamp file holds a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an unchanged
checkout reuses its library; a file lock keeps concurrent processes from
building over each other.  ``import mxnet_tpu_torch`` builds nothing.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["build", "lib", "check", "BUILD_DIR", "LIB_PATH", "SOURCES",
           "HEADERS"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
LIB_PATH = BUILD_DIR / "libmxnet_tpu_torch_kernels.so"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
# headers the sources include: hashed with them, so an edit rebuilds
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, gamma, beta, y, rows, C, eps, vec4, stream
    "mxt_layernorm_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, _P],
    # q, k, v, o, B, H, Lq, Lk, D, q/k/v/o strides (3 x int64 each),
    # scale, stream
    "mxt_causal_attention_f32": [_P, _P, _P, _P] + [ctypes.c_int] * 5 +
                                [_P] * 4 + [ctypes.c_float, _P],
    # q, k, v, o, lse, B, H, Lq, Lk, D, q/k/v/o strides, scale, stream
    "mxt_attention_fwd_f32": [_P] * 5 + [ctypes.c_int] * 5 + [_P] * 4 +
                             [ctypes.c_float, _P],
    # q, k, v, g, lse, delta, dq, B, H, Lq, Lk, D, q/k/v/g/dq strides,
    # scale, stream
    "mxt_attention_dq_f32": [_P] * 7 + [ctypes.c_int] * 5 + [_P] * 5 +
                            [ctypes.c_float, _P],
    # q, k, v, g, lse, delta, dk, dv, B, H, Lq, Lk, D,
    # q/k/v/g/dk/dv strides, scale, stream
    "mxt_attention_dkv_f32": [_P] * 8 + [ctypes.c_int] * 5 + [_P] * 6 +
                             [ctypes.c_float, _P],
    # D, out (int*)
    "mxt_attention_dq_blocks_per_sm": [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)],
    "mxt_attention_dkv_blocks_per_sm": [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)],
    # x, w, gamma, beta, mean, var, res, part, out, N, H, W, C, Cout, eps,
    # relu, bn, ranges, vec, stream
    "mxt_conv_affine_f32": [_P] * 9 + [ctypes.c_int] * 5 +
                           [ctypes.c_float] + [ctypes.c_int] * 4 + [_P],
    # bn, vec, out (int*)
    "mxt_conv_affine_tc_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)],
    # the same arguments for bf16 x, w, res, out and bf16 or fp32 gamma,
    # beta, mean, var, with vf32 (their fp32 bits) after relu
    "mxt_conv_affine_bf16": [_P] * 9 + [ctypes.c_int] * 5 +
                            [ctypes.c_float] + [ctypes.c_int] * 5 + [_P],
    "mxt_conv_affine_bf16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)],
    # and for fp16 (fp16 or fp32 vectors)
    "mxt_conv_affine_f16": [_P] * 9 + [ctypes.c_int] * 5 +
                           [ctypes.c_float] + [ctypes.c_int] * 5 + [_P],
    "mxt_conv_affine_f16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)],
    # x, w, part, out, N, H, W, C, Cout, bn, ranges, vec, stream
    "mxt_conv3x3_tc_f32": [_P] * 4 + [ctypes.c_int] * 8 + [_P],
    # bn, vec, out (int*)
    "mxt_conv3x3_tc_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)],
    # the same arguments for bf16 x, w, out
    "mxt_conv3x3_tc_bf16": [_P] * 4 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv3x3_bf16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)],
    "mxt_conv3x3_tc_f16": [_P] * 4 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv3x3_f16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)],
    # x, w, part, z, tstats, stats, N, H, W, C, Cout, bn, ranges, vec,
    # stream
    "mxt_conv_stats_tc_f32": [_P] * 6 + [ctypes.c_int] * 8 + [_P],
    # bn, vec, out (int*)
    "mxt_conv_stats_tc_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)],
    # the same arguments for bf16 x, w, z
    "mxt_conv_stats_tc_bf16": [_P] * 6 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv_stats_bf16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)],
    "mxt_conv_stats_tc_f16": [_P] * 6 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv_stats_f16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)],
    # x, dy, part, dw, N, H, W, C, Cout, bn, ranges, jmax, vec, stream
    "mxt_conv_wgrad_f32": [_P] * 4 + [ctypes.c_int] * 9 + [_P],
    # bn, vec, out (int*)
    "mxt_conv_wgrad_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)],
    # the same arguments for bf16 x, dy (dw fp32)
    "mxt_conv_wgrad_bf16": [_P] * 4 + [ctypes.c_int] * 9 + [_P],
    "mxt_conv_wgrad_bf16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)],
    "mxt_conv_wgrad_f16": [_P] * 4 + [ctypes.c_int] * 9 + [_P],
    "mxt_conv_wgrad_f16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)],
    # the wgmma kernels on bf16 (C % 8 == 0, Cout % 8 == 0): x, w, part,
    # out, N, H, W, C, Cout, bn, ranges, stream
    "mxt_conv3x3_wgmma_bf16": [_P] * 4 + [ctypes.c_int] * 7 + [_P],
    # bn, vec (1), out (int*)
    "mxt_conv3x3_wgmma_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)],
    # x, dy, part, dw, N, H, W, C, Cout, bn, ranges, jmax, stream
    "mxt_conv_wgrad_wgmma_bf16": [_P] * 4 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv_wgrad_wgmma_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)],
    # x, w, part, z, tstats, stats, N, H, W, C, Cout, bn, ranges, stream
    "mxt_conv_stats_wgmma_bf16": [_P] * 6 + [ctypes.c_int] * 7 + [_P],
    "mxt_conv_stats_wgmma_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)],
    # x, w, gamma, beta, mean, var, res, part, out, N, H, W, C, Cout, eps,
    # relu, vf32 (the vectors given in fp32: 1 gamma, 2 beta, 4 mean, 8
    # var), bn, ranges, stream
    "mxt_conv_affine_wgmma_bf16": [_P] * 9 + [ctypes.c_int] * 5 +
                                  [ctypes.c_float] + [ctypes.c_int] * 4 +
                                  [_P],
    "mxt_conv_affine_wgmma_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)],
    # the fp16 instances of the four wgmma entries, the same arguments
    "mxt_conv3x3_wgmma_f16": [_P] * 4 + [ctypes.c_int] * 7 + [_P],
    "mxt_conv_wgrad_wgmma_f16": [_P] * 4 + [ctypes.c_int] * 8 + [_P],
    "mxt_conv_stats_wgmma_f16": [_P] * 6 + [ctypes.c_int] * 7 + [_P],
    "mxt_conv_affine_wgmma_f16": [_P] * 9 + [ctypes.c_int] * 5 +
                                 [ctypes.c_float] + [ctypes.c_int] * 4 +
                                 [_P],
    "mxt_conv3x3_wgmma_f16_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)],
    "mxt_conv_wgrad_wgmma_f16_blocks_per_sm": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "mxt_conv_stats_wgmma_f16_blocks_per_sm": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "mxt_conv_affine_wgmma_f16_blocks_per_sm": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    # out (int64[3]): the wgmma kernels' tensor-map cache hits, misses,
    # entries
    "mxt_wgmma_map_cache_stats": [ctypes.POINTER(ctypes.c_longlong)],
    # z, scale, shift, res, out, total, Cout, relu, vec, stream
    "mxt_bn_affine_f32": [_P] * 5 + [ctypes.c_longlong] +
                         [ctypes.c_int] * 3 + [_P],
    # the same for bf16 z, res, out (scale, shift fp32), and for fp16
    "mxt_bn_affine_bf16": [_P] * 5 + [ctypes.c_longlong] +
                          [ctypes.c_int] * 3 + [_P],
    "mxt_bn_affine_f16": [_P] * 5 + [ctypes.c_longlong] +
                         [ctypes.c_int] * 3 + [_P],
    # x, y, rows, cols, vec, prologue, div, keep, rows a mask row, stream
    "mxt_softmax_f32": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_float, _P,
                        ctypes.c_longlong, _P],
    # the same for bf16 and fp16 x, y (vec 1 or 8)
    "mxt_softmax_bf16": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_float, _P,
                         ctypes.c_longlong, _P],
    "mxt_softmax_f16": [_P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_float, _P,
                        ctypes.c_longlong, _P],
    # cols, vec, out (int[3]: kernel, cluster CTAs, columns a CTA)
    "mxt_softmax_plan": [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)],
    # qx, wt, scale, shift, res, part, out, N, H, W, C, Cout, relu, bn,
    # ranges, grain, vec, stream
    "mxt_qconv_affine_s8": [_P] * 7 + [ctypes.c_int] * 10 + [_P],
    # bn, vec, out (int*)
    "mxt_qconv_affine_blocks_per_sm": [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)],
}

_mu = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last compile in this process took, and its ptxas report
last_build_s = 0.0
last_build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH):"
                       " the CUDA kernels are built at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into :data:`LIB_PATH` unless the stamped
    library matches the sources; return its path."""
    global last_build_s, last_build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamp = BUILD_DIR / "sources.sha256"
    want = _digest()
    with open(BUILD_DIR / "lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not force and LIB_PATH.exists() and stamp.exists() and \
                stamp.read_text() == want:
            return LIB_PATH
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for src in SOURCES:
            obj = BUILD_DIR / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" +
                               "\n".join(logs))
        tmp = BUILD_DIR / f".{LIB_PATH.name}.{os.getpid()}"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp)] +
            [str(BUILD_DIR / (s.stem + ".o")) for s in SOURCES],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, LIB_PATH)
        stamp.write_text(want)
        last_build_s = time.perf_counter() - t0
        last_build_log = "\n".join(logs)
        (BUILD_DIR / "build.log").write_text(last_build_log)
        return LIB_PATH


def lib() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _lib
    with _mu:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mxt_error_string.argtypes = [ctypes.c_int]
            handle.mxt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        name = _lib.mxt_error_string(err).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {err} ({name}) at launch")
