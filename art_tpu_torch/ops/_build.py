"""Build and load the port's CUDA kernels (``art_tpu_torch/csrc/*.cu``).

At first use the sources are compiled with ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per ``.cu`` file, all started together — and linked into one
shared library with a plain C interface under ``art_tpu_torch/_build/``
(named by a hash of the sources and flags, so an edit rebuilds), and loaded
with ``ctypes``.  Nothing here runs at import time.

``-fmad=false`` keeps the compiler from contracting ``a*b+c`` into FMAs, so
every kernel rounds the same primitive ops as its plain PyTorch twin and
as ``art_tpu``; ``--use_fast_math`` is off for the same reason.  With FMAs
the sphere kernel ran 16% faster alone but the render no faster (the loop
is host-bound), and its contracted ``b*b - a*c`` moved grazing hits' t by up
to 1.1% from the twin's (PERF.md, "FMA contraction").

``launches`` counts kernel launches per wrapper name; each wrapper adds
one where it launches its kernel (``chip_smoke.py`` reads and resets it).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

BLOCK = 256  # threads per block of every kernel (csrc/common.cuh kBlock)
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
_SIGNATURES = {
    "art_sphere_hit": [_P, _I, _I, ctypes.c_float, _P, ctypes.POINTER(_P), _P],
    "art_sphere_skip": [_P, _P, _I, _I, _I, ctypes.c_float, _P, ctypes.POINTER(_P), _P],
    "art_sphere_cellbin": [_P, _P, _I, _I, _I, ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_sphere_cluster": [_P, _P, _I, _I, ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_box_cluster": [_P, _P, _I, _I, ctypes.c_float, _I, ctypes.POINTER(_P), _P],
    "art_refill": [ctypes.POINTER(_P), _I, _I, _I, _I, ctypes.POINTER(_L),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, _P],
    "art_shade_flush": [ctypes.POINTER(_P), _I, ctypes.POINTER(ctypes.c_float),
                        _I, _I, _I, _P],
    "art_shade_flush_baked": [ctypes.POINTER(_P), _I, _P, _I,
                              ctypes.POINTER(ctypes.c_float), _I, _I, _I, _P],
    "art_quad_hit": [_P, _I, _I, ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_box_hit": [_P, _I, _I, ctypes.c_float, _I, ctypes.POINTER(_P), _P],
    "art_turb": [_P, _P, _P, _P, _P, _I, _I, _P],
    "art_sp_step": [ctypes.POINTER(_P), _I, _I, _I, _I, ctypes.POINTER(_L),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
                    ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_float), _I, _I,
                    _I, _P, _I, _P, _I, _P, _I, _P],
    "art_flush_accumulate": [_P, _P, ctypes.POINTER(_P), _I, _P, _I, _P, _I, _P],
    "art_table_gather": [_P, _I, _P, _P, _I, _P],
    "art_box_grid": [_P, _I, _I, ctypes.POINTER(ctypes.c_float), _I, ctypes.c_float,
                     ctypes.POINTER(_P), _P],
    "art_box_grid_cells": [_P, _I, _I, ctypes.POINTER(ctypes.c_float), _I,
                           ctypes.c_float, ctypes.POINTER(_P), _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libart_kernels_{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
        jobs = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objs, sorted(CSRC.glob("*.cu")))]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in jobs]
        errs = [p.communicate()[1] for p in procs]  # waits for every nvcc
        failed = [f"nvcc failed ({' '.join(cmd)}):\n{err}"
                  for cmd, p, err in zip(jobs, procs, errs) if p.returncode]
        try:
            if failed:
                raise RuntimeError("\n".join(failed))
            cmd = [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    lib.build_seconds = seconds  # nvcc time in this process; 0 if cached
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers, null for None (callers
    keep the tensors)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check_planes(names, tensors, n: int, dtype, device) -> None:
    """Raise unless every tensor is a contiguous (n,) ``dtype`` on ``device``."""
    for name, t in zip(names, tensors):
        if t.device != device or t.dtype != dtype or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous ({n},) {dtype} tensor on {device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )


def check_flush(fb: torch.Tensor, lost: torch.Tensor, device) -> None:
    """Raise unless ``fb`` is a contiguous (P, 3) float32 framebuffer and
    ``lost`` a (1,) int32 counter on ``device``."""
    if fb.dim() != 2 or fb.shape[1] != 3 or fb.dtype != torch.float32 \
            or fb.device != device or not fb.is_contiguous():
        raise ValueError(f"fb: need a contiguous (P, 3) float32 tensor on {device}")
    check_planes(("lost",), (lost,), 1, torch.int32, device)


def check_table(name: str, t: torch.Tensor, cols: int, device) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous (n, cols) float32 table on
    ``device``; returns it."""
    if t.device != device or t.dtype != torch.float32 or t.dim() != 2 \
            or t.shape[1] != cols or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (n, {cols}) float32 tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    return t
