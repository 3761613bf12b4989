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

K13 (``csrc/sphere_static.cu``) is the one kernel built apart:
``static_libraries`` compiles it once per scene and quadratic form, with the
scene's spheres in a generated header (``static_header``: the cells of
``tables.sph_static_cells`` as ``__device__`` tables of exact float32 hex
literals, ``static_table``), into a shared
library named by a hash of the header, the sources and the flags, and
records the ``nvcc`` seconds.  A build error raises.

``launches`` counts kernel launches per wrapper name; each wrapper adds
one where it launches its kernel (``launch``; ``chip_smoke.py`` reads and
resets it).  It is the recorder's kernel counter
(``utils/tracing.py KERNELS``), which also files each launch under the open
layer.  Building or loading a library is the recorder's ``library`` span.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import math
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from art_tpu_torch.utils import tracing
from art_tpu_torch.utils.tracing import KERNELS as launches, launch  # noqa: F401 (re-exported)

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

STATIC_SOURCE = "sphere_static.cu"  # built per scene by static_libraries, not library()
BLOCK = 256  # threads per block (csrc/common.cuh kBlock) of all kernels but K2's and K9's
LIBRARY = tracing.span("library")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (each returns cudaGetLastError() as int)
_SIGNATURES = {
    "art_sphere_hit": [_P, _I, _I, ctypes.c_float, _P, ctypes.POINTER(_P), _P],
    "art_sphere_skip": [_P, _P, _I, _I, _I, ctypes.c_float, _P, _P, _P, ctypes.POINTER(_P),
                        _P],
    "art_sphere_cellbin": [_P, _P, _I, _I, _I, ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_box_cluster": [_P, _P, _I, _I, ctypes.c_float, _I, ctypes.POINTER(_P), _P],
    "art_refill": [ctypes.POINTER(_P), _I, _I, _I, _I, ctypes.POINTER(_L),
                   ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, _P],
    "art_refill_flush": [ctypes.POINTER(_P), _I, _I, _I, _I, ctypes.POINTER(_L),
                         ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
                         ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, _P, _I, _P, _P],
    "art_flush_dead": [ctypes.POINTER(_P), _I, _P, _I, _P, _P],
    "art_shade_flush": [ctypes.POINTER(_P), _I, ctypes.POINTER(ctypes.c_float),
                        _I, _I, _I, _P],
    "art_shade_flush_baked": [ctypes.POINTER(_P), _I, _P, _I,
                              ctypes.POINTER(ctypes.c_float), _I, _I, _I, _P],
    "art_quad_hit": [_P, _P, _I, _I, ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_box_hit": [_P, _I, _I, ctypes.c_float, _I, _I, ctypes.POINTER(_P), _P],
    "art_turb": [_P, _P, _P, _P, _P, _I, _I, _P],
    "art_sp_step": [ctypes.POINTER(_P), _I, _I, _I, _I, ctypes.POINTER(_L),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_uint, ctypes.c_uint,
                    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                    ctypes.POINTER(ctypes.c_float), _I, _I, _I, _P, _I, _P, _I, _P, _I, _P],
    "art_flush_accumulate": [_P, _P, ctypes.POINTER(_P), _I, _P, _I, _P, _I, _P],
    "art_compact": [_P, _I, ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _P, _P, _P, _P,
                    ctypes.c_uint, _P],
    "art_table_gather": [_P, _I, _P, _P, _I, _P],
    "art_atlas_fetch": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "art_box_grid": [_P, _I, _I, ctypes.POINTER(ctypes.c_float), _I, ctypes.c_float,
                     ctypes.POINTER(_P), _P],
    "art_sphere_mxu": [_P, _P, _I, _I, ctypes.POINTER(_P), _P],
    "art_box_grid_cells": [_P, _I, _I, _I, ctypes.POINTER(ctypes.c_float), _I,
                           ctypes.c_float, ctypes.POINTER(_P), _P],
    "art_box_grid_cells_form": [_I, _I],
    "art_media": [_P, _I, _I, ctypes.c_float, _L, ctypes.POINTER(_P), _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _units() -> list[Path]:
    """The shared library's translation units (every ``.cu`` but K13's)."""
    return [p for p in sorted(CSRC.glob("*.cu")) if p.name != STATIC_SOURCE]


def _sources() -> list[Path]:
    return _units() + sorted(CSRC.glob("*.cuh"))


def _digest(parts) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, data in parts:
        digest.update(name.encode())
        digest.update(data)
    return digest.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    with LIBRARY:
        return _library()


def _library() -> ctypes.CDLL:
    so = BUILD_DIR / "libart_kernels_{}.so".format(
        _digest((src.name, src.read_bytes()) for src in _sources()))
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _units()]
        jobs = [[nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for obj, src in zip(objs, _units())]
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


def _hex(x: float) -> str:
    """An exact C++17 float literal of the float32 value ``x``."""
    if x == 0.0:
        return "-0.0f" if math.copysign(1.0, x) < 0 else "0.0f"
    if not math.isfinite(x):
        raise ValueError(f"K13's cells must be finite, got {x}")
    mant, exp = x.hex().split("p")
    return f"{mant.rstrip('0').rstrip('.')}p{exp}f"


def _f32(rows, width: int) -> np.ndarray:
    return np.asarray(rows, np.float32).reshape(-1, width)


def static_table(cells: tuple, tail_r: float, tail_mat: float) -> dict:
    """K13's compiled-in table of one scene's cells (``scene/builder.
    static_sphere_cells``: moving, main, tail), the rows in that order as
    float32 arrays: ``c`` (N, 4) (cx0, cy0, cz0, r2), ``k`` (N,) K = |c|^2 -
    r^2 (0 on a moving row), ``v`` (M, 4) (vx, vy, vz, 0) of the M moving
    rows, ``rm`` (N, 2) (r, mat), the tail's radius and material on a tail
    row; ``n_moving`` and ``vel_mask`` (bit k: some moving row has a nonzero
    velocity component k)."""
    moving, main, tail = cells
    v = _f32([(r[3], r[4], r[5], 0.0) for r in moving], 4)
    return dict(
        c=_f32([(r[0], r[1], r[2], r[8]) for r in moving]
               + [(r[0], r[1], r[2], r[5]) for r in main]
               + [(r[0], r[1], r[2], r[3]) for r in tail], 4),
        k=_f32([0.0] * len(moving) + [r[6] for r in main] + [r[4] for r in tail], 1)[:, 0],
        v=v,
        rm=_f32([(r[6], r[7]) for r in moving] + [(r[3], r[4]) for r in main]
                + [(tail_r, tail_mat)] * len(tail), 2),
        n_moving=len(moving),
        vel_mask=sum(1 << k for k in range(3) if bool((v[:, k] != 0.0).any())))


def static_header(cells: tuple, tail_r: float, tail_mat: float) -> str:
    """The per-scene header of ``csrc/sphere_static.cu``: ``static_table``'s
    arrays as ``__device__`` tables of exact float32 literals
    (``art_static_c``, ``art_static_k``, ``art_static_v``,
    ``art_static_rm``; an empty one holds a single zero row) and its counts
    (``ART_STATIC_N_MOVING``, ``ART_STATIC_N_ROWS``,
    ``ART_STATIC_VEL_MASK``)."""
    tab = static_table(cells, tail_r, tail_mat)
    lines = ["// K13's cells for one scene, written by art_tpu_torch/ops/_build.py",
             "#pragma once",
             f"#define ART_STATIC_N_MOVING {tab['n_moving']}",
             f"#define ART_STATIC_N_ROWS {len(tab['c'])}",
             f"#define ART_STATIC_VEL_MASK {tab['vel_mask']}u"]
    for name, ctype, rows in (("c", "float4", tab["c"]), ("k", "float", tab["k"][:, None]),
                              ("v", "float4", tab["v"]), ("rm", "float2", tab["rm"])):
        rows = rows if len(rows) else np.zeros((1, rows.shape[1]), np.float32)
        lines.append(f"__device__ const {ctype} art_static_{name}[{len(rows)}] = {{")
        lines += ["  " + ("{" + ", ".join(_hex(float(x)) for x in row) + "}" if ctype != "float"
                         else _hex(float(row[0]))) + "," for row in rows]
        lines.append("};")
    return "\n".join(lines) + "\n"


_STATIC_LIBS: dict = {}  # (id(cells), expand) -> (cells, library)


def static_libraries(jobs) -> list:
    """K13 built for each ``(cells, tail_r, tail_mat, expand)`` of ``jobs``:
    one scene's ``tables.sph_static_cells`` and tail in the direct
    (``expand`` False) or expanded quadratic form.  A library is named under
    ``_build/`` by a hash of its ``static_header``, the sources and the
    flags; those not built yet are compiled by one ``nvcc`` each, all
    started together.  Within the process a library is found again by its
    cells object.  ``build_seconds`` on a library is the nvcc time this
    process spent on it (0 if it was built before)."""
    with LIBRARY:
        return _static_libraries(jobs)


def _static_libraries(jobs) -> list:
    libs, todo = [None] * len(jobs), []
    for k, (cells, tail_r, tail_mat, expand) in enumerate(jobs):
        hit = _STATIC_LIBS.get((id(cells), expand))
        if hit is not None and hit[0] is cells:
            libs[k] = hit[1]
            continue
        header = static_header(cells, tail_r, tail_mat)
        flags = NVCC_FLAGS + (f"-DART_STATIC_EXPAND={int(expand)}",)
        digest = _digest([("flags", " ".join(flags).encode()), ("header", header.encode())]
                         + [(p.name, p.read_bytes()) for p in _static_sources()])
        todo.append((k, cells, expand, header, flags, BUILD_DIR / f"libart_static_{digest}.so"))
    builds = list({job[-1]: job for job in todo if not job[-1].exists()}.values())
    seconds, procs, tmps = {}, [], []
    t0 = time.perf_counter()
    try:
        for _, _, _, header, flags, so in builds:
            inc = so.with_suffix(f".{os.getpid()}.inc")  # the header and nvcc's messages
            inc.mkdir(parents=True, exist_ok=True)
            (inc / "sphere_static_cells.h").write_text(header)
            tmps.append(so.with_suffix(f".{os.getpid()}.tmp"))
            cmd = [nvcc_path(), *flags, "-shared", "-I", str(inc), "-o", str(tmps[-1]),
                   str(CSRC / STATIC_SOURCE)]
            with open(inc / "nvcc.err", "w") as err:
                procs.append((so, cmd, inc, subprocess.Popen(cmd, stdout=err, stderr=err)))
        while len(seconds) < len(procs):  # each build's own seconds
            for so, _, _, proc in procs:
                if so not in seconds and proc.poll() is not None:
                    seconds[so] = time.perf_counter() - t0
            time.sleep(0.02)
        failed = [f"nvcc failed ({' '.join(cmd)}):\n{(inc / 'nvcc.err').read_text()}"
                  for _, cmd, inc, proc in procs if proc.returncode]
        if failed:
            raise RuntimeError("\n".join(failed))
        for (_, _, _, _, _, so), tmp in zip(builds, tmps):
            os.replace(tmp, so)
    finally:
        for _, _, inc, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(inc, ignore_errors=True)
        for tmp in tmps:
            tmp.unlink(missing_ok=True)
    for k, cells, expand, _, _, so in todo:
        lib = ctypes.CDLL(str(so))
        lib.build_seconds = seconds.get(so, 0.0)
        lib.art_sphere_static.argtypes = [_I, ctypes.POINTER(_P), _P]
        lib.art_sphere_static.restype = ctypes.c_int
        _STATIC_LIBS[(id(cells), expand)] = (cells, lib)
        libs[k] = lib
    return libs


@functools.lru_cache(maxsize=None)
def _static_sources() -> tuple:
    return (CSRC / STATIC_SOURCE, *sorted(CSRC.glob("*.cuh")))


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
