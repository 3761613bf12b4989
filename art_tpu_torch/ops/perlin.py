"""Hash-based gradient Perlin noise (``art_tpu/ops/perlin.py:17-113``).

The reference's permutation-table-free noise (wanghash + spatial mix,
reference src/perlin.cuh:6-82) over planes of points.  The uint32 hash
arithmetic runs on int64 tensors holding uint32 values, masked to 32 bits
after every multiply (PyTorch's ``torch.uint32`` lacks most arithmetic on
the CPU); every partial product stays below 2^62.

This module is the plain twin of the turbulence kernel
(``csrc/perlin.cuh``, ``csrc/turb.cu``), which rounds the same float32
operations in the same order, so the two agree bit for bit on every device.
One deliberate definition: the lattice coordinate ``floor(p)`` is cast to
int32 saturating, NaN to INT_MIN (``_lattice``).  C++ leaves an
out-of-range float-to-int cast undefined, CUDA's ``cvt`` saturates and x86
PyTorch gives INT_MIN; a miss's point (p ≈ o + 1e30 d) reaches it, and
the kernel and the twin clamp alike, which changes no point with
|p| < 2^31.  Negative lattice coordinates wrap to uint32 as
``astype(uint32)`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.core.vecmath import sqrt

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# (h >> 8) * U2M11_SCALE - 1 maps 24 hash bits onto [-1, 1] (src/perlin.cuh:18-21)
U2M11_SCALE = float(np.float32(1.0 / 8388607.5))
_I32_MIN = -2147483648.0
_I32_LIMIT = 2147483648.0  # 2^31: the first float32 past INT_MAX
TURB_DEPTH = 7  # noise_texture's turb(p, 7) (src/texture.cuh:69)


def wanghash(x: torch.Tensor) -> torch.Tensor:
    """Wang hash on uint32 values in int64 tensors (src/perlin.cuh:6-13)."""
    x = x & _MASK32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _MASK32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _MASK32
    return x ^ (x >> 15)


def mix3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Spatial lattice hash (src/perlin.cuh:14-16); int32 or int64 lattice
    coordinates, negative ones wrapped to uint32."""
    x, y, z = (c.to(torch.int64) & _MASK32 for c in (x, y, z))
    return (((x * 73856093) & _MASK32) ^ ((y * 19349663) & _MASK32)
            ^ ((z * 83492791) & _MASK32))


def u2m11(h: torch.Tensor) -> torch.Tensor:
    """uint32 -> [-1, 1] from the upper 24 bits (exact in float32)."""
    return ((h >> 8) & 0x00FFFFFF).to(torch.float32) * U2M11_SCALE - 1.0


def grad_p(xi, yi, zi):
    """Pseudo-random unit gradient per lattice point (src/perlin.cuh:28-32),
    a 3-tuple of planes."""
    h = wanghash(mix3(xi, yi, zi))
    gx = u2m11(h)
    gy = u2m11(wanghash(h))
    gz = u2m11(wanghash(h ^ _GOLDEN))
    # sqrt correctly rounded on every device, as CUDA's sqrtf
    inv = torch.reciprocal(sqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30)))
    return gx * inv, gy * inv, gz * inv


def _lattice(f: torch.Tensor) -> torch.Tensor:
    """floor(p) (float32) -> int64 holding the saturated int32, NaN -> INT_MIN."""
    f = torch.where(f >= _I32_MIN, f, _I32_MIN)  # NaN fails the test
    return torch.clamp_max(torch.clamp_max(f, _I32_LIMIT).to(torch.int64), 2147483647)


def _smooth(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def noise_p(px, py, pz) -> torch.Tensor:
    """Gradient noise over component planes (src/perlin.cuh:34-70)."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    i, j, k = _lattice(fx), _lattice(fy), _lattice(fz)
    uu, vv, ww = _smooth(u), _smooth(v), _smooth(w)
    accum = torch.zeros_like(px)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                gx, gy, gz = grad_p(i + di, j + dj, k + dk)
                s = ((uu if di else (1.0 - uu)) * (vv if dj else (1.0 - vv))
                     * (ww if dk else (1.0 - ww)))
                accum = accum + s * (gx * (u - di) + gy * (v - dj) + gz * (w - dk))
    return accum


def turb_p(px, py, pz, depth: int, depth_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Turbulence |sum_{i<depth} 0.5^i noise(2^i p)| (src/perlin.cuh:72-82).

    ``depth_mask`` (optional (R,) int32) zeroes the octaves at index >= the
    point's own count, so textures of different depths share one pass."""
    accum = torch.zeros_like(px)
    weight = 1.0
    for i in range(depth):
        term = weight * noise_p(px, py, pz)
        if depth_mask is not None:
            term = torch.where(i < depth_mask, term, 0.0)
        accum = accum + term
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)
