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


# corner n of a cell: (di, dj, dk) = (n >> 2, (n >> 1) & 1, n & 1)
_CORNERS = tuple((n >> 2, (n >> 1) & 1, n & 1) for n in range(8))


def _cell(px, py, pz):
    """One octave's cell of each point: lattice corner (i, j, k), fractions
    (u, v, w) and their smoothsteps."""
    fx, fy, fz = torch.floor(px), torch.floor(py), torch.floor(pz)
    u, v, w = px - fx, py - fy, pz - fz
    return (_lattice(fx), _lattice(fy), _lattice(fz)), (u, v, w), tuple(map(_smooth, (u, v, w)))


def _add_corner(accum, n: int, uvw, smooth, g):
    """accum + corner n's weighted dot with gradient g."""
    (di, dj, dk), (u, v, w), (uu, vv, ww) = _CORNERS[n], uvw, smooth
    s = (uu if di else (1.0 - uu)) * (vv if dj else (1.0 - vv)) * (ww if dk else (1.0 - ww))
    return accum + s * (g[0] * (u - di) + g[1] * (v - dj) + g[2] * (w - dk))


def _corner_grads(ijk):
    """The eight corner gradients of each point's cell, in corner order."""
    return [grad_p(*(c + d for c, d in zip(ijk, _CORNERS[n]))) for n in range(8)]


def noise_p(px, py, pz) -> torch.Tensor:
    """Gradient noise over component planes (src/perlin.cuh:34-70)."""
    ijk, uvw, smooth = _cell(px, py, pz)
    accum = torch.zeros_like(px)
    for n, g in enumerate(_corner_grads(ijk)):
        accum = _add_corner(accum, n, uvw, smooth, g)
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


# ---- the warp-shared gradients of csrc/perlin.cuh, modelled for tests ----
WARP = 32
NOISE_GROUPS = 4  # csrc/perlin.cuh kNoiseGroups: cells a warp shares gradients over


def by_warp(x: torch.Tensor, fill=0) -> torch.Tensor:
    """(R, ...) -> (W, WARP, ...), the last warp padded with ``fill``."""
    pad = -x.shape[0] % WARP
    if pad:
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(-1, WARP, *x.shape[1:])


def warp_cells(ijk, need: torch.Tensor):
    """The kernels' grouping of one octave (perlin.cuh noise_shared: rounds
    that each take the cell of the lowest needing lane left), per warp of 32
    consecutive lanes: each lane's cell index in its warp, the cells
    ordered by their lowest lane (-1 for a lane without ``need``), as
    (W, 32); each warp's cell count (W,); and each warp's lanes with the
    lowest lane of each cell first, in cell order (W, 32)."""
    key = by_warp(torch.stack(ijk, dim=1))
    nd = by_warp(need, False)
    same = (key[:, :, None, :] == key[:, None, :, :]).all(dim=-1) & nd[:, None, :]
    lead = same.to(torch.int32).argmax(dim=-1)  # the first lane of the cell
    lane = torch.arange(WARP, device=need.device)
    first = nd & (lead == lane)
    cell = torch.where(nd, (torch.cumsum(first, dim=1) - 1).gather(1, lead), -1)
    leaders = torch.sort(torch.where(first, lane, WARP + lane), dim=1).values % WARP
    return cell, first.sum(dim=1), leaders


def turb_shared_p(px, py, pz, depth: int, depth_mask: torch.Tensor | None = None,
                  need: torch.Tensor | None = None) -> torch.Tensor:
    """``turb_p`` computed as the kernels share gradients
    (``csrc/perlin.cuh turbulence_warp``), for tests.  Per warp of 32 lanes
    and octave: with at most ``NOISE_GROUPS`` cells among the lanes with
    ``need`` (default all), worker lane L computes corner L & 7 of cell
    L >> 3 once and each lane takes its cell's eight from the workers;
    with more, each lane computes its own, in this octave and the rest.
    Lanes without ``need`` get 0."""
    R = px.shape[0]
    need = torch.ones(R, dtype=torch.bool, device=px.device) if need is None else need
    lane = torch.arange(WARP, device=px.device)
    group = lane >> 3  # worker lane L: corner L & 7 of cell L >> 3
    corner = torch.tensor(_CORNERS, device=px.device)[lane & 7]
    accum = torch.zeros_like(px)
    weight = 1.0
    sharing = torch.ones(by_warp(need).shape[0], dtype=torch.bool, device=px.device)
    for o in range(depth):
        ijk, uvw, smooth = _cell(px, py, pz)
        cell, n_cells, leaders = warp_cells(ijk, need)
        sharing = sharing & (n_cells <= NOISE_GROUPS)
        shared = sharing[:, None].expand(-1, WARP).reshape(-1)[:R]
        src = torch.where(group < n_cells[:, None], leaders[:, group.clamp_max(NOISE_GROUPS - 1)],
                          lane)
        made = grad_p(*(by_warp(c).gather(1, src) + corner[:, a] for a, c in enumerate(ijk)))
        term = torch.zeros_like(px)
        for n, own in enumerate(_corner_grads(ijk)):
            at = cell.clamp(0, NOISE_GROUPS - 1) * 8 + n  # read only where shared
            taken = [g.gather(1, at).reshape(-1)[:R] for g in made]
            term = _add_corner(term, n, uvw, smooth,
                               [torch.where(shared, t, g) for t, g in zip(taken, own)])
        term = weight * torch.where(need, term, 0.0)
        if depth_mask is not None:
            term = torch.where(o < depth_mask, term, 0.0)
        accum = accum + term
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(accum)


def noise_census(px, py, pz, depth: int, need: torch.Tensor | None = None):
    """Per octave of ``turb_p(p, depth)`` over the lanes with ``need``
    (default all): the warps of 32 lanes with such a lane that the kernels
    run in the shared form with those lanes in 1 cell, in the shared form
    (in at most ``NOISE_GROUPS`` cells, 1 included, at this octave and every
    earlier one) and in the per-lane form, as (depth, 3) int64; and the
    distinct lattice points those lanes' cells reach (depth,), the gradients
    the octave needs."""
    need = torch.ones_like(px, dtype=torch.bool) if need is None else need
    forms, points = [], []
    corners = torch.tensor(_CORNERS, device=px.device)
    sharing = torch.ones(by_warp(need).shape[0], dtype=torch.bool, device=px.device)
    for _ in range(depth):
        ijk = _cell(px, py, pz)[0]
        _, n_cells, _ = warp_cells(ijk, need)
        sharing = sharing & (n_cells <= NOISE_GROUPS)
        some = n_cells > 0
        forms.append([int((some & sharing & (n_cells == 1)).sum()), int((some & sharing).sum()),
                      int((some & ~sharing).sum())])
        cells = torch.unique(torch.stack(ijk, dim=1)[need], dim=0)
        points.append(torch.unique((cells[:, None, :] + corners).reshape(-1, 3), dim=0).shape[0])
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return (torch.tensor(forms, dtype=torch.int64), torch.tensor(points, dtype=torch.int64))
