"""Batched intersection, component-planar (``art_tpu/ops/intersect.py``).

The plain PyTorch candidate passes and winner attributes of spheres
(``sphere_candidates_p:218``, ``sphere_attributes_p:373``), quads
(``quad_candidates_p:304``, ``quad_attributes_p:414``) and oriented boxes
(``box_candidates_p:333``, ``box_attributes_p:433``), the per-ray BVH
descent over the spheres (``bvh_sphere_candidates_p:257``), the lattice form of
the grid kernels (``box_grid_candidates_p``, ``box_grid_attributes_p``),
``closest_surface_p`` (``:519``), which merges the three kinds through
their kernels (``ops/intersect_kernels.py``, ``ops/compact_sphere.py``)
unless asked for the plain path, the slab tests of the culling passes
(``slab_interval``, ``cluster_slab``), and the constant media
(``apply_media_p:844``, ``_gb_first_hit:758``), plain PyTorch as in
``art_tpu`` (``apply_media_p_plain``, the twin of K18,
``ops/media_kernel.py``, which ``apply_media_p`` launches on CUDA).  A
sphere's (u, v) comes from its normal in PyTorch glue (``sphere_uv``) when
the scene has image or uv_offset textures, as ``art_tpu`` computes it
outside its kernel.

The sphere, quad and box passes read the kernels' row tables
(``sph_rows`` and its head and tail, ``quad_rows``, ``box_rows``, the grid's
cells), so each is its kernel's plain twin.  ``quad_rows`` holds the
same float32 values as ``art_tpu``'s quad fields; ``box_rows`` folds the
offsets of unrotated boxes into min/max as the TPU kernel's table does, so
on such boxes ``box_candidates_p`` rounds as ``art_tpu``'s Pallas kernel
and not as its jnp pass (which subtracts the offset per ray).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from art_tpu_torch.core.vecmath import (
    BIG,
    PARALLEL_EPS,
    device_scalar,
    p_cross,
    p_dot,
    p_ray_at,
    p_rotate_y,
    p_rotate_y_inv,
    p_sub,
    p_where,
    safe_dir,
    sqrt,
)
from art_tpu_torch.ops.bvh import traverse_closest_packed
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.scene.tables import SceneTables, TexType


class HitRecordP(NamedTuple):
    """Planar SoA hit record (reference src/hittable.cuh:13-21)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    p: tuple  # 3 x (R,)
    normal: tuple  # 3 x (R,) shading normal
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    mat: torch.Tensor  # (R,) int32


def sphere_candidates_p(rows, o, d, time, t_min):
    """Best sphere hit per ray over (S, 10) ``sphere_rows`` rows [c(3) v(3)
    r mat r*r 0]: (t_best (R,), idx (R,) int32), (BIG, 0) where none is
    hit."""
    if rows.shape[0] == 0:
        return torch.full_like(o[0], BIG), torch.zeros(o[0].shape, dtype=torch.int32,
                                                      device=o[0].device)
    # min + argmin: the first index among exact ties, as jnp.argmin
    t_best, idx = torch.min(sphere_row_t_p(rows, o, d, time, t_min), dim=1)
    return t_best, idx.to(torch.int32)


def sphere_row_t_p(rows, o, d, time, t_min):
    """(R, S) candidate t of every ray against every row (BIG where the row
    gives none): the half-b quadratic with the center at the ray's shutter
    time (reference src/sphere.cuh:51-89) over (R,1)x(1,S) broadcasts; a
    static sphere's c + time * 0 is c."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a = dx * dx + dy * dy + dz * dz
    tcol = time[:, None]
    cx, cy, cz = (rows[None, :, k] + tcol * rows[None, :, 3 + k] for k in range(3))
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    csq = ocx * ocx + ocy * ocy + ocz * ocz - rows[None, :, 8]
    disc = b * b - a * csq
    s = sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - s) * inv_a
    t2 = (-b + s) * inv_a
    valid = disc > 0.0  # strict, as in the reference (src/sphere.cuh:61)
    big = torch.full_like(t1, BIG)
    return torch.where(valid & (t1 > t_min), t1,
                       torch.where(valid & (t2 > t_min), t2, big))


def _closest(t: torch.Tensor):
    """min + argmin over the primitive axis, (BIG, -1) where nothing is hit.

    ``torch.min`` returns the first index among exact ties, as ``argmin``
    and as the kernels' strict ``<`` scan in scene order."""
    t_best, idx = torch.min(t, dim=1)
    hit = t_best < BIG
    return torch.where(hit, t_best, BIG), torch.where(hit, idx.to(torch.int32), -1)


def bvh_sphere_candidates_p(tables: SceneTables, o, d, time, t_min, stats=None):
    """Best sphere hit per ray by per-ray escape-link descent of ``sph_bvh``
    (``art_tpu/ops/intersect.py:257-300``; reference src/bvh.cuh:95-106):
    (t_best (R,), idx (R,) int32 into ``sph_rows``), (BIG, 0) on a miss.

    ``sphere_candidates_p``'s candidate (strict disc > 0, the near root if >
    t_min, else the far root, src/sphere.cuh:51-89) against the one
    ``sph_rows`` row each ray's walk reaches at a step, the running closest t
    shrinking the slab window (``ops/bvh.py traverse_closest_packed``;
    ``stats`` gets its step count).  A static row's c + time * 0 is c."""
    rows = tables.sph_rows
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    def prim_t_fn(idx, active):
        row = rows.index_select(0, idx)
        cx, cy, cz = (row[:, k] + time * row[:, 3 + k] for k in range(3))
        ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
        b = ocx * dx + ocy * dy + ocz * dz
        csq = ocx * ocx + ocy * ocy + ocz * ocz - row[:, 8]
        disc = b * b - a * csq
        s = sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-b - s) * inv_a
        t2 = (-b + s) * inv_a
        valid = active & (disc > 0.0)
        big = torch.full_like(t1, BIG)
        return torch.where(valid & (t1 > t_min), t1,
                           torch.where(valid & (t2 > t_min), t2, big))

    t_best, prim = traverse_closest_packed(
        tables.sph_bvh, tables.n_sph_bvh_nodes, prim_t_fn, torch.stack(o, dim=-1),
        torch.stack(d, dim=-1), t_min, t_max=BIG, stats=stats)
    return t_best, prim.clamp_min(0)


def quad_candidates_p(tables: SceneTables, o, d, t_min):
    """Best quad hit per ray over ``quad_rows`` (plane hit + interior test,
    src/quad.cuh:60-90): (t_best (R,), idx (R,) int32), (BIG, -1) on a miss.

    Parallel rays (|n.d| < 1e-8) are masked before the min, so the inf or
    NaN of their t never wins."""
    rows = tables.quad_rows

    def bdot(v, k):
        return (v[0][:, None] * rows[None, :, k] + v[1][:, None] * rows[None, :, k + 1]
                + v[2][:, None] * rows[None, :, k + 2])

    nd = bdot(d, 0)
    t = (rows[None, :, 3] - bdot(o, 0)) / nd
    alpha = bdot(o, 4) + t * bdot(d, 4) - rows[None, :, 7]
    beta = bdot(o, 8) + t * bdot(d, 8) - rows[None, :, 11]
    valid = ((nd.abs() >= PARALLEL_EPS) & (t > t_min) & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0))
    return _closest(torch.where(valid, t, BIG))


def _box_frame(rows, o, d, rotated: bool):
    """The rays in each box's frame: o - off, then R(-theta), when the
    table holds rotated boxes; world space otherwise (offsets folded)."""
    if not rotated:
        return tuple(c[:, None] for c in o), tuple(c[:, None] for c in d)
    off = rows[None, :, 8:11]
    lo = tuple(o[c][:, None] - off[..., c] for c in range(3))
    ld = tuple(c[:, None] for c in d)
    cos_t, sin_t = rows[None, :, 6], rows[None, :, 7]
    return p_rotate_y_inv(lo, cos_t, sin_t), p_rotate_y_inv(ld, cos_t, sin_t)


def _slabs(lo, ld, mn, mx):
    """Per-axis slab entry/exit times (min, max of the two plane times)."""
    t0s, t1s = [], []
    for axis in range(3):
        inv = 1.0 / safe_dir(ld[axis])
        ta = (mn[axis] - lo[axis]) * inv
        tb = (mx[axis] - lo[axis]) * inv
        t0s.append(torch.minimum(ta, tb))
        t1s.append(torch.maximum(ta, tb))
    return t0s, t1s


def slab_interval(box, o, d, t_min: float):
    """((R,) bool could-hit, (R,) entry t) of the box (x0, y0, z0, x1, y1,
    z1) over the ray's (t_min, inf) segment: the culling test of the split
    pass and of K16 and K17 (``art_tpu``'s ``tail_box_interval`` and
    ``_slab_interval``, ``pallas_kernels.py:1150``).  A zero direction
    component becomes 1e-20 (not IEEE inf semantics): an origin inside that
    slab then spans the whole line, one outside it a one-sided huge interval
    — both err toward could-hit."""
    x0, y0, z0, x1, y1, z1 = box
    t_near = torch.full_like(o[0], t_min)
    t_far = torch.full_like(o[0], BIG)
    for lo, hi, oc, dc in ((x0, x1, o[0], d[0]), (y0, y1, o[1], d[1]),
                           (z0, z1, o[2], d[2])):
        inv = 1.0 / torch.where(dc == 0.0, 1e-20, dc)
        ta = (lo - oc) * inv
        tb = (hi - oc) * inv
        t_near = torch.maximum(t_near, torch.minimum(ta, tb))
        t_far = torch.minimum(t_far, torch.maximum(ta, tb))
    return t_far >= t_near, t_near


def cluster_slab(box, o, inv, t_min: float, best):
    """(R,) bool: can the ray meet the box (x0, y0, z0, x1, y1, z1) between
    t_min and its ``best`` t so far?  ``art_tpu``'s cluster test
    (``_box_cluster_kernel``, ``pallas_kernels.py:2545-2563``): the slabs
    with the guarded inverses ``inv`` (``1 / safe_dir(d)``), then
    ``max(t0, t_min) <= min(t1, best)``; K15's box twin and kernel."""
    t0s, t1s = [], []
    for k in range(3):
        ta = (box[k] - o[k]) * inv[k]
        tb = (box[3 + k] - o[k]) * inv[k]
        t0s.append(torch.minimum(ta, tb))
        t1s.append(torch.maximum(ta, tb))
    t0 = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t1 = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    return t0.clamp_min(t_min) <= torch.minimum(t1, best)


def box_candidates_p(tables: SceneTables, o, d, t_min):
    """Best box hit per ray over ``box_rows`` (slab test, replaces the
    reference's compound6 six-quad scan): (t_best, idx int32), (BIG, -1)
    on a miss."""
    return box_candidates_rows(tables.box_rows, tables.has_rotated_boxes, o, d, t_min)


def box_candidates_rows(rows, rotated: bool, o, d, t_min):
    """``box_candidates_p`` over the (B, 12) ``box_rows``-layout table
    ``rows`` (``rotated``: the table's rows are in box frames)."""
    lo, ld = _box_frame(rows, o, d, rotated)
    t0s, t1s = _slabs(lo, ld, [rows[None, :, k] for k in range(3)],
                      [rows[None, :, k] for k in range(3, 6)])
    t_entry = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t_exit = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    through = t_entry < t_exit
    t = torch.where(through & (t_entry > t_min), t_entry,
                    torch.where(through & (t_exit > t_min), t_exit, BIG))
    return _closest(t)


def grid_cells(tables: SceneTables, grouped: bool):
    """The box grid's cells as (C, 4) float32 rows [ix iz h mat]: K9's
    ``box_grid_cell_rows`` (``grouped``) or K10's every cell in row-major
    order (empty cells have h = y0 and are never hit)."""
    if grouped:
        return tables.box_grid_cell_rows
    kx, kz = tables.box_grid_kx, tables.box_grid_kz
    g = tables.box_grid_rows
    ix = torch.arange(kx, dtype=torch.float32, device=g.device).repeat_interleave(kz)
    iz = torch.arange(kz, dtype=torch.float32, device=g.device).repeat(kx)
    return torch.stack([ix, iz, g[:, 0::2].reshape(-1), g[:, 1::2].reshape(-1)], dim=1)


def box_grid_candidates_p(tables: SceneTables, cells, o, d, t_min):
    """Best grid-box hit per ray over ``cells`` (``grid_cells``) in their
    order: (t_best, idx int32), (BIG, -1) on a miss.

    The lattice form of ``art_tpu``'s grid kernels
    (``pallas_kernels.py:2200-2294``, ``:2342-2432``): per ray the guarded
    inverses, ``ex0 = (x0 - ox) ix``, ``sxv = w ix`` (z alike) and the shared
    floor plane ``(y0 - oy) iy``; per cell the x slab ``ex0 + f32(ix) sxv``
    and ``+ sxv``, the z slab alike, the top plane ``(h - oy) iy``, then the
    slab test with the entry plane if beyond ``t_min``, else the exit plane."""
    x0, z0, w, y0 = (tables.box_grid_x0, tables.box_grid_z0, tables.box_grid_w,
                     tables.box_grid_y0)
    inv = tuple(1.0 / safe_dir(c) for c in d)
    ex0, sxv = ((x0 - o[0]) * inv[0])[:, None], (w * inv[0])[:, None]
    ez0, szv = ((z0 - o[2]) * inv[2])[:, None], (w * inv[2])[:, None]
    ty0p = ((y0 - o[1]) * inv[1])[:, None]
    ta = ex0 + cells[None, :, 0] * sxv
    tb = ta + sxv
    xlo, xhi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    ta = ez0 + cells[None, :, 1] * szv
    tb = ta + szv
    zlo, zhi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    ty1 = (cells[None, :, 2] - o[1][:, None]) * inv[1][:, None]
    ylo, yhi = torch.minimum(ty0p, ty1), torch.maximum(ty0p, ty1)
    t0 = torch.maximum(torch.maximum(xlo, zlo), ylo)
    t1 = torch.minimum(torch.minimum(xhi, zhi), yhi)
    through = t0 < t1
    t = torch.where(through & (t0 > t_min), t0,
                    torch.where(through & (t1 > t_min), t1, BIG))
    return _closest(t)


def box_grid_attributes_p(tables: SceneTables, cells, o, d, t, idx):
    """``box_attributes_rows`` of the winning cell's box, rebuilt from its
    cell in float32 as the grid kernels rebuild it: min ``(x0 + f32(ix) w,
    y0, z0 + f32(iz) w)``, max ``(min_x + w, h, min_z + w)``, unrotated."""
    cell = take_rows(cells, idx)
    w = tables.box_grid_w
    mnx = tables.box_grid_x0 + cell[:, 0] * w
    mnz = tables.box_grid_z0 + cell[:, 1] * w
    one, zero = torch.ones_like(mnx), torch.zeros_like(mnx)
    row = torch.stack([mnx, torch.full_like(mnx, tables.box_grid_y0), mnz, mnx + w,
                       cell[:, 2], mnz + w, one, zero, zero, zero, zero, cell[:, 3]], dim=1)
    return box_attributes_rows(row, o, d, t)


def sphere_attributes_p(rows, o, d, time, t, idx):
    """Normal and material of the winning row of ``rows`` (the table
    ``sphere_candidates_p`` scanned; src/sphere.cuh:69-86).

    Returns (normal 3-tuple, mat int32); ``sphere_uv`` gives (u, v) from
    the normal where a scene reads it."""
    row = take_rows(rows, idx)
    cx, cy, cz = (row[:, k] + time * row[:, 3 + k] for k in range(3))
    p = p_ray_at(o, d, t)
    inv_r = 1.0 / row[:, 6]
    normal = ((p[0] - cx) * inv_r, (p[1] - cy) * inv_r, (p[2] - cz) * inv_r)
    return normal, row[:, 7].to(torch.int32)


def sphere_uv(normal):
    """Spherical (u, v) from a sphere's signed-radius normal
    (src/sphere.cuh:42-49), in the dividing form of ``art_tpu``'s
    ``sphere_attributes_p`` (``intersect.py:403-408``; its TPU kernel's
    epilogue multiplies by 0.5/pi instead)."""
    theta = torch.acos(torch.clamp(-normal[1], -1.0, 1.0))
    phi = torch.atan2(-normal[2], normal[0]) + math.pi
    return phi / device_scalar(2.0 * math.pi, phi), theta / device_scalar(math.pi, theta)


def quad_attributes_p(tables: SceneTables, o, d, t, idx):
    """(alpha, beta) + ray-facing normal for the winning quad: returns
    (normal 3-tuple, alpha, beta, mat int32)."""
    row = take_rows(tables.quad_attr_packed, idx)  # (R,16)
    p = p_ray_at(o, d, t)
    pl = (p[0] - row[:, 0], p[1] - row[:, 1], p[2] - row[:, 2])
    uu = (row[:, 3], row[:, 4], row[:, 5])
    vv = (row[:, 6], row[:, 7], row[:, 8])
    ww = (row[:, 9], row[:, 10], row[:, 11])
    alpha = p_dot(ww, p_cross(pl, vv))
    beta = p_dot(ww, p_cross(uu, pl))
    nt = (row[:, 12], row[:, 13], row[:, 14])
    # shading normal faces against the ray (src/quad.cuh:84-86)
    flip = p_dot(nt, d) > 0.0
    normal = p_where(flip, (-nt[0], -nt[1], -nt[2]), nt)
    return normal, alpha, beta, row[:, 15].to(torch.int32)


def box_attributes_p(tables: SceneTables, o, d, t, idx):
    """``box_attributes_rows`` of the winning box's ``box_rows`` row."""
    return box_attributes_rows(take_rows(tables.box_rows, idx), o, d, t)


def box_attributes_rows(row, o, d, t):
    """Face normal + the reference's per-face UV (make_box,
    src/quad.cuh:145-162) for each ray's (R, 12) box row [min(3) max(3) cos
    sin off(3) mat]: returns (normal 3-tuple, u, v, mat int32).  Every
    divisor is a tensor."""
    mnx, mny, mnz = row[:, 0], row[:, 1], row[:, 2]
    mxx, mxy, mxz = row[:, 3], row[:, 4], row[:, 5]
    cos_t, sin_t = row[:, 6], row[:, 7]
    o_obj = p_rotate_y_inv((o[0] - row[:, 8], o[1] - row[:, 9], o[2] - row[:, 10]),
                           cos_t, sin_t)
    d_obj = p_rotate_y_inv(d, cos_t, sin_t)

    # re-run the per-axis slab to identify the entry/exit face
    t0s, t1s = _slabs(o_obj, d_obj, (mnx, mny, mnz), (mxx, mxy, mxz))
    t_entry = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t_exit = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    axis_entry = torch.where(t0s[0] >= torch.maximum(t0s[1], t0s[2]), 0,
                             torch.where(t0s[1] >= t0s[2], 1, 2))
    axis_exit = torch.where(t1s[0] <= torch.minimum(t1s[1], t1s[2]), 0,
                            torch.where(t1s[1] <= t1s[2], 1, 2))
    is_entry = (t - t_entry).abs() <= (t - t_exit).abs()
    axis = torch.where(is_entry, axis_entry, axis_exit)
    ax, ay, az = axis == 0, axis == 1, axis == 2
    d_axis = torch.where(ax, d_obj[0], torch.where(ay, d_obj[1], d_obj[2]))
    sgn = torch.where(d_axis >= 0.0, 1.0, -1.0)
    n_val = -sgn  # shading normal faces against the ray
    pos_face = torch.where(is_entry, -sgn, sgn) > 0.0
    normal = p_rotate_y((torch.where(ax, n_val, 0.0), torch.where(ay, n_val, 0.0),
                         torch.where(az, n_val, 0.0)), cos_t, sin_t)

    x, y, z = p_ray_at(o_obj, d_obj, t)
    wx, wy, wz = mxx - mnx, mxy - mny, mxz - mnz
    z_face = torch.where(pos_face, (mxz - z) / wz, (z - mnz) / wz)
    ua = torch.where(ax, z_face, torch.where(
        ay, (x - mnx) / wx, torch.where(pos_face, (x - mnx) / wx, (mxx - x) / wx)))
    va = torch.where(ax, (y - mny) / wy, torch.where(ay, z_face, (y - mny) / wy))
    return normal, ua, va, row[:, 11].to(torch.int32)


def miss_defaults(hit, normal, rest):
    """normal (1, 0, 0) and zeros where ``hit`` is False."""
    one, zero = torch.ones_like(normal[0]), torch.zeros_like(normal[0])
    normal = (torch.where(hit, normal[0], one), torch.where(hit, normal[1], zero),
              torch.where(hit, normal[2], zero))
    return normal, tuple(torch.where(hit, x, torch.zeros_like(x)) for x in rest)


def _closer(best, cand):
    """``cand`` where it is strictly closer than ``best``: (t, normal, u, v,
    mat) tuples; ``best`` keeps exact ties."""
    better = cand[0] < best[0]
    return (torch.where(better, cand[0], best[0]), p_where(better, cand[1], best[1]),
            *(torch.where(better, c, b) for c, b in zip(cand[2:], best[2:])))


def closest_surface_p(tables: SceneTables, o, d, time, t_min, *, plain=False) -> HitRecordP:
    """Closest surface hit for every ray: quads, then boxes, then spheres,
    each merged with a strict ``<`` (``art_tpu``'s order, so a quad wins an
    exact tie with a box face, as on cornell_box's floor under the boxes).

    Each kind goes through its kernel, which takes ``t_min`` as an argument
    (``art_tpu``'s Pallas kernels bake ``T_MIN``, ``intersect.py:533-536``);
    ``plain`` runs the plain twins instead.  The kernels are ``art_tpu``'s
    routes (``intersect.py:540-709``) under the switches of
    ``ops/routes.py``: boxes go to K15's box clusters (``ART_TPU_CLUSTER``,
    where the builder made them), else, on a detected grid, to K9 when the
    builder set ``box_grid_cells``, else to K10, other boxes to K6 — after
    quads in its merge form, which updates the quads' hit in place (the
    same values as ``_closer``).  Spheres
    go, in ``art_tpu``'s order of precedence (``intersect.py:654-708``): to
    the per-ray BVH descent (``ART_TPU_BVH``, plain PyTorch on every device
    as in ``art_tpu``, the winner's attributes from
    ``sphere_attributes_p``); to K15's sphere clusters (``ART_TPU_CLUSTER``);
    to K14 (``ART_TPU_MXU_SPHERES``, where the builder's scale gate made its
    features); to K13 (``ART_TPU_SPH_STATIC``, for at most 2048 spheres, in
    the builder's ``sph_expand`` form); to K17 (``ART_TPU_SPH_CELLBIN``,
    where the builder made cell bins); to the split pass
    (``ops/compact_sphere.py``; opt-in here under ``ART_TPU_COMPACT_SPH``,
    for a tail of at least 512 rows and a pool of ``SPH_K < R < 2^24``
    slots) with the occlusion gate (``ART_TPU_OCC_GATE``) and K16's
    tail-only call (``ART_TPU_SPH_SKIP`` with ``ART_TPU_COMPACT_SKIP``);
    under ``ART_TPU_SPH_FORCE_BRANCH=dense`` to the split's dense branch
    instead (``art_tpu``'s fallbacks, ``compact_sphere.py:156-213``: K2 over
    the head and K14 over the recentered tail under ``ART_TPU_MXU_TAIL``,
    else K17 under ``ART_TPU_COMPACT_CELLBIN``, else K16 under
    ``ART_TPU_SPH_SKIP``, else the full-table K2); to K16 (``ART_TPU_SPH_SKIP``, where the builder
    made skip bins); else to the full-table K2.  A miss keeps normal
    (1, 0, 0) and material 0 (u = v = 0 unless the scene reads a sphere's
    (u, v))."""
    from art_tpu_torch.ops import compact_sphere, routes
    from art_tpu_torch.ops import intersect_kernels as K

    # (u, v) only feeds image and uv_offset textures (art_tpu's needs_uv)
    needs_uv = bool({TexType.IMAGE, TexType.UV_OFFSET} & set(tables.tex_types_present))
    best = None  # (t, normal, u, v, mat) of the closest hit so far
    if tables.n_quads:
        best = (K.quad_hit_attrs_plain if plain else K.quad_hit_attrs)(tables, o, d, t_min)
    r = routes.ROUTES
    if tables.n_boxes:
        if r.cluster and tables.n_box_clusters:
            box = K.box_cluster_hit_attrs_plain if plain else K.box_cluster_hit_attrs
        elif not tables.box_grid_kx and best is not None:
            box = None  # K6's merge form: one launch updates the quads' hit in place
        elif not tables.box_grid_kx:
            box = K.box_hit_attrs_plain if plain else K.box_hit_attrs
        elif tables.box_grid_cell_rows is not None:
            box = K.box_grid_cells_hit_attrs_plain if plain else K.box_grid_cells_hit_attrs
        else:
            box = K.box_grid_hit_attrs_plain if plain else K.box_grid_hit_attrs
        if box is None:
            best = (K.box_hit_attrs_merge_plain if plain else K.box_hit_attrs_merge)(
                tables, o, d, best, t_min)
        else:
            cand = box(tables, o, d, t_min)
            best = cand if best is None else _closer(best, cand)
    if tables.n_spheres:
        cellbin = tables.sph_cellbin_meta is not None
        skip = r.sph_skip and tables.sph_skip_bins is not None
        split = r.compact_sph and compact_sphere.use_split(tables, o[0].shape[0])
        dense = split and r.force_branch == "dense"  # the split's dense branch
        if r.bvh and tables.n_sph_bvh_nodes:
            t, idx = bvh_sphere_candidates_p(tables, o, d, time, t_min)
            normal, mat = sphere_attributes_p(tables.sph_rows, o, d, time, t, idx)
            normal, (mat,) = miss_defaults(t < BIG, normal, (mat,))
        elif r.cluster and tables.n_sphere_clusters:
            t, normal, mat = (K.sphere_cluster_hit_attrs_plain if plain
                              else K.sphere_cluster_hit_attrs)(tables, o, d, time, t_min)
        elif r.mxu_spheres and tables.mxu_sphere_pad:
            t, normal, mat = (K.sphere_mxu_hit_attrs_plain if plain
                              else K.sphere_mxu_hit_attrs)(
                tables.sph_mxu_feat, tables.sph_mxu_attr, o, d, time, t_min)
        elif r.sph_static and tables.sph_static_cells is not None:
            t, normal, mat = (K.sphere_static_hit_attrs_plain if plain
                              else K.sphere_static_hit_attrs)(
                tables, o, d, time, t_min, expand=tables.sph_expand)
        elif cellbin and r.sph_cellbin:
            t, normal, mat = (K.sphere_cellbin_hit_attrs_plain if plain
                              else K.sphere_cellbin_hit_attrs)(tables, o, d, time, t_min)
        elif dense and r.mxu_tail and tables.mxu_tail_pad:
            t, normal, mat = compact_sphere.sphere_hit_attrs_mxu_tail(
                tables, o, d, time, t_min, plain=plain)
        elif cellbin and dense and r.compact_cellbin:
            t, normal, mat = (K.sphere_cellbin_hit_attrs_plain if plain
                              else K.sphere_cellbin_hit_attrs)(tables, o, d, time, t_min)
        elif split and not dense:
            t, normal, mat = compact_sphere.sphere_hit_attrs_split(
                tables, o, d, time, t_min, plain=plain,
                occ_t=best[0] if r.occ_gate and best is not None else None,
                skip_tail=skip and r.compact_skip)
        elif skip:
            t, normal, mat = (K.sphere_skip_hit_attrs_plain if plain
                              else K.sphere_skip_hit_attrs)(tables, o, d, time, t_min)
        else:
            t, normal, mat = (K.sphere_hit_attrs_plain if plain else K.sphere_hit_attrs)(
                tables, o, d, time, t_min)
        zero = torch.zeros_like(t)
        u, v = sphere_uv(normal) if needs_uv else (zero, zero)
        cand = (t, normal, u, v, mat)
        best = cand if best is None else _closer(best, cand)
    if best is None:  # nothing to hit
        t = torch.full_like(o[0], BIG)
        zero = torch.zeros_like(t)
        best = (t, (torch.ones_like(t), zero, zero), zero, zero,
                torch.zeros(t.shape, dtype=torch.int32, device=t.device))
    t, normal, u, v, mat = best
    return HitRecordP(hit=t < BIG, t=t, p=p_ray_at(o, d, t), normal=normal, u=u, v=v,
                      mat=mat)


def _gb_first_hit(tables: SceneTables, m: int, o, d, time, t_lo):
    """Closest hit with t > ``t_lo`` over medium ``m``'s kind-2 boundary
    primitives (``art_tpu/ops/intersect.py:758-841``): one
    ``boundary->hit(r, t_lo, inf)`` of src/constant_medium.cuh:38-44.
    Returns ((R,) t, (R,) hit); a Python loop over the medium's own rows."""
    best = torch.full_like(o[0], BIG)
    hit = torch.zeros(o[0].shape, dtype=torch.bool, device=o[0].device)

    def consider(t_c, ok):
        nonlocal best, hit
        ok = ok & (t_c > t_lo) & (t_c < best)
        best = torch.where(ok, t_c, best)
        hit = hit | ok

    for i in (i for i, mi in enumerate(tables.gb_sph_meds) if mi == m):
        row = tables.gb_sph[i]
        c = tuple(row[k] + time * row[3 + k] for k in range(3))
        t1, t2, crosses = _sphere_interval(o, d, c, row[6])
        # the near root beyond t_lo, else the far one (src/sphere.cuh:51-89)
        consider(torch.where(t1 > t_lo, t1, t2), crosses)

    for i in (i for i, mi in enumerate(tables.gb_quad_meds) if mi == m):
        row = tables.gb_quad[i]
        q, u, v, w, n = (tuple(row[k + c] for c in range(3)) for k in (0, 3, 6, 9, 12))
        denom = p_dot(n, d)
        ok = denom.abs() > PARALLEL_EPS  # src/quad.cuh:63-65
        t_c = (row[15] - p_dot(n, o)) / torch.where(ok, denom, 1.0)
        pl = p_sub(p_ray_at(o, d, t_c), q)
        alpha, beta = p_dot(w, p_cross(pl, v)), p_dot(w, p_cross(u, pl))
        consider(t_c, ok & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))

    for i in (i for i, mi in enumerate(tables.gb_box_meds) if mi == m):
        row = tables.gb_box[i]
        entry, exit_ = _box_interval(o, d, row[0:3], row[3:6], row[6], row[7], row[8:11])
        consider(torch.where(entry > t_lo, entry, exit_), entry < exit_)
    return best, hit


def _sphere_interval(o, d, c, r):
    """(entry, exit, crosses) of the ray's line through the sphere (c, r):
    the two roots of the full quadratic, valid where disc > 0."""
    oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    a, b = p_dot(d, d), p_dot(oc, d)
    disc = b * b - a * (p_dot(oc, oc) - r * r)
    s = sqrt(torch.clamp_min(disc, 0.0))
    return (-b - s) / a, (-b + s) / a, disc > 0.0


def _box_interval(o, d, mn, mx, cos_t, sin_t, off):
    """(entry, exit) of the ray through an oriented box: the ray in the
    box frame, then the slabs (the guarded slab factors are finite, so
    ``art_tpu``'s fold from (-BIG, BIG) gives the same values)."""
    lo = p_rotate_y_inv((o[0] - off[0], o[1] - off[1], o[2] - off[2]), cos_t, sin_t)
    t0s, t1s = _slabs(lo, p_rotate_y_inv(d, cos_t, sin_t), mn, mx)
    return (torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2]),
            torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2]))


def apply_media_p(tables: SceneTables, o, d, t_min, surf: HitRecordP, u_media,
                  time=None, *, plain: bool = False) -> HitRecordP:
    """Medium scatter events over the surface hit record: ``surf`` itself
    without media; K18 (``ops/media_kernel.py``, one launch) for CUDA
    tensors; the plain twin ``apply_media_p_plain`` for CPU tensors or with
    ``plain``."""
    if not tables.n_media:
        return surf
    if plain or o[0].device.type == "cpu":
        return apply_media_p_plain(tables, o, d, t_min, surf, u_media, time)
    from art_tpu_torch.ops import media_kernel

    return media_kernel.apply_media(tables, o, d, t_min, surf, u_media, time)


def apply_media_p_plain(tables: SceneTables, o, d, t_min, surf: HitRecordP, u_media,
                        time=None) -> HitRecordP:
    """Medium scatter events over the surface hit record
    (``art_tpu/ops/intersect.py:844-958``), plain PyTorch as in ``art_tpu``
    (no kernel there), K18's twin.  For each medium, in a Python loop with
    its kind fixed per scene: the boundary interval over (-inf, inf) (a sphere's two
    roots, a box's slabs, or kind 2's two traversals, the second from
    entry + 1e-4), kept for kinds 0 and 1 when exit - entry > 1e-4; clipped
    to [t_min, best t]; a free flight -log(max(1e-6, u)) / density drawn
    from ``u_media[m]``; a scatter inside the interval at t_m = rec1 +
    distance / |d| wins when t_m < best t (strict).  A scattered ray gets
    the medium's isotropic material, normal (1, 0, 0) and u = v = 0.
    ``time`` (the ray's shutter time) only moves kind-2 moving spheres."""
    if not tables.n_media:
        return surf
    if time is None:
        time = torch.zeros_like(o[0])
    ray_len = sqrt(p_dot(d, d))
    len_ok = (ray_len > 0.0) & torch.isfinite(ray_len)
    best_t = surf.t
    in_medium = torch.zeros_like(surf.hit)
    mat = surf.mat
    for m, kind in enumerate(tables.med_kinds):
        if kind == 0:
            entry, exit_, bnd_ok = _sphere_interval(o, d, tables.med_center[m],
                                                    tables.med_radius[m])
        elif kind == 1:
            entry, exit_ = _box_interval(o, d, tables.med_min[m], tables.med_max[m],
                                         tables.med_cos[m], tables.med_sin[m],
                                         tables.med_off[m])
            bnd_ok = entry < exit_
        else:  # kind 2: two traversals of the boundary's primitives
            entry, hit1 = _gb_first_hit(tables, m, o, d, time, torch.full_like(o[0], -BIG))
            # the second hit is searched from rec1.t + 1e-4 (src/constant_medium.cuh:40)
            exit_, hit2 = _gb_first_hit(tables, m, o, d, time, entry + 1e-4)
            bnd_ok = hit1 & hit2
        if kind != 2:  # the same rule on an analytic interval
            bnd_ok = bnd_ok & ((exit_ - entry) > 1e-4)
        rec1 = torch.clamp_min(entry, t_min)
        rec2 = torch.minimum(exit_, best_t)
        ok = bnd_ok & (rec1 < rec2) & len_ok
        distance_inside = (rec2 - rec1) * ray_len
        hit_distance = tables.med_neg_inv_density[m] * torch.log(
            torch.clamp_min(u_media[m], 1e-6))
        t_m = rec1 + hit_distance / ray_len
        accept = ok & (hit_distance <= distance_inside) & (t_m < best_t)
        best_t = torch.where(accept, t_m, best_t)
        in_medium = in_medium | accept
        mat = torch.where(accept, tables.med_mat[m], mat)
    zero = torch.zeros_like(best_t)
    return HitRecordP(
        hit=surf.hit | in_medium, t=best_t,
        p=p_where(in_medium, p_ray_at(o, d, best_t), surf.p),
        normal=p_where(in_medium, (torch.ones_like(best_t), zero, zero), surf.normal),
        u=torch.where(in_medium, zero, surf.u), v=torch.where(in_medium, zero, surf.v),
        mat=mat)


def background_color_p(d, bg, gradient: bool):
    """Solid or y-gradient sky (reference src/main.cu:58-67), planar.

    ``bg`` is a sequence of three floats (the solid color)."""
    if not gradient:
        return tuple(torch.full_like(d[0], float(bg[c])) for c in range(3))
    inv_len = 1.0 / sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    t = 0.5 * (d[1] * inv_len + 1.0)
    return (1.0 - 0.5 * t, 1.0 - 0.3 * t, torch.ones_like(t))
