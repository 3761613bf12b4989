"""The split sphere pass: the sphere tail only for the rays that can reach it.

Port of ``art_tpu/ops/compact_sphere.py``.  final_scene and original_scene
hold a 1000-ball cluster of one radius and material (the tail,
``scene/builder._sphere_tail``) inside a small box that most rays never
cross.  ``sphere_hit_attrs_split`` is K2 over ``sph_rows`` computed as:

1. K2 over ``sph_head_rows`` (every other sphere) at all R lanes;
2. ``needy``: the lanes whose (t_min, inf) segment can meet the tail box
   (``intersect.slab_interval``, conservative); with ``occ_t`` (the
   occlusion gate, ``ART_TPU_OCC_GATE``) only those that enter it at
   ``t_entry <= occ_t``, the closest quad or box hit so far (a tail hit lies
   beyond the entry, so a farther lane cannot change the merge);
3. ``compact(needy, (*o, *d))`` (K4's compaction form,
   ``ops/compact_fetch.py``, one launch): slot j holds the j-th needy lane's
   ray id and its six ray planes, the count stays on the device; the
   planes' slots past the count are unspecified;
4. over the compacted slots with ``n_live`` = the needy count, so slots
   past it miss without a sphere test: K2 over ``sph_tail_rows``, or, with
   ``skip_tail`` (``ART_TPU_SPH_SKIP`` and ``ART_TPU_COMPACT_SKIP``), K16's
   tail-only call over the skip bins (compaction keeps the pool's order, so
   the slots stay coherent);
5. a scatter of (t, normal) back to the needy lanes (the other slots go to
   a spare row) and a merge with the head by closest t, the head keeping
   exact ties; a tail winner takes ``sph_tail_mat``.

``art_tpu`` picks this compact branch or a dense one by the needy count
through ``lax.cond``; PyTorch has no device-side cond and reading the
count would sync every iteration, so the port runs the compact pipeline at
the compacted fetch's capacity (``ceil(R / 128) * 128`` slots), as the
image fetch does, and keeps it as its only branch.  ``art_tpu``'s dense
branch (``compact_sphere.py:156-213``) is one call over the whole pool, so
``intersect.closest_surface_p`` makes it itself, under
``ART_TPU_SPH_FORCE_BRANCH=dense`` (measurement only): K17, K16 or the
full-table K2, or, under ``ART_TPU_MXU_TAIL``, ``sphere_hit_attrs_mxu_tail``
(K2 over the head, K14 over the tail's recentered features).  The split
equals K2 over ``sph_rows`` but on an exact tie between a head sphere that
comes after the tail in scene order and a tail sphere (no reference scene
has one).  With ``plain=True`` every kernel's plain twin runs.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.ops import compact_fetch as cf
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops.intersect import slab_interval
from art_tpu_torch.scene.tables import SceneTables

SPLIT_MIN_TAIL = 512  # art_tpu's gate (intersect.py:164, _COMPACT_SPH_MIN_TAIL)
SPH_K = 8192  # art_tpu's compacted capacity (compact_sphere.py:50); the pool's lower bound


def use_split(tables: SceneTables, R: int | None = None) -> bool:
    """``art_tpu``'s gate (``intersect.py:666-673``): a tail of at least 512
    spheres with its box and, when the pool size ``R`` is given,
    ``SPH_K < R < 2^24``."""
    return (tables.sph_n_tail >= SPLIT_MIN_TAIL and bool(tables.sph_tail_box)
            and (R is None or SPH_K < R < (1 << 24)))


def tail_box_needy(box, o, d, t_min: float) -> torch.Tensor:
    """(R,) bool: True wherever the ray's (t_min, inf) segment could meet the
    tail box (``intersect.slab_interval``)."""
    return slab_interval(box, o, d, t_min)[0]


def sphere_hit_attrs_split(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                           plain: bool = False, occ_t=None, skip_tail: bool = False):
    """K2's (t, normal 3-tuple, mat) over ``sph_rows``, computed as the
    head pass plus the compacted tail pass (module docstring): ``occ_t``
    as ``art_tpu``'s argument, ``skip_tail`` for K16's tail-only call (the
    caller gates it on the skip bins)."""
    hit_attrs = K.sphere_hit_attrs_plain if plain else K.sphere_hit_attrs
    t_h, n_h, m_h = hit_attrs(tables, o, d, tm, t_min, rows=tables.sph_head_rows)
    R = o[0].shape[0]
    needy, t_entry = slab_interval(tables.sph_tail_box, o, d, t_min)
    if occ_t is not None:
        needy = needy & (t_entry <= occ_t)
    # the count stays on the device; the slots past it miss without reading
    # their (unspecified) rays
    ray_k, cnt, rays_k, _ = cf.compact(needy, (*o, *d), plain=plain)
    o_k, d_k, tm_k = rays_k[0:3], rays_k[3:6], torch.zeros_like(rays_k[0])
    if skip_tail:
        t_c, n_c, _ = (K.sphere_skip_hit_attrs_plain if plain else K.sphere_skip_hit_attrs)(
            tables, o_k, d_k, tm_k, t_min, tail_only=True, n_live=cnt)
    else:
        t_c, n_c, _ = hit_attrs(tables, o_k, d_k, tm_k, t_min, rows=tables.sph_tail_rows,
                                n_live=cnt)
    # slots past the count route to a spare row R; a lane no slot reaches
    # keeps t = 0, read as no tail hit (a real hit has t > t_min > 0)
    slot = torch.arange(ray_k.shape[0], dtype=torch.int32, device=ray_k.device)
    dest = torch.where(slot < cnt, ray_k, R).to(torch.int64)
    out = torch.zeros((R + 1, 4), dtype=torch.float32, device=t_h.device)
    out.index_copy_(0, dest, torch.stack([t_c, *n_c], dim=1))
    t_cl = torch.where(out[:R, 0] > 0.0, out[:R, 0], BIG)
    better = t_cl < t_h  # the head keeps exact ties
    normal = tuple(torch.where(better, out[:R, 1 + c], n_h[c]) for c in range(3))
    return (torch.where(better, t_cl, t_h), normal,
            torch.where(better, int(tables.sph_tail_mat), m_h))


def sphere_hit_attrs_mxu_tail(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                              plain: bool = False):
    """The split's dense branch under ``ART_TPU_MXU_TAIL``
    (``art_tpu/ops/compact_sphere.py:157-187``): K2 over ``sph_head_rows``,
    K14 over ``sph_mxu_tail_feat`` with the origins shifted by
    ``sph_tail_centroid`` (t and normals do not move with the frame), and a
    merge in which the tail wins only on a strictly smaller t and takes
    ``sph_tail_mat``.  Not equal to K2 over ``sph_rows``: K14's expanded
    quadratic, 2 t_min margin and Newton step round otherwise."""
    hit_attrs = K.sphere_hit_attrs_plain if plain else K.sphere_hit_attrs
    t_h, n_h, m_h = hit_attrs(tables, o, d, tm, t_min, rows=tables.sph_head_rows)
    gx, gy, gz = tables.sph_tail_centroid
    o_g = (o[0] - gx, o[1] - gy, o[2] - gz)
    t_c, n_c, _ = (K.sphere_mxu_hit_attrs_plain if plain else K.sphere_mxu_hit_attrs)(
        tables.sph_mxu_tail_feat, tables.sph_mxu_tail_attr, o_g, d, tm, t_min)
    better = t_c < t_h
    normal = tuple(torch.where(better, n_c[c], n_h[c]) for c in range(3))
    return (torch.where(better, t_c, t_h), normal,
            torch.where(better, int(tables.sph_tail_mat), m_h))
