"""Batched sphere intersection, component-planar (``art_tpu/ops/intersect.py``).

The plain PyTorch candidate pass and winner attributes
(``sphere_candidates_p:218``, ``sphere_attributes_p:373``) and the
spheres-only ``closest_surface_p`` (``:519``), which runs the sphere kernel
(``ops/intersect_kernels.py``) unless asked for the plain path.  Quads,
boxes and media join with later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from art_tpu_torch.core.vecmath import BIG, p_ray_at, sqrt
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.scene.tables import SceneTables


class HitRecordP(NamedTuple):
    """Planar SoA hit record (reference src/hittable.cuh:13-21)."""

    hit: torch.Tensor  # (R,) bool
    t: torch.Tensor  # (R,)
    p: tuple  # 3 x (R,)
    normal: tuple  # 3 x (R,) shading normal
    u: torch.Tensor  # (R,)
    v: torch.Tensor  # (R,)
    mat: torch.Tensor  # (R,) int32


def sphere_candidates_p(tables: SceneTables, o, d, time, t_min):
    """Best sphere hit per ray: (t_best (R,), idx (R,) int32).

    Half-b quadratic with the center at the ray's shutter time (reference
    src/sphere.cuh:51-89) over (R,1)x(1,S) broadcasts."""
    c0 = tables.sph_center
    r = tables.sph_radius
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a = dx * dx + dy * dy + dz * dz
    cx, cy, cz = c0[None, :, 0], c0[None, :, 1], c0[None, :, 2]
    if tables.has_moving:
        vel = tables.sph_vel
        tcol = time[:, None]
        cx = cx + tcol * vel[None, :, 0]
        cy = cy + tcol * vel[None, :, 1]
        cz = cz + tcol * vel[None, :, 2]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    csq = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[None, :]
    disc = b * b - a * csq
    s = sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - s) * inv_a
    t2 = (-b + s) * inv_a
    valid = disc > 0.0  # strict, as in the reference (src/sphere.cuh:61)
    big = torch.full_like(t1, BIG)
    t = torch.where(valid & (t1 > t_min), t1,
                    torch.where(valid & (t2 > t_min), t2, big))
    # min + argmin: the first index among exact ties, as jnp.argmin
    t_best, idx = torch.min(t, dim=1)
    return t_best, idx.to(torch.int32)


def sphere_attributes_p(tables: SceneTables, o, d, time, t, idx):
    """Normal and material of the winning sphere (src/sphere.cuh:69-86).

    Returns (normal 3-tuple, mat int32).  UV is zero for the slice's scenes
    (no image or uv_offset texture reads it)."""
    tab = torch.cat([tables.sph_center, tables.sph_vel,
                     tables.sph_radius[:, None],
                     tables.sph_mat.to(torch.float32)[:, None]], dim=1)
    row = take_rows(tab, idx)
    cx, cy, cz = row[:, 0], row[:, 1], row[:, 2]
    if tables.has_moving:
        cx = cx + time * row[:, 3]
        cy = cy + time * row[:, 4]
        cz = cz + time * row[:, 5]
    p = p_ray_at(o, d, t)
    inv_r = 1.0 / row[:, 6]
    normal = ((p[0] - cx) * inv_r, (p[1] - cy) * inv_r, (p[2] - cz) * inv_r)
    return normal, row[:, 7].to(torch.int32)


def closest_surface_p(tables: SceneTables, o, d, time, t_min, *, plain=False) -> HitRecordP:
    """Closest sphere hit for every ray.

    The sphere kernel takes ``t_min`` as an argument, so unlike art_tpu
    (whose Pallas kernel bakes ``T_MIN``, ``intersect.py:533-536``) every
    ``t_min`` goes through it; ``plain`` runs the plain twin instead."""
    from art_tpu_torch.ops.intersect_kernels import sphere_hit_attrs, sphere_hit_attrs_plain

    hit_attrs = sphere_hit_attrs_plain if plain else sphere_hit_attrs
    t, normal, mat = hit_attrs(tables, o, d, time, t_min)
    zeros = torch.zeros_like(t)
    return HitRecordP(hit=t < BIG, t=t, p=p_ray_at(o, d, t), normal=normal,
                      u=zeros, v=zeros, mat=mat)


def background_color_p(d, bg, gradient: bool):
    """Solid or y-gradient sky (reference src/main.cu:58-67), planar.

    ``bg`` is a sequence of three floats (the solid color)."""
    if not gradient:
        return tuple(torch.full_like(d[0], float(bg[c])) for c in range(3))
    inv_len = 1.0 / sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    t = 0.5 * (d[1] * inv_len + 1.0)
    return (1.0 - 0.5 * t, 1.0 - 0.3 * t, torch.ones_like(t))
