"""Flat SoA scene tables — the slice-1 subset of ``art_tpu/scene/tables.py``.

Spheres, materials and textures with the same fields, dtypes and row
layouts as ``art_tpu``'s ``SceneTables`` (``tables.py:68-200``), so tables
compiled by either package compare field by field.  Quads, boxes and media
arrive with later slices; their counts are here and are 0.

``sph_rows`` is the sphere kernel's table (``csrc/sphere_hit.cu``): one
scene-order row ``[cx cy cz vx vy vz r_signed mat r2 0]`` per sphere, with
``r2 = r * r`` rounded in float32 exactly as ``sphere_candidates_p`` rounds
it.  Unlike ``art_tpu``'s ``sph_packed`` it keeps scene order, so the
kernel and the plain path break exact ties the same way.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import torch


class MatType(IntEnum):
    """Material tags (replaces the material vtable, src/material.cuh:46-201)."""

    LAMBERTIAN = 0
    METAL = 1
    DIELECTRIC = 2
    DIFFUSE_LIGHT = 3
    ISOTROPIC = 4


class TexType(IntEnum):
    """Texture tags (replaces the texture vtable, src/texture.cuh:9-164)."""

    SOLID = 0
    CHECKER = 1
    IMAGE = 2
    NOISE = 3
    NOODLE = 4
    FELT = 5
    UV_OFFSET = 6


@dataclasses.dataclass(frozen=True)
class SceneTables:
    # ---- spheres (reference src/sphere.cuh) ----
    sph_center: torch.Tensor  # (S,3) center at t=0
    sph_vel: torch.Tensor  # (S,3) center(t) = center + t*vel
    sph_radius: torch.Tensor  # (S,) signed (negative = inward normals)
    sph_mat: torch.Tensor  # (S,) int32
    sph_rows: torch.Tensor  # (S,10) kernel rows, see the module docstring
    # ---- materials ----
    mat_type: torch.Tensor  # (M,) int32 MatType
    mat_tex: torch.Tensor  # (M,) int32 texture id
    mat_rgb: torch.Tensor  # (M,3) metal albedo
    mat_fuzz: torch.Tensor  # (M,)
    mat_ref_idx: torch.Tensor  # (M,)
    # ---- textures ----
    tex_type: torch.Tensor  # (T,) int32 TexType
    tex_rgb: torch.Tensor  # (T,3)
    tex_rgb2: torch.Tensor  # (T,3)
    tex_params: torch.Tensor  # (T,8)
    tex_child: torch.Tensor  # (T,2) int32
    tex_img: torch.Tensor  # (T,) int32
    # ---- row-packed lookup tables (one fetch per bounce, ops/gather.py) ----
    mat_packed: torch.Tensor  # (M,8) [type tex fuzz ref_idx r g b 0]
    tex_packed: torch.Tensor  # (T,18) [type p0..p7 child0 child1 img rgb(3) rgb2(3)]
    # ---- static metadata ----
    n_spheres: int
    has_moving: bool
    tex_types_present: tuple
    n_quads: int = 0
    n_boxes: int = 0
    n_media: int = 0

    def to(self, device) -> "SceneTables":
        """The same tables with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def sphere_rows(center, vel, radius, mat) -> torch.Tensor:
    """(S,10) float32 kernel rows [c(3) v(3) r mat r*r 0] in scene order."""
    r = radius.to(torch.float32)
    return torch.cat([
        center.to(torch.float32),
        vel.to(torch.float32),
        r[:, None],
        mat.to(torch.float32)[:, None],
        (r * r)[:, None],
        torch.zeros_like(r)[:, None],
    ], dim=1).contiguous()
