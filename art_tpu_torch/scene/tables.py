"""Flat SoA scene tables — the ported subset of ``art_tpu/scene/tables.py``.

Spheres, quads, oriented boxes, constant media (with their kind-2
boundary tables ``gb_*``), materials and textures with the same fields,
dtypes and row layouts as ``art_tpu``'s ``SceneTables``
(``tables.py:68-200``), so tables compiled by either package compare field
by field, the image atlas (``utils/images.py``), ``shade_consts`` in its
``(mats, specials)`` form, the box-grid fields of ``_detect_box_grid``
(``box_grid`` and its static ``box_grid_*``) and the sphere tail of
``pack_spheres`` / ``pack_tail_spheres`` (``sph_n_tail``, ``sph_tail_r``,
``sph_tail_mat``, ``sph_tail_box``).

Beside them, the kernels' own tables (built once per scene, on the host):

* ``sph_rows`` (S, 10), the sphere kernel's (``csrc/sphere_hit.cu``): one
  scene-order row ``[cx cy cz vx vy vz r_signed mat r2 0]`` per sphere, with
  ``r2 = r * r`` rounded in float32 exactly as ``sphere_candidates_p``
  rounds it.  Unlike ``art_tpu``'s ``sph_packed`` it keeps scene order, so
  the kernel and the plain path break exact ties the same way.
* ``quad_rows`` (Q, 12), the quad kernel's (``csrc/quad_hit.cu``):
  ``[n(3) D avec(3) ca bvec(3) cb]`` in scene order, the layout of
  ``art_tpu``'s ``pack_quads`` (``pallas_kernels.py:1919``) without its
  padding.
* ``box_rows`` (B, 12), the box kernel's (``csrc/box_hit.cu``):
  ``[min(3) max(3) cos sin off(3) mat]``, the layout of ``pack_boxes``
  (``pallas_kernels.py:2665``) without its padding — when no box is rotated
  the offsets are folded into min/max (world AABBs, off = 0), as the TPU
  kernel reads them.
* ``shade_rows`` (M, 16), the baked shade kernel's constants
  (``csrc/shade_flush.cu``), from ``shade_consts``: ``[mtype fuzz ref_idx
  malb(3) tex_kind isc rgb_or_even(3) odd(3) 0 0]``, holding the values
  ``art_tpu``'s baked kernel compiles in (fuzz 0, ref_idx 1, albedo 0 and
  texture value 0 where a material family does not use them), tex_kind 2
  (a special leaf: image, noise, noodle or felt) taking its value from the
  ``sp0..sp2`` planes;
  ``None`` when the scene fails the baked gate.
* ``sp_sph_rows`` (S, 6), ``sp_quad_rows`` (Q, 13) and ``sp_mat_rows``
  (M, 14), the short-path kernel's (``csrc/sp_step.cu``), from
  ``sp_consts``: spheres ``[cx cy cz r inv_r mat]`` with ``inv_r`` the
  float32 rounding of the float64 ``1 / r`` (as ``art_tpu``'s kernel bakes
  it, ``sp_kernel.py:139``), quads ``pack_quads``' 12 values and the
  material, materials the 14-value tuple of ``sp_consts``; ``None`` when the
  scene fails the short-path gate.  The TPU compiles these constants into
  its kernel; here they are tables the kernel stages in shared memory.
* ``box_grid_rows`` (kx, 2 kz), the run-time cell table of the grid kernel
  K10 (``csrc/box_grid.cu``): height at ``[ix, 2 iz]``, material at
  ``[ix, 2 iz + 1]``, ``box_grid`` reshaped as ``box_grid_hit_attrs``
  reads it; and ``box_grid_cell_rows`` (C, 4), K9's cells ``[ix iz h mat]``
  in ``box_grid_cells`` order (the non-empty cells grouped by (height,
  material)), ``None`` when the builder left ``box_grid_cells`` unset.
* ``sph_head_rows`` and ``sph_tail_rows``, ``sph_rows`` split for the
  compacted tail pass (``ops/compact_sphere.py``): the tail (the static
  spheres of radius ``sph_tail_r`` and material ``sph_tail_mat``) and every
  other sphere, each in scene order (``sph_rows`` and an empty table when
  the scene has no tail).
* ``sph_skip_rows`` / ``sph_skip_bins`` / ``sph_skip_seg`` (K16,
  ``csrc/sphere_skip.cu``) and ``sph_cellbin_rows`` / ``sph_cellbin_meta`` /
  ``sph_cellbin_seg`` (K17, ``csrc/sphere_cellbin.cu``): a head of rows then
  contiguous segments (skip bins along one axis of the tail; cells of a
  lattice), the static ``(n_head, segments, box)`` and its device table
  (``scene/cull.py``); None where the builder's gates leave them out.
* ``sph_cl_rows`` / ``sph_cl_meta`` / ``sph_cl_seg`` (K15's spheres, run by
  K17's ``csrc/sphere_cellbin.cu`` with no head) and ``box_cl_rows`` / ``box_cl_meta`` /
  ``box_cl_seg`` (K15's boxes, ``csrc/box_cluster.cu``): ``sphere_rows`` and
  ``box_rows`` in BVH-leaf order, in clusters of 64 rows with their boxes,
  in the layout above with no head (``scene/cull.py cluster_tables``), and
  ``sph_bvh`` (M, 8), the packed sphere BVH of the per-ray descent
  (``ops/bvh.py pack_bvh``); None where the builder's gates leave them out.
* ``sph_static_cells`` (K13, ``csrc/sphere_static.cu``): ``art_tpu``'s
  compile-time cells, which ``ops/_build.py`` writes into a per-scene
  header; ``sph_mxu_feat`` / ``sph_mxu_attr`` and the recentered
  ``sph_mxu_tail_feat`` / ``sph_mxu_tail_attr`` (K14,
  ``csrc/sphere_mxu.cu``): ``art_tpu``'s feature tables bit for bit.
* ``med_rows`` (C + G, 16), the media kernel's (K18, ``csrc/media.cu``):
  one row a medium in table order, ``[kind -1/density mat ...]`` followed
  by kind 0's ``c(3) r``, kind 1's ``min(3) max(3) cos sin off(3)`` or kind
  2's (first row, count) of its boundary spheres, quads and boxes; then the
  G kind-2 boundary rows, medium by medium and in ``gb_*`` order within a
  kind: spheres ``[c(3) vel(3) r]``, quads ``[q u v w n d]``, boxes
  ``[min(3) max(3) cos sin off(3)]``, zero-padded to 16 (``media_rows``).
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np
import torch

from art_tpu_torch.utils import tracing
from art_tpu_torch.utils.images import ImageAtlas


MAX_BAKED_MATS = 24  # the baked shade mode's gate (art_tpu builder.py:877)
MAX_SP_PRIMS = 16  # the short path's gate (art_tpu builder.py:953); so <= 16 materials


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
    # ---- quads (reference src/quad.cuh; instancing baked in) ----
    quad_q: torch.Tensor  # (Q,3)
    quad_u: torch.Tensor  # (Q,3)
    quad_v: torch.Tensor  # (Q,3)
    quad_w: torch.Tensor  # (Q,3) n / dot(n,n)
    quad_n: torch.Tensor  # (Q,3) unit normal, inward flip applied
    quad_d: torch.Tensor  # (Q,) plane constant dot(n, Q)
    quad_mat: torch.Tensor  # (Q,) int32
    quad_avec: torch.Tensor  # (Q,3) v x w: alpha = dot(avec, p) - ca
    quad_bvec: torch.Tensor  # (Q,3) w x u: beta = dot(bvec, p) - cb
    quad_ca: torch.Tensor  # (Q,)
    quad_cb: torch.Tensor  # (Q,)
    quad_attr_packed: torch.Tensor  # (Q,16) [q(3) u(3) v(3) w(3) n(3) mat]
    quad_rows: torch.Tensor  # (Q,12) kernel rows, see the module docstring
    # ---- oriented boxes (redesign of compound6, src/quad.cuh:94-162) ----
    box_min: torch.Tensor  # (B,3) object-space AABB min
    box_max: torch.Tensor  # (B,3)
    box_cos: torch.Tensor  # (B,) y-rotation cos (1 for axis-aligned)
    box_sin: torch.Tensor  # (B,) y-rotation sin (0 for axis-aligned)
    box_off: torch.Tensor  # (B,3) world offset
    box_mat: torch.Tensor  # (B,) int32
    box_rows: torch.Tensor  # (B,12) kernel rows, see the module docstring
    # ---- constant media (reference src/constant_medium.cuh) ----
    med_kind: torch.Tensor  # (C,) int32: 0 sphere, 1 box, 2 general boundary
    med_center: torch.Tensor  # (C,3) sphere center
    med_radius: torch.Tensor  # (C,)
    med_min: torch.Tensor  # (C,3) box bounds
    med_max: torch.Tensor  # (C,3)
    med_cos: torch.Tensor  # (C,)
    med_sin: torch.Tensor  # (C,)
    med_off: torch.Tensor  # (C,3)
    med_neg_inv_density: torch.Tensor  # (C,) -1/density
    med_mat: torch.Tensor  # (C,) int32 isotropic phase material
    # kind-2 boundaries, one row per primitive (owner in gb_*_meds)
    gb_sph: torch.Tensor  # (Gs,7) [c(3) vel(3) radius]
    gb_quad: torch.Tensor  # (Gq,16) [q(3) u(3) v(3) w(3) n(3) d]
    gb_box: torch.Tensor  # (Gb,11) [min(3) max(3) cos sin off(3)]
    med_rows: torch.Tensor  # (C+G,16) K18's table, see the module docstring
    # ---- regular box grid (builder._detect_box_grid) ----
    box_grid: torch.Tensor  # (kx,kz,2) [y1, mat]; (1,1,2) zeros without a grid
    box_grid_rows: torch.Tensor  # (kx,2kz) K10's table, see the module docstring
    # ---- the sphere tail, split from sph_rows (module docstring) ----
    sph_head_rows: torch.Tensor  # (S - n_tail, 10)
    sph_tail_rows: torch.Tensor  # (n_tail, 10)
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
    tex_img: torch.Tensor  # (T,) int32 atlas image id
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
    med_kinds: tuple = ()  # per-medium boundary kind, static per scene
    gb_sph_meds: tuple = ()  # owning medium of each gb_* row
    gb_quad_meds: tuple = ()
    gb_box_meds: tuple = ()
    has_rotated_boxes: bool = False
    # the box grid's lattice (box_grid_kx == 0: no grid), uniform material
    # (-1.0 when mixed) and, for B <= 1024, K9's cells ((h, mat, ((ix, iz),
    # ...)), ...) and their kernel table
    box_grid_kx: int = 0
    box_grid_kz: int = 0
    box_grid_x0: float = 0.0
    box_grid_z0: float = 0.0
    box_grid_w: float = 1.0
    box_grid_y0: float = 0.0
    box_grid_mat: float = -1.0
    box_grid_cells: tuple | None = None
    box_grid_cell_rows: torch.Tensor | None = None
    # the largest (radius, material)-uniform group of >= 192 static spheres
    # and its inflated AABB (x0, y0, z0, x1, y1, z1); () without a tail
    sph_n_tail: int = 0
    sph_tail_r: float = 1.0
    sph_tail_mat: float = 0.0
    sph_tail_box: tuple = ()
    # the culling kernels' tables (scene/cull.py): K16's skip bins over a
    # tail, K17's tail or whole-set lattice; None where they do not apply
    sph_skip_rows: torch.Tensor | None = None
    sph_skip_bins: tuple | None = None
    sph_skip_seg: torch.Tensor | None = None
    sph_cellbin_rows: torch.Tensor | None = None
    sph_cellbin_meta: tuple | None = None
    sph_cellbin_seg: torch.Tensor | None = None
    # K15's clusters and the sphere BVH (scene/cull.py); None where they do
    # not apply
    sph_cl_rows: torch.Tensor | None = None
    sph_cl_meta: tuple | None = None
    sph_cl_seg: torch.Tensor | None = None
    box_cl_rows: torch.Tensor | None = None
    box_cl_meta: tuple | None = None
    box_cl_seg: torch.Tensor | None = None
    sph_bvh: torch.Tensor | None = None
    # K13's compile-time cells (scene/builder.static_sphere_cells: moving,
    # main, tail in pack_spheres' order; None past 2048 spheres), art_tpu's
    # expanded-quadratic gate and its all-radii-positive flag
    sph_static_cells: tuple | None = None
    sph_expand: bool = False
    sph_pos_r: bool = False
    # K14's bilinear features (scene/builder.sphere_mxu_features): F (2 S_pad,
    # 16), attrT (8, S_pad); None (pad 0) where the scale gate leaves them
    # out; and the tail's, recentered on sph_tail_centroid, for a tail of
    # >= 512 rows
    sph_mxu_feat: torch.Tensor | None = None
    sph_mxu_attr: torch.Tensor | None = None
    mxu_sphere_pad: int = 0
    sph_mxu_tail_feat: torch.Tensor | None = None
    sph_mxu_tail_attr: torch.Tensor | None = None
    mxu_tail_pad: int = 0
    sph_tail_centroid: tuple = ()
    # baked material/texture constants (scene/builder._shade_consts):
    # (mats, specials) or None, and their kernel table
    shade_consts: tuple | None = None
    shade_rows: torch.Tensor | None = None
    # the short path's constants (scene/builder._sp_consts): (spheres,
    # quads, mats) or None, and their kernel tables
    sp_consts: tuple | None = None
    sp_sph_rows: torch.Tensor | None = None
    sp_quad_rows: torch.Tensor | None = None
    sp_mat_rows: torch.Tensor | None = None
    # the image textures' texels (an empty 1x1 atlas when there is none)
    atlas: ImageAtlas = dataclasses.field(default_factory=ImageAtlas.empty)

    # art_tpu's counts of the tables above (0 without them)
    @property
    def n_sphere_clusters(self) -> int:
        return len(self.sph_cl_meta[1]) if self.sph_cl_meta else 0

    @property
    def n_box_clusters(self) -> int:
        return len(self.box_cl_meta[1]) if self.box_cl_meta else 0

    @property
    def n_sph_bvh_nodes(self) -> int:
        return 0 if self.sph_bvh is None else self.sph_bvh.shape[0]

    def to(self, device) -> "SceneTables":
        """The same tables with every tensor, the atlas's too, on ``device``
        (the recorder's ``tables`` span)."""
        with tracing.span("tables"):
            return dataclasses.replace(self, atlas=self.atlas.to(device), **{
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


def quad_rows(n, d, avec, ca, bvec, cb) -> torch.Tensor:
    """(Q,12) float32 kernel rows [n(3) D avec(3) ca bvec(3) cb]."""
    return torch.cat([n, d[:, None], avec, ca[:, None], bvec, cb[:, None]],
                     dim=1).to(torch.float32).contiguous()


def box_rows(bmin, bmax, cos_t, sin_t, off, mat, rotated: bool) -> torch.Tensor:
    """(B,12) float32 kernel rows [min(3) max(3) cos sin off(3) mat]; with no
    rotated box the offsets fold into min/max in float32 (``pack_boxes``)."""
    if not rotated:
        bmin, bmax, off = bmin + off, bmax + off, torch.zeros_like(off)
    return torch.cat([bmin, bmax, cos_t[:, None], sin_t[:, None], off,
                      mat.to(torch.float32)[:, None]], dim=1).contiguous()


MED_ROW = 16  # floats a row of med_rows (csrc/media.cu kRow)


def media_rows(kinds, center, radius, bmin, bmax, cos_t, sin_t, off, neg_inv_density,
               mat, gb_sph, gb_quad, gb_box, gb_meds) -> torch.Tensor:
    """(C + G, MED_ROW) float32 rows of the media kernel (the module
    docstring): the C media of ``kinds`` from their ``med_*`` fields, then
    each kind-2 medium's boundary rows, ``gb_meds`` (the owners of the
    ``gb_sph``, ``gb_quad`` and ``gb_box`` rows) telling whose they are.  The
    values are the tables' float32 values; ints (kind, material, row
    numbers) are exact in float32."""
    heads, tail = [], []
    for m, kind in enumerate(kinds):
        head = [float(kind), float(neg_inv_density[m]), float(mat[m])]
        if kind == 0:
            head += [*center[m].tolist(), float(radius[m])]
        elif kind == 1:
            head += [*bmin[m].tolist(), *bmax[m].tolist(), float(cos_t[m]), float(sin_t[m]),
                     *off[m].tolist()]
        else:
            for rows, meds in zip((gb_sph, gb_quad, gb_box), gb_meds):
                own = [rows[i].tolist() for i, mi in enumerate(meds) if mi == m]
                head += [float(len(kinds) + len(tail)), float(len(own))]
                tail += own
        heads.append(head)
    out = np.zeros((len(heads) + len(tail), MED_ROW), np.float32)
    for k, row in enumerate(heads + tail):
        out[k, :len(row)] = row
    return torch.from_numpy(out)


def grid_cell_rows(cells) -> torch.Tensor | None:
    """(C, 4) float32 rows [ix iz h mat] of K9, in ``box_grid_cells``
    order, or None."""
    if cells is None:
        return None
    return torch.tensor([(ix, iz, h, m) for h, m, group in cells for ix, iz in group],
                        dtype=torch.float32).reshape(-1, 4)


def split_sphere_rows(rows, n_tail: int, tail_r: float, tail_mat: float):
    """(head, tail) tables of the (S, 10) ``sphere_rows`` ``rows``: the tail
    is every static sphere of radius ``tail_r`` and material ``tail_mat``
    (``pack_spheres``' selection), each part in scene order."""
    if not n_tail:
        return rows, rows[:0]
    tail = (rows[:, 3:6] == 0.0).all(dim=1) & (rows[:, 6] == tail_r) & (rows[:, 7] == tail_mat)
    if int(tail.sum()) != n_tail:
        raise ValueError(f"sph_n_tail={n_tail} but {int(tail.sum())} spheres match "
                         f"the tail's radius {tail_r} and material {tail_mat}")
    return rows[~tail].contiguous(), rows[tail].contiguous()


def shade_rows(shade_consts) -> torch.Tensor | None:
    """(M,16) float32 constants of the baked shade kernel from
    ``shade_consts``'s material tuples (mtype, fuzz, ref_idx, metal_rgb3,
    tex_kind, tex_data); tex_kind 0 is a solid (rgb3), 1 a checker of solids
    (inv_scale, even3, odd3), 2 a special leaf (its value rides the sp
    planes; the row's texture values stay 0)."""
    if shade_consts is None:
        return None
    rows = []
    for mtype, fuzz, ref_idx, malb, kind, data in shade_consts[0]:
        # a family that does not read a value gets art_tpu's blend default
        row = [float(mtype), fuzz if mtype == MatType.METAL else 0.0,
               ref_idx if mtype == MatType.DIELECTRIC else 1.0,
               *(malb if mtype == MatType.METAL else (0.0, 0.0, 0.0)),
               float(kind), 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        if mtype in (MatType.LAMBERTIAN, MatType.DIFFUSE_LIGHT, MatType.ISOTROPIC):
            if kind == 0:
                row[8:11] = data
            elif kind == 1:
                row[7], row[8:11], row[11:14] = data[0], data[1], data[2]
        rows.append(row)
    return torch.tensor(rows, dtype=torch.float32)


def sp_rows(sp_consts):
    """The short-path kernel's (S,6) sphere, (Q,13) quad and (M,14) material
    float32 tables from ``sp_consts``, or three Nones."""
    if sp_consts is None:
        return None, None, None
    spheres, quads, mats = sp_consts
    sph = [(cx, cy, cz, r, float(np.float32(1.0 / r)), float(m))
           for cx, cy, cz, r, m in spheres]

    def table(rows, cols):
        return torch.tensor(rows, dtype=torch.float32).reshape(len(rows), cols)

    return (table(sph, 6), table([(*q[:12], float(q[12])) for q in quads], 13),
            table([tuple(map(float, m)) for m in mats], 14))
