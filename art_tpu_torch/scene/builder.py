"""Scene compiler: DSL object graph -> flat SoA tables.

Port of ``art_tpu/scene/builder.py``'s sphere / quad / box / medium /
material / texture / image compiler (``_Compiler`` at ``builder.py:186-478``,
``finish:481-642``, ``_shade_consts:855-938`` and ``_sp_consts:940-1019``),
including the value dedup of material and texture rows, the image dedup by
asset name and by array identity, the ``mat_packed`` / ``tex_packed`` /
``quad_attr_packed`` row layouts and the media tables (analytic sphere and
box boundaries, and the kind-2 ``gb_*`` rows of any other boundary), so the
tables and the image atlas come out identical to ``art_tpu``'s.  Two
derived parts of ``finish`` are ported too: the box grid
(``_detect_box_grid``, ``builder.py:103-183``) and the sphere tail
(``pack_spheres`` / ``pack_tail_spheres``, ``pallas_kernels.py:976-1075``),
the culling kernels' skip bins and cell bins (``builder.py:689-737``,
``scene/cull.py``), the clusters and the BVH (``builder.py:812-848``), and
the tables of the baked and bilinear-feature sphere kernels
(``builder.py:652-680``, ``:735-811``: ``static_sphere_cells`` in
``pack_spheres``' order with its ``sph_expand`` and ``sph_pos_r`` gates,
``sphere_mxu_features`` behind the coordinate-scale gate, and the
recentered tail features).

``tables_from_numpy`` carries tables compiled by ``art_tpu`` (as numpy
arrays) into this package — the tests use it to run both packages on the
very same scene data.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from art_tpu_torch.core.camera import Camera, make_camera
from art_tpu_torch.scene import materials as M
from art_tpu_torch.scene import objects as O
from art_tpu_torch.scene import textures as X
from art_tpu_torch.scene.cull import bvh_table, cluster_tables, cull_tables
from art_tpu_torch.scene.tables import (
    MAX_BAKED_MATS,
    MAX_SP_PRIMS,
    MatType,
    SceneTables,
    TexType,
    box_rows,
    grid_cell_rows,
    media_rows,
    quad_rows,
    shade_rows,
    sp_rows,
    sphere_rows,
    split_sphere_rows,
)
from art_tpu_torch.utils.images import ImageAtlas, asset_path, load_image_rgb

TAIL_MIN = 192  # the smallest sphere tail (art_tpu pallas_kernels.py:973 _TAIL_MIN)
STATIC_MAX_SPHERES = 2048  # K13's gate (builder.py:674)
MXU_TAIL_MIN = 512  # the recentered tail features' gate (builder.py:743, SKIP_MIN_TAIL)
GRID_MIN_BOXES = 64  # the box grid's gate (art_tpu builder.py:115)
GRID_MAX_CELLS = 1024  # K9's cell table only up to this many boxes (builder.py:158)
# K14's tables past the coordinate-scale gate, for measurement (builder.py:800-804)
MXU_FORCE = bool(os.environ.get("ART_TPU_MXU_FORCE"))


def _rot_y(theta: float, p: np.ndarray) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]], np.float64)


@dataclasses.dataclass
class _Xform:
    """Accumulated affine map: world = R_y(theta) * local + offset."""

    theta: float = 0.0
    offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64)
    )

    def apply_point(self, p) -> np.ndarray:
        return _rot_y(self.theta, np.asarray(p, np.float64)) + self.offset

    def apply_vector(self, v) -> np.ndarray:
        return _rot_y(self.theta, np.asarray(v, np.float64))


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    tables: SceneTables
    camera: Camera
    background: tuple
    gradient_bg: bool
    name: str = "scene"

    def to(self, device) -> "CompiledScene":
        return dataclasses.replace(self, tables=self.tables.to(device))


class SceneBuilder:
    def __init__(self):
        self._objects: list = []
        self._camera: Camera | None = None
        self._background = (0.0, 0.0, 0.0)
        self._gradient_bg = False
        self._name = "scene"

    def add(self, *objs) -> "SceneBuilder":
        self._objects.extend(objs)
        return self

    def set_camera(self, **kwargs) -> "SceneBuilder":
        self._camera = make_camera(**kwargs)
        return self

    def set_background(self, color=(0, 0, 0), gradient: bool = False) -> "SceneBuilder":
        self._background = tuple(float(c) for c in color)
        self._gradient_bg = bool(gradient)
        return self

    def set_name(self, name: str) -> "SceneBuilder":
        self._name = name
        return self

    def compile(self) -> CompiledScene:
        """Compile to CPU tables; ``CompiledScene.to(device)`` moves them."""
        if self._camera is None:
            raise ValueError("scene has no camera; call set_camera(...)")
        comp = _Compiler()
        for obj in self._objects:
            comp.visit(obj, _Xform(), material_override=None)
        return CompiledScene(
            tables=comp.finish(),
            camera=self._camera,
            background=self._background,
            gradient_bg=self._gradient_bg,
            name=self._name,
        )


class _Compiler:
    def __init__(self):
        self.spheres: list[tuple] = []  # (c0, vel, radius, mat_id)
        self.quads: list[tuple] = []  # (q, u, v, mat_id, inward)
        self.boxes: list[tuple] = []  # (bmin, bmax, cos, sin, off, mat_id)
        self.media: list[dict] = []  # kind, boundary parameters, nid, phase mat
        # kind-2 (general) medium boundary primitives, tagged by medium index
        self.gb_sph: list[tuple] = []  # (med, c0, vel, radius)
        self.gb_quad: list[tuple] = []  # (med, q, u, v)
        self.gb_box: list[tuple] = []  # (med, bmin, bmax, cos, sin, off)
        self._in_boundary = False
        self.mats: list[dict] = []
        self.texs: list[dict] = []
        self.images: list[np.ndarray] = []
        self._mat_ids: dict[int, int] = {}
        self._tex_ids: dict[int, int] = {}
        self._img_ids: dict = {}  # asset name or id() of an array -> image index
        # value-dedup maps: identical parameter rows share one table row
        # (bouncing_spheres builds 488 material instances from 82 rows)
        self._mat_rows: dict[tuple, int] = {}
        self._tex_rows: dict[tuple, int] = {}
        # the id() caches above need every keyed object alive for the
        # compiler's lifetime, or a later object could reuse a freed id
        self._keepalive: list = []

    def tex_id(self, tex: X.Texture) -> int:
        key = id(tex)
        if key in self._tex_ids:
            return self._tex_ids[key]
        self._keepalive.append(tex)
        row = dict(type=int(TexType.SOLID), rgb=(0.0, 0.0, 0.0),
                   rgb2=(0.0, 0.0, 0.0), params=[0.0] * 8, child=(0, 0), img=0)
        if isinstance(tex, X.SolidColor):
            row["rgb"] = tuple(np.asarray(tex.albedo, np.float64))
        elif isinstance(tex, X.Checker):
            row["type"] = int(TexType.CHECKER)
            row["params"][0] = 1.0 / tex.scale  # inv_scale (src/texture.cuh:33)
            row["child"] = (self.tex_id(tex.even), self.tex_id(tex.odd))
        elif isinstance(tex, X.ImageTexture):
            row["type"] = int(TexType.IMAGE)
            row["img"] = self.img_id(tex.image)
        elif isinstance(tex, X.NoiseTexture):
            row["type"] = int(TexType.NOISE)
            row["params"][0] = float(tex.scale)
        elif isinstance(tex, X.NoodleTexture):
            row["type"] = int(TexType.NOODLE)
            d = np.asarray(tex.direction, np.float64)
            d = d / np.linalg.norm(d)
            row["params"][:7] = [float(tex.stripes_k), float(tex.wiggle_amp),
                                 float(tex.wiggle_freq), float(tex.octaves), *d.tolist()]
            row["rgb"] = tuple(np.asarray(tex.noodle, np.float64))
            row["rgb2"] = tuple(np.asarray(tex.gap, np.float64))
        elif isinstance(tex, X.FeltTexture):
            row["type"] = int(TexType.FELT)
            row["rgb"] = tuple(np.asarray(tex.base, np.float64))
            row["params"][:4] = [float(tex.mottling_scale), float(tex.mottling_amt),
                                 float(tex.fiber_scale), float(tex.fiber_amt)]
        elif isinstance(tex, X.UVOffset):
            row["type"] = int(TexType.UV_OFFSET)
            row["params"][0] = float(tex.u_offset_turns)
            row["params"][1] = float(tex.v_offset)
            row["child"] = (self.tex_id(tex.base), 0)
        else:
            raise TypeError(f"unknown texture type: {type(tex)!r}")

        content = (row["type"], row["rgb"], row["rgb2"], tuple(row["params"]),
                   row["child"], row["img"])
        idx = self._tex_rows.get(content)
        if idx is None:
            idx = len(self.texs)
            self.texs.append(row)
            self._tex_rows[content] = idx
        self._tex_ids[key] = idx
        return idx

    def img_id(self, image) -> int:
        """Atlas index of an image: an asset name (its decoded copy, one
        entry per name) or an (H, W, 3) uint8 array (one entry per object)."""
        key = image if isinstance(image, str) else id(image)
        if key in self._img_ids:
            return self._img_ids[key]
        if isinstance(image, str):
            rgb = load_image_rgb(asset_path(image))
        else:
            self._keepalive.append(image)
            rgb = np.asarray(image, np.uint8)
        self.images.append(rgb)
        self._img_ids[key] = len(self.images) - 1
        return self._img_ids[key]

    def mat_id(self, mat: M.Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key]
        self._keepalive.append(mat)
        row = dict(type=0, tex=0, rgb=(0.0, 0.0, 0.0), fuzz=0.0, ref_idx=1.0)
        if isinstance(mat, M.Lambertian):
            row["type"] = int(MatType.LAMBERTIAN)
            row["tex"] = self.tex_id(mat.texture)
        elif isinstance(mat, M.Metal):
            row["type"] = int(MatType.METAL)
            row["rgb"] = tuple(np.asarray(mat.albedo, np.float64))
            row["fuzz"] = min(float(mat.fuzz), 1.0)  # src/material.cuh:97
        elif isinstance(mat, M.Dielectric):
            row["type"] = int(MatType.DIELECTRIC)
            row["ref_idx"] = float(mat.ref_idx)
        elif isinstance(mat, M.DiffuseLight):
            row["type"] = int(MatType.DIFFUSE_LIGHT)
            row["tex"] = self.tex_id(mat.texture)
        elif isinstance(mat, M.Isotropic):
            row["type"] = int(MatType.ISOTROPIC)
            row["tex"] = self.tex_id(mat.texture)
        else:
            raise TypeError(f"unknown material type: {type(mat)!r}")

        content = (row["type"], row["tex"], row["rgb"], row["fuzz"], row["ref_idx"])
        idx = self._mat_rows.get(content)
        if idx is None:
            idx = len(self.mats)
            self.mats.append(row)
            self._mat_rows[content] = idx
        self._mat_ids[key] = idx
        return idx

    def _prim_mat(self, mat) -> int:
        """A primitive's material id; a medium's boundary is never shaded
        (its phase material is the medium's), so its primitives intern
        nothing (``art_tpu/scene/builder.py:342-350``)."""
        return 0 if self._in_boundary else self.mat_id(mat)

    def visit(self, obj, xf: _Xform, material_override):
        if isinstance(obj, O.Translate):
            off = xf.offset + xf.apply_vector(obj.offset)
            self.visit(obj.obj, _Xform(xf.theta, off), material_override)
        elif isinstance(obj, O.RotateY):
            theta = xf.theta + math.radians(obj.degrees)
            self.visit(obj.obj, _Xform(theta, xf.offset), material_override)
        elif isinstance(obj, O.WithMaterial):
            # outermost override wins (src/hittable.cuh:154-178)
            self.visit(obj.obj, xf, material_override if material_override
                       is not None else obj.material)
        elif isinstance(obj, O.Sphere):
            mat = material_override or obj.material
            c0 = xf.apply_point(obj.center)
            vel = (xf.apply_point(obj.center2) - c0 if obj.center2 is not None
                   else np.zeros(3))
            self.spheres.append((c0, vel, float(obj.radius), self._prim_mat(mat)))
        elif isinstance(obj, O.Quad):
            mat = material_override or obj.material
            self.quads.append((xf.apply_point(obj.q), xf.apply_vector(obj.u),
                               xf.apply_vector(obj.v), self._prim_mat(mat),
                               bool(obj.inward)))
        elif isinstance(obj, O.Box):
            mat = material_override or obj.material
            a = np.asarray(obj.a, np.float64)
            b = np.asarray(obj.b, np.float64)
            self.boxes.append((np.minimum(a, b), np.maximum(a, b), math.cos(xf.theta),
                               math.sin(xf.theta), xf.offset.copy(),
                               self._prim_mat(mat)))
        elif isinstance(obj, O.Group):
            for child in obj.children:
                self.visit(child, xf, material_override)
        elif isinstance(obj, O.ConstantMedium):
            if self._in_boundary:
                raise TypeError("a ConstantMedium boundary cannot contain another "
                                "ConstantMedium (the reference's boundary->hit chain "
                                "has no such nesting either, "
                                "src/constant_medium.cuh:38-44)")
            self._visit_medium(obj, xf)
        else:
            raise TypeError(f"unknown scene object: {type(obj)!r}")

    def _visit_medium(self, med: O.ConstantMedium, xf: _Xform):
        """One medium (``art_tpu/scene/builder.py:408-478``): a static sphere
        boundary is kind 0, a box kind 1 (both resolved through Translate,
        RotateY and WithMaterial); any other boundary, a moving sphere
        included, is kind 2, its primitives in the ``gb_*`` tables."""
        node, inner = med.boundary, _Xform(xf.theta, xf.offset.copy())
        while isinstance(node, (O.Translate, O.RotateY, O.WithMaterial)):
            if isinstance(node, O.Translate):
                inner = _Xform(inner.theta, inner.offset + inner.apply_vector(node.offset))
            elif isinstance(node, O.RotateY):
                inner = _Xform(inner.theta + math.radians(node.degrees), inner.offset)
            node = node.obj  # a material override does not matter to a boundary
        mat_id = self.mat_id(M.Isotropic(med.texture))
        nid = -1.0 / med.density  # src/constant_medium.cuh:25
        entry = dict(kind=2, center=np.zeros(3), radius=1.0, bmin=np.zeros(3),
                     bmax=np.ones(3), cos=1.0, sin=0.0, off=np.zeros(3), nid=nid,
                     mat=mat_id)
        if isinstance(node, O.Sphere) and node.center2 is None:
            entry.update(kind=0, center=inner.apply_point(node.center),
                         radius=abs(float(node.radius)))
        elif isinstance(node, O.Box):
            a, b = np.asarray(node.a, np.float64), np.asarray(node.b, np.float64)
            entry.update(kind=1, bmin=np.minimum(a, b), bmax=np.maximum(a, b),
                         cos=math.cos(inner.theta), sin=math.sin(inner.theta),
                         off=inner.offset.copy())
        else:
            med_idx = len(self.media)
            saved = (self.spheres, self.quads, self.boxes)
            self.spheres, self.quads, self.boxes = [], [], []
            self._in_boundary = True
            try:
                self.visit(med.boundary, xf, None)
                bnd = (self.spheres, self.quads, self.boxes)
            finally:
                self.spheres, self.quads, self.boxes = saved
                self._in_boundary = False
            if not any(bnd):
                raise TypeError("ConstantMedium boundary contains no geometry "
                                f"({type(med.boundary).__name__})")
            self.gb_sph += [(med_idx, c0, vel, r) for c0, vel, r, _ in bnd[0]]
            self.gb_quad += [(med_idx, q, u, v) for q, u, v, _, _ in bnd[1]]
            self.gb_box += [(med_idx, *box[:5]) for box in bnd[2]]
        self.media.append(entry)

    def finish(self) -> SceneTables:
        f32 = np.float32
        if not self.mats:
            self.mat_id(M.Lambertian((0.5, 0.5, 0.5)))
        arrays = dict(
            mat_type=np.asarray([m["type"] for m in self.mats], np.int32),
            mat_tex=np.asarray([m["tex"] for m in self.mats], np.int32),
            mat_rgb=np.asarray([m["rgb"] for m in self.mats], f32),
            mat_fuzz=np.asarray([m["fuzz"] for m in self.mats], f32),
            mat_ref_idx=np.asarray([m["ref_idx"] for m in self.mats], f32),
            mat_packed=np.asarray(
                [[m["type"], m["tex"], m["fuzz"], m["ref_idx"], *m["rgb"], 0.0]
                 for m in self.mats], f32),
            n_spheres=len(self.spheres), n_quads=len(self.quads),
            n_boxes=len(self.boxes), shade_consts=self._shade_consts(),
        )
        if self.spheres:
            arrays.update(
                sph_center=np.stack([s[0] for s in self.spheres]).astype(f32),
                sph_vel=np.stack([s[1] for s in self.spheres]).astype(f32),
                sph_radius=np.asarray([s[2] for s in self.spheres], f32),
                sph_mat=np.asarray([s[3] for s in self.spheres], np.int32),
            )
        if self.quads:
            qs, us, vs = (np.stack([q[k] for q in self.quads]).astype(np.float64)
                          for k in range(3))
            inward = np.asarray([q[4] for q in self.quads])
            n = np.cross(us, vs)
            nn = np.sum(n * n, axis=-1, keepdims=True)
            normal = n / np.sqrt(nn)
            normal = np.where(inward[:, None], -normal, normal)  # src/quad.cuh:35
            w = n / nn  # src/quad.cuh:38
            avec = np.cross(vs, w)  # alpha = dot(avec, p) - dot(avec, q)
            bvec = np.cross(w, us)
            mats = np.asarray([q[3] for q in self.quads], np.int32)
            arrays.update(
                quad_q=qs.astype(f32), quad_u=us.astype(f32), quad_v=vs.astype(f32),
                quad_w=w.astype(f32), quad_n=normal.astype(f32),
                quad_d=np.sum(normal * qs, axis=-1).astype(f32), quad_mat=mats,
                quad_avec=avec.astype(f32), quad_bvec=bvec.astype(f32),
                quad_ca=np.sum(avec * qs, axis=-1).astype(f32),
                quad_cb=np.sum(bvec * qs, axis=-1).astype(f32),
                quad_attr_packed=self._quad_attr_packed(),
            )
        if self.boxes:
            coss = np.asarray([b[2] for b in self.boxes], f32)
            sins = np.asarray([b[3] for b in self.boxes], f32)
            arrays.update(
                box_min=np.stack([b[0] for b in self.boxes]).astype(f32),
                box_max=np.stack([b[1] for b in self.boxes]).astype(f32),
                box_cos=coss, box_sin=sins,
                box_off=np.stack([b[4] for b in self.boxes]).astype(f32),
                box_mat=np.asarray([b[5] for b in self.boxes], np.int32),
                # a 180-degree rotation has sin == 0 but cos == -1
                has_rotated_boxes=bool(np.any((sins != 0.0) | (coss != 1.0))),
            )
        arrays.update(self._media_arrays())
        if self.texs:
            arrays.update(
                tex_type=np.asarray([x["type"] for x in self.texs], np.int32),
                tex_rgb=np.asarray([x["rgb"] for x in self.texs], f32),
                tex_rgb2=np.asarray([x["rgb2"] for x in self.texs], f32),
                tex_params=np.asarray([x["params"] for x in self.texs], f32),
                tex_child=np.asarray([x["child"] for x in self.texs], np.int32),
                tex_img=np.asarray([x["img"] for x in self.texs], np.int32),
                tex_packed=np.asarray(
                    [[x["type"], *x["params"], *x["child"], x["img"],
                      *x["rgb"], *x["rgb2"]] for x in self.texs], f32),
                tex_types_present=tuple(sorted({x["type"] for x in self.texs})),
            )
        if self.images:
            arrays["atlas"] = ImageAtlas.pack(self.images)
        arrays["sp_consts"] = self._sp_consts(arrays)
        return _tables(arrays)

    def _media_arrays(self) -> dict:
        """The media and kind-2 boundary tables (``art_tpu/scene/builder.py:
        545-590``), empty when the scene has no medium."""
        f32, out = np.float32, {}
        if self.media:
            med = self.media
            out.update(
                med_kind=np.asarray([m["kind"] for m in med], np.int32),
                med_center=np.stack([m["center"] for m in med]).astype(f32),
                med_radius=np.asarray([m["radius"] for m in med], f32),
                med_min=np.stack([m["bmin"] for m in med]).astype(f32),
                med_max=np.stack([m["bmax"] for m in med]).astype(f32),
                med_cos=np.asarray([m["cos"] for m in med], f32),
                med_sin=np.asarray([m["sin"] for m in med], f32),
                med_off=np.stack([m["off"] for m in med]).astype(f32),
                med_neg_inv_density=np.asarray([m["nid"] for m in med], f32),
                med_mat=np.asarray([m["mat"] for m in med], np.int32),
                n_media=len(med), med_kinds=tuple(int(m["kind"]) for m in med),
            )
        if self.gb_sph:
            out.update(gb_sph=np.asarray([[*g[1], *g[2], g[3]] for g in self.gb_sph], f32),
                       gb_sph_meds=tuple(int(g[0]) for g in self.gb_sph))
        if self.gb_quad:
            rows = []
            for _, q, u, v in self.gb_quad:
                q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
                n = np.cross(u, v)
                nn = float(np.dot(n, n))
                normal = n / math.sqrt(nn)
                rows.append([*q, *u, *v, *(n / nn), *normal, float(np.dot(normal, q))])
            out.update(gb_quad=np.asarray(rows, f32),
                       gb_quad_meds=tuple(int(g[0]) for g in self.gb_quad))
        if self.gb_box:
            out.update(gb_box=np.asarray([[*g[1], *g[2], g[3], g[4], *g[5]]
                                          for g in self.gb_box], f32),
                       gb_box_meds=tuple(int(g[0]) for g in self.gb_box))
        return out

    def _quad_attr_packed(self) -> np.ndarray:
        """(Q, 16) [q u v w n mat] rows for the winner attributes, w and n
        recomputed per quad in float64 as ``art_tpu`` does (builder.py:629)."""
        qa = np.zeros((len(self.quads), 16), np.float64)
        for i, (q, u, v, mid, inward) in enumerate(self.quads):
            n = np.cross(u, v)
            nn = float(np.dot(n, n))
            normal = n / np.sqrt(nn)
            if inward:
                normal = -normal
            qa[i] = [*q, *u, *v, *(n / nn), *normal, mid]
        return qa.astype(np.float32)

    def _shade_consts(self):
        """Baked material/texture constants for the shade kernel's baked mode
        (``art_tpu/scene/builder.py:_shade_consts``), gated as there: at
        most 24 materials, each texture a solid, a checker of solids or a
        special leaf — image (under at most one uv_offset wrapper, whose
        offsets fold into the fetch), noise, noodle or felt.

        Returns ``(mats, specials)`` or None; ``mats[i] = (mtype, fuzz,
        ref_idx, metal_rgb3, tex_kind, tex_data)`` with tex_kind 0 solid
        (rgb3), 1 checker (inv_scale, even3, odd3) or 2 special, every value
        rounded to float32; ``specials[j]`` is ``(mat_id, "image", img,
        du, dv)``, ``(mat_id, "noise", scale)``, ``(mat_id, "noodle", k,
        amp, f, octaves, dx, dy, dz, rgb3, rgb2_3)`` or ``(mat_id, "felt",
        m_scale, m_amt, f_scale, f_amt, rgb3)``, whose value the integrator
        evaluates outside the kernel (``ops/texture_eval.py:eval_special_p``)."""
        if not self.mats or len(self.mats) > MAX_BAKED_MATS:
            return None

        def f32(v):
            return float(np.float32(v))

        mats, specials = [], []
        for mid, m in enumerate(self.mats):
            ty = int(m["type"])
            tex_kind, tex_data = 0, (0.0, 0.0, 0.0)
            if ty in (MatType.LAMBERTIAN, MatType.DIFFUSE_LIGHT, MatType.ISOTROPIC):
                tx = self.texs[int(m["tex"])]
                du = dv = 0.0
                if tx["type"] == TexType.UV_OFFSET:
                    du, dv = f32(tx["params"][0]), f32(tx["params"][1])
                    tx = self.texs[int(tx["child"][0])]
                    if tx["type"] != TexType.IMAGE:
                        return None  # a uv wrapper over a non-image: no scene has one
                p = tx["params"]
                if tx["type"] == TexType.SOLID:
                    tex_data = tuple(f32(v) for v in tx["rgb"])
                elif tx["type"] == TexType.CHECKER:
                    even, odd = (self.texs[int(c)] for c in tx["child"])
                    if even["type"] != TexType.SOLID or odd["type"] != TexType.SOLID:
                        return None
                    tex_kind = 1
                    tex_data = (f32(p[0]), tuple(f32(v) for v in even["rgb"]),
                                tuple(f32(v) for v in odd["rgb"]))
                elif tx["type"] == TexType.IMAGE:
                    tex_kind = 2
                    specials.append((mid, "image", int(tx["img"]), du, dv))
                elif tx["type"] == TexType.NOISE:
                    tex_kind = 2
                    specials.append((mid, "noise", f32(p[0])))
                elif tx["type"] == TexType.NOODLE:
                    tex_kind = 2
                    specials.append((mid, "noodle", f32(p[0]), f32(p[1]), f32(p[2]),
                                     int(p[3]), f32(p[4]), f32(p[5]), f32(p[6]),
                                     tuple(f32(v) for v in tx["rgb"]),
                                     tuple(f32(v) for v in tx["rgb2"])))
                elif tx["type"] == TexType.FELT:
                    tex_kind = 2
                    specials.append((mid, "felt", f32(p[0]), f32(p[1]), f32(p[2]),
                                     f32(p[3]), tuple(f32(v) for v in tx["rgb"])))
                else:
                    return None
            mats.append((ty, f32(m["fuzz"]), f32(m["ref_idx"]),
                         tuple(f32(v) for v in m["rgb"]), tex_kind, tex_data))
        return (tuple(mats), tuple(specials))

    def _sp_consts(self, arrays: dict):
        """The short path's gate and constants (``art_tpu/scene/builder.py:
        _sp_consts``): small fully-static scenes — no boxes, no media, no
        moving sphere, 1..16 spheres and quads, materials lambertian, metal,
        dielectric or diffuse_light, textures solid, checker of solids or
        noise (marble).

        Returns ``(spheres, quads, mats)`` of float32-rounded Python floats
        or None: ``spheres[i] = (cx, cy, cz, r, mat)``, ``quads[i] = (n(3),
        D, avec(3), ca, bvec(3), cb, mat)`` (``pack_quads``' layout),
        ``mats[i] = (type, fuzz, ref_idx, metal_rgb3, tex_kind, solid_or_even3,
        inv_scale_or_noise_scale, odd3)`` with tex_kind 0 solid, 1 checker,
        2 marble.  The values are those of the float32 tables in
        ``arrays``."""
        if self.boxes or self.media:
            return None
        if not 0 < len(self.spheres) + len(self.quads) <= MAX_SP_PRIMS:
            return None
        if self.spheres and np.any(arrays["sph_vel"] != 0.0):
            return None  # moving spheres (the tables' has_moving)

        def f32(v):
            return float(np.float32(v))

        mats = []
        for m in self.mats:
            ty = int(m["type"])
            if ty not in (MatType.LAMBERTIAN, MatType.METAL, MatType.DIELECTRIC,
                          MatType.DIFFUSE_LIGHT):
                return None
            tex_kind, s_rgb, isc, o_rgb = 0, (0.0,) * 3, 0.0, (0.0,) * 3
            if ty in (MatType.LAMBERTIAN, MatType.DIFFUSE_LIGHT):
                tx = self.texs[int(m["tex"])]
                if tx["type"] == TexType.SOLID:
                    s_rgb = tuple(f32(v) for v in tx["rgb"])
                elif tx["type"] == TexType.CHECKER:
                    even, odd = (self.texs[int(c)] for c in tx["child"])
                    if even["type"] != TexType.SOLID or odd["type"] != TexType.SOLID:
                        return None
                    tex_kind = 1
                    isc = f32(tx["params"][0])
                    s_rgb = tuple(f32(v) for v in even["rgb"])
                    o_rgb = tuple(f32(v) for v in odd["rgb"])
                elif tx["type"] == TexType.NOISE:
                    tex_kind = 2
                    isc = f32(tx["params"][0])
                else:
                    return None
            mats.append((ty, f32(m["fuzz"]), f32(m["ref_idx"]),
                         *(f32(v) for v in m["rgb"]), tex_kind, *s_rgb, isc, *o_rgb))
        spheres = tuple(
            (*map(float, arrays["sph_center"][i]), float(arrays["sph_radius"][i]),
             int(arrays["sph_mat"][i])) for i in range(len(self.spheres)))
        quads = tuple(
            (*map(float, arrays["quad_n"][i]), float(arrays["quad_d"][i]),
             *map(float, arrays["quad_avec"][i]), float(arrays["quad_ca"][i]),
             *map(float, arrays["quad_bvec"][i]), float(arrays["quad_cb"][i]),
             int(arrays["quad_mat"][i])) for i in range(len(self.quads)))
        return (spheres, quads, tuple(mats))


# one dummy row per empty table, as art_tpu's empty_tables()
_EMPTY = dict(
    sph_center=np.zeros((1, 3), np.float32),
    sph_vel=np.zeros((1, 3), np.float32),
    sph_radius=np.ones((1,), np.float32),
    sph_mat=np.zeros((1,), np.int32),
    quad_q=np.zeros((1, 3), np.float32),
    quad_u=np.asarray([[1.0, 0, 0]], np.float32),
    quad_v=np.asarray([[0, 1.0, 0]], np.float32),
    quad_w=np.asarray([[0, 0, 1.0]], np.float32),
    quad_n=np.asarray([[0, 0, 1.0]], np.float32),
    quad_d=np.zeros((1,), np.float32),
    quad_mat=np.zeros((1,), np.int32),
    quad_avec=np.asarray([[1.0, 0, 0]], np.float32),
    quad_bvec=np.asarray([[0, 1.0, 0]], np.float32),
    quad_ca=np.zeros((1,), np.float32),
    quad_cb=np.zeros((1,), np.float32),
    quad_attr_packed=np.zeros((1, 16), np.float32),
    box_min=np.zeros((1, 3), np.float32),
    box_max=np.ones((1, 3), np.float32),
    box_cos=np.ones((1,), np.float32),
    box_sin=np.zeros((1,), np.float32),
    box_off=np.zeros((1, 3), np.float32),
    box_mat=np.zeros((1,), np.int32),
    med_kind=np.zeros((1,), np.int32),
    med_center=np.zeros((1, 3), np.float32),
    med_radius=np.ones((1,), np.float32),
    med_min=np.zeros((1, 3), np.float32),
    med_max=np.ones((1, 3), np.float32),
    med_cos=np.ones((1,), np.float32),
    med_sin=np.zeros((1,), np.float32),
    med_off=np.zeros((1, 3), np.float32),
    med_neg_inv_density=-np.ones((1,), np.float32),
    med_mat=np.zeros((1,), np.int32),
    gb_sph=np.zeros((1, 7), np.float32),
    gb_quad=np.zeros((1, 16), np.float32),
    gb_box=np.zeros((1, 11), np.float32),
    box_grid=np.zeros((1, 1, 2), np.float32),
    tex_type=np.zeros((1,), np.int32),
    tex_rgb=np.ones((1, 3), np.float32),
    tex_rgb2=np.zeros((1, 3), np.float32),
    tex_params=np.zeros((1, 8), np.float32),
    tex_child=np.zeros((1, 2), np.int32),
    tex_img=np.zeros((1,), np.int32),
    tex_packed=np.zeros((1, 18), np.float32),
    tex_types_present=(),
)

# SceneTables' array fields that art_tpu has too (the kernel tables are the
# port's own and are built here)
_ARRAY_FIELDS = tuple(k for k in _EMPTY if k != "tex_types_present") + (
    "mat_type", "mat_tex", "mat_rgb", "mat_fuzz", "mat_ref_idx", "mat_packed")


_GRID_META = ("box_grid_kx", "box_grid_kz", "box_grid_x0", "box_grid_z0", "box_grid_w",
              "box_grid_y0", "box_grid_mat", "box_grid_cells")
_TAIL_META = ("sph_n_tail", "sph_tail_r", "sph_tail_mat", "sph_tail_box")
# K13's and K14's tables, carried from art_tpu's by tables_from_numpy
_SPH_KERNEL_META = ("sph_static_cells", "sph_expand", "sph_pos_r", "mxu_sphere_pad",
                    "mxu_tail_pad", "sph_tail_centroid")
_MXU_ARRAYS = ("sph_mxu_feat", "sph_mxu_attr", "sph_mxu_tail_feat", "sph_mxu_tail_attr")
_MEDIA_META = ("med_kinds", "gb_sph_meds", "gb_quad_meds", "gb_box_meds")


def _detect_box_grid(a: dict, n_b: int, rotated: bool) -> dict:
    """The box-grid fields (``box_grid`` and ``_GRID_META``) of float32 box
    tables, or {} — ``art_tpu/scene/builder.py:_detect_box_grid`` step for
    step: at least 64 boxes, none rotated, one floor y0, one cell width w
    for every box in x and z, every box on one (x, z) lattice as the grid
    kernels rebuild it (``x0 + f32(k) * w`` in float32), at most 4 B cells
    and one box a cell."""
    if n_b < GRID_MIN_BOXES or rotated:
        return {}
    f32 = np.float32
    mn = np.asarray(a["box_min"][:n_b]) + np.asarray(a["box_off"][:n_b])
    mx = np.asarray(a["box_max"][:n_b]) + np.asarray(a["box_off"][:n_b])
    mat = np.asarray(a["box_mat"][:n_b])
    y0 = mn[0, 1]
    if not np.all(mn[:, 1] == y0):
        return {}
    wx, wz = mx[:, 0] - mn[:, 0], mx[:, 2] - mn[:, 2]
    w = wx[0]
    if w <= 0 or not (np.all(wx == w) and np.all(wz == w)):
        return {}
    gx0, gz0 = mn[:, 0].min(), mn[:, 2].min()
    kxs = np.rint((mn[:, 0] - gx0) / w).astype(np.int64)
    kzs = np.rint((mn[:, 2] - gz0) / w).astype(np.int64)
    # the fit as the kernels rebuild it, in float32 at each step (an int64
    # times float32 product would promote to float64)
    rx = f32(gx0) + kxs.astype(f32) * f32(w)
    rz = f32(gz0) + kzs.astype(f32) * f32(w)
    if not (np.all(rx == mn[:, 0].astype(f32)) and np.all(rz == mn[:, 2].astype(f32))):
        return {}
    kx, kz = int(kxs.max()) + 1, int(kzs.max()) + 1
    if kx * kz > 4 * n_b or len(np.unique(kxs * kz + kzs)) != n_b:
        return {}
    grid = np.zeros((kx, kz, 2), f32)
    grid[:, :, 0] = y0  # empty cells: zero height, never hit
    grid[kxs, kzs, 0] = mx[:, 1]
    grid[kxs, kzs, 1] = mat.astype(f32)
    cells = None
    if n_b <= GRID_MAX_CELLS:
        groups: dict = {}
        for b in range(n_b):
            groups.setdefault((float(mx[b, 1]), float(mat[b])), []).append(
                (int(kxs[b]), int(kzs[b])))
        cells = tuple(sorted((h, m, tuple(sorted(g))) for (h, m), g in groups.items()))
    return dict(box_grid=grid, box_grid_kx=kx, box_grid_kz=kz, box_grid_x0=float(gx0),
                box_grid_z0=float(gz0), box_grid_w=float(w), box_grid_y0=float(y0),
                box_grid_mat=float(mat[0]) if np.all(mat == mat[0]) else -1.0,
                box_grid_cells=cells)


def _sphere_tail(rows: np.ndarray) -> dict:
    """``_TAIL_META`` of (S, 10) float32 sphere rows: the largest (radius,
    material)-uniform group of at least ``TAIL_MIN`` static spheres, first
    among equals in ``np.unique``'s order (``pack_spheres``), and its box,
    centers ± |r| inflated by 1e-3 + 1e-6 max|coord| in float64
    (``pack_tail_spheres``); {} when there is none."""
    stat = rows[~np.any(rows[:, 3:6] != 0.0, axis=1)]
    if len(stat) < TAIL_MIN:
        return {}
    keys, counts = np.unique(stat[:, 6:8], axis=0, return_counts=True)
    k = int(np.argmax(counts))
    if counts[k] < TAIL_MIN:
        return {}
    tail_r, tail_mat = float(keys[k, 0]), float(keys[k, 1])
    tail = stat[(stat[:, 6] == tail_r) & (stat[:, 7] == tail_mat)]
    c = tail[:, 0:3].astype(np.float64)
    r = np.abs(tail[:, 6:7].astype(np.float64))
    lo, hi = (c - r).min(axis=0), (c + r).max(axis=0)
    eps = 1e-3 + 1e-6 * float(np.max(np.abs(np.concatenate([lo, hi]))))
    return dict(sph_n_tail=int(counts[k]), sph_tail_r=tail_r, sph_tail_mat=tail_mat,
                sph_tail_box=tuple(float(v) for v in np.concatenate([lo - eps, hi + eps])))


def _kernel_order(rows: np.ndarray, n_tail: int, tail_r: float, tail_mat: float):
    """``pack_spheres``' order of (S, 10) float32 sphere rows, unpadded:
    the moving rows, then the static ones with the tail (the static rows of
    radius ``tail_r`` and material ``tail_mat``) last, each in scene order;
    column 9 is K = |c|^2 - r^2, the float64 sum rounded once.  Returns
    (rows, number of moving rows)."""
    moving = np.any(rows[:, 3:6] != 0.0, axis=1)
    mov, stat = rows[moving], rows[~moving]
    if n_tail:
        sel = (stat[:, 6] == tail_r) & (stat[:, 7] == tail_mat)
        stat = np.concatenate([stat[~sel], stat[sel]], axis=0)
    out = np.concatenate([mov, stat], axis=0).astype(np.float32)
    c = out[:, 0:3].astype(np.float64)
    out[:, 9] = (np.sum(c * c, axis=1) - out[:, 8].astype(np.float64)).astype(np.float32)
    return out, len(mov)


def static_sphere_cells(packed: np.ndarray, n_moving: int, n_tail: int) -> tuple:
    """K13's compile-time cells (``pallas_kernels.py:346``) of
    ``_kernel_order``'s rows: (moving, main, tail), the moving rows (cx0,
    cy0, cz0, vx, vy, vz, r, mat, r2) with r2 > 0, the static rows but the
    tail (cx, cy, cz, r, mat, r2, K) and the tail (cx, cy, cz, r2, K), as
    Python floats of the float32 values."""
    mov, stat = packed[:n_moving], packed[n_moving:]
    mov = mov[mov[:, 8] > 0.0]
    n_main = len(stat) - n_tail
    moving = tuple(tuple(float(x) for x in r[:9]) for r in mov)
    main = tuple(tuple(float(r[k]) for k in (0, 1, 2, 6, 7, 8, 9)) for r in stat[:n_main])
    tail = tuple(tuple(float(r[k]) for k in (0, 1, 2, 8, 9)) for r in stat[n_main:])
    return moving, main, tail


def sphere_mxu_features(rows: np.ndarray, n: int):
    """K14's bilinear features (``pallas_kernels.py:568-615``) of the first
    ``n`` (S, 10) sphere rows: F (2 S_pad, 16) float32, B's features
    [c0, v] in rows 0..n and C's [-2 c0, -2 v, |c0|^2 - r^2, 2 c0.v, |v|^2]
    in rows S_pad..S_pad + n, and attrT (8, S_pad) [c0; v; r; mat], with
    S_pad = n rounded up to 128 (pad rows all zero, pad radius 1);
    the float32 numpy arithmetic of ``art_tpu``, so bit for bit its values."""
    p = np.asarray(rows)[:n]
    c0, v, r, m = p[:, 0:3], p[:, 3:6], p[:, 6], p[:, 7]
    s_pad = -(-n // 128) * 128
    F = np.zeros((2 * s_pad, 16), np.float32)
    F[:n, 0:3] = c0
    F[:n, 3:6] = v
    F[s_pad:s_pad + n, 6:9] = -2.0 * c0
    F[s_pad:s_pad + n, 9:12] = -2.0 * v
    F[s_pad:s_pad + n, 12] = np.sum(c0 * c0, axis=-1) - r * r
    F[s_pad:s_pad + n, 13] = 2.0 * np.sum(c0 * v, axis=-1)
    F[s_pad:s_pad + n, 14] = np.sum(v * v, axis=-1)
    attr = np.zeros((8, s_pad), np.float32)
    attr[0:3, :n] = c0.T
    attr[3:6, :n] = v.T
    attr[6, :n] = r
    attr[6, n:] = 1.0
    attr[7, :n] = m
    return torch.from_numpy(F), torch.from_numpy(attr), s_pad


def _sphere_kernel_tables(sph: np.ndarray, tail: dict, tail_rows: np.ndarray,
                          mxu_force: bool = MXU_FORCE) -> dict:
    """``_SPH_KERNEL_META`` and ``_MXU_ARRAYS`` of the (S, 10) sphere rows
    ``sph``, as ``art_tpu``'s builder derives them (``builder.py:652-680``,
    ``:735-811``): the cells for at most 2048 spheres; the expanded
    quadratic where its rounding error stays below 1% of every static
    r^2; the features where the second-largest reach (max |c| + max |v| +
    |r|) is at most 64 and the largest at most 4096, or with ``mxu_force``
    (``ART_TPU_MXU_FORCE``); the recentered tail features for a tail of at
    least 512 rows with its box."""
    n = len(sph)
    n_tail = tail.get("sph_n_tail", 0)
    packed, n_moving = _kernel_order(sph, n_tail, tail.get("sph_tail_r", 1.0),
                                     tail.get("sph_tail_mat", 0.0))
    stat = packed[n_moving:]
    cc = np.sum(stat[:, 0:3].astype(np.float64) ** 2, axis=1)
    out = dict(
        sph_pos_r=bool(np.all(sph[:, 6] > 0.0)) if n else True,
        sph_expand=bool(len(stat)) and bool(np.all(
            (cc + 1.0) * 6.0 * 2.0**-23 < 0.01 * stat[:, 8].astype(np.float64))),
        sph_static_cells=(static_sphere_cells(packed, n_moving, n_tail)
                          if 0 < n <= STATIC_MAX_SPHERES else None),
        mxu_sphere_pad=0, mxu_tail_pad=0, sph_tail_centroid=())
    if n:
        reach = np.sort(np.abs(sph[:, 0:3]).max(axis=1) + np.abs(sph[:, 3:6]).max(axis=1)
                        + np.abs(sph[:, 6]))
        second = float(reach[-2]) if n > 1 else float(reach[-1])
        if (second <= 64.0 and float(reach[-1]) <= 4096.0) or mxu_force:
            out["sph_mxu_feat"], out["sph_mxu_attr"], out["mxu_sphere_pad"] = \
                sphere_mxu_features(sph, n)
    if n_tail >= MXU_TAIL_MIN and tail.get("sph_tail_box"):
        tp = tail_rows.copy()
        g = tp[:n_tail, 0:3].mean(axis=0)
        tp[:n_tail, 0:3] -= g
        out["sph_mxu_tail_feat"], out["sph_mxu_tail_attr"], out["mxu_tail_pad"] = \
            sphere_mxu_features(tp, n_tail)
        out["sph_tail_centroid"] = tuple(float(x) for x in g)
    return out


def _tables(arrays: dict) -> SceneTables:
    """SceneTables from ``art_tpu``-named arrays; the box grid and the
    sphere tail are derived from them unless given."""
    a = {**_EMPTY, **arrays}
    t = {k: torch.from_numpy(np.array(a[k])) for k in _ARRAY_FIELDS}
    # a count not given is the number of rows given (0 for a dummy table)
    n_s, n_q, n_b, n_m = (int(a.get(f"n_{k}", len(arrays.get(p, ())))) for k, p in (
        ("spheres", "sph_mat"), ("quads", "quad_mat"), ("boxes", "box_mat"),
        ("media", "med_kind")))
    rotated = bool(a.get("has_rotated_boxes", False))
    consts = a.get("shade_consts")
    sp = a.get("sp_consts")
    sp_sph, sp_quad, sp_mat = sp_rows(sp)
    sph = sphere_rows(t["sph_center"], t["sph_vel"], t["sph_radius"], t["sph_mat"])[:n_s]
    grid = ({k: a[k] for k in _GRID_META} if "box_grid_kx" in arrays
            else _detect_box_grid(a, n_b, rotated))
    if "box_grid" in grid:  # detected here (a given grid is in t already)
        t["box_grid"] = torch.from_numpy(grid.pop("box_grid"))
    tail = ({k: a[k] for k in _TAIL_META} if "sph_n_tail" in arrays
            else _sphere_tail(sph.numpy()))
    head_rows, tail_rows = split_sphere_rows(sph, tail.get("sph_n_tail", 0),
                                             tail.get("sph_tail_r", 1.0),
                                             tail.get("sph_tail_mat", 0.0))
    cull = cull_tables(head_rows, tail_rows, sph, tail.get("sph_tail_box", ()))
    if "mxu_sphere_pad" in arrays:  # carried from art_tpu; absent tables as None
        sk = {k: a[k] for k in _SPH_KERNEL_META}
        sk.update({k: torch.from_numpy(np.array(a[k], np.float32)) for k in _MXU_ARRAYS
                   if a["mxu_sphere_pad" if "tail" not in k else "mxu_tail_pad"]})
    else:
        sk = _sphere_kernel_tables(sph.numpy(), tail, tail_rows.numpy())
    boxes = box_rows(t["box_min"], t["box_max"], t["box_cos"], t["box_sin"], t["box_off"],
                     t["box_mat"], rotated)[:n_b]
    moving = bool(a.get("has_moving", bool(np.any(a["sph_vel"] != 0.0))))
    tn = {k: v.numpy() for k, v in t.items()}
    cull.update(cluster_tables(tn, n_s, n_b, sph, boxes), sph_bvh=bvh_table(tn, n_s, moving))
    media = {k: tuple(int(x) for x in a.get(k, ())) for k in _MEDIA_META}
    if "med_kinds" not in arrays:
        media["med_kinds"] = tuple(int(x) for x in a["med_kind"][:n_m])
    return SceneTables(
        **t,
        sph_rows=sph,
        sph_head_rows=head_rows, sph_tail_rows=tail_rows, **cull, **sk,
        quad_rows=quad_rows(t["quad_n"], t["quad_d"], t["quad_avec"], t["quad_ca"],
                            t["quad_bvec"], t["quad_cb"])[:n_q],
        box_rows=boxes,
        box_grid_rows=t["box_grid"].reshape(t["box_grid"].shape[0], -1).contiguous(),
        box_grid_cell_rows=grid_cell_rows(grid.get("box_grid_cells")),
        n_spheres=n_s, n_quads=n_q, n_boxes=n_b, n_media=n_m, **media, **grid, **tail,
        has_moving=moving,
        has_rotated_boxes=rotated,
        tex_types_present=tuple(int(x) for x in a["tex_types_present"]),
        shade_consts=consts,
        shade_rows=shade_rows(consts),
        sp_consts=sp, sp_sph_rows=sp_sph, sp_quad_rows=sp_quad, sp_mat_rows=sp_mat,
        med_rows=media_rows(media["med_kinds"], *(t[k] for k in (
            "med_center", "med_radius", "med_min", "med_max", "med_cos", "med_sin",
            "med_off", "med_neg_inv_density", "med_mat", "gb_sph", "gb_quad", "gb_box")),
            tuple(media[k] for k in _MEDIA_META[1:])),
        atlas=a.get("atlas") or ImageAtlas.empty(),
    )


def tables_from_numpy(arrays: dict, camera: dict) -> tuple[SceneTables, Camera]:
    """Port tables + camera from ``art_tpu`` fields given as numpy arrays.

    ``arrays`` maps ``SceneTables`` field names (at least the material and
    texture fields and those of each primitive kind and medium present;
    optionally ``n_spheres``, ``n_quads``, ``n_boxes``, ``n_media``,
    ``has_moving``, ``has_rotated_boxes``, ``tex_types_present``,
    ``shade_consts``, ``sp_consts``, ``med_kinds``, the ``gb_*_meds`` of
    kind-2 boundaries, the box grid (``box_grid`` with ``box_grid_kx`` and
    the other ``box_grid_*`` fields), the sphere tail (``sph_n_tail``,
    ``sph_tail_r``, ``sph_tail_mat``, ``sph_tail_box``) and the tables of
    K13 and K14 (``sph_static_cells``, ``sph_expand``, ``sph_pos_r``,
    ``mxu_sphere_pad``, ``mxu_tail_pad``, ``sph_tail_centroid`` and the
    ``sph_mxu_*`` feature arrays); a grid, tail or sphere kernel table not
    given is derived from the tables as ``art_tpu``'s builder derives it) to
    values, and ``atlas`` to a mapping of ``art_tpu``'s ``ImageAtlas``
    fields (``data``, ``heights``, ``widths``, ``hmax``, ``wmax``) when the
    scene has images; ``camera`` maps the ``Camera`` field names to (3,) or
    scalar arrays."""
    if "tex_types_present" not in arrays:
        arrays = dict(arrays, tex_types_present=tuple(
            sorted({int(x) for x in np.asarray(arrays["tex_type"])})))
    if arrays.get("atlas") is not None:
        atlas = arrays["atlas"]
        arrays = dict(arrays, atlas=ImageAtlas.from_numpy(
            *(atlas[k] for k in ("data", "heights", "widths", "hmax", "wmax"))))
    cam = Camera(**{
        f.name: (np.asarray(camera[f.name], np.float32)
                 if np.ndim(camera[f.name]) else np.float32(camera[f.name]))
        for f in dataclasses.fields(Camera)
    })
    return _tables({k: np.asarray(v) if k in _ARRAY_FIELDS else v
                    for k, v in arrays.items()}), cam
