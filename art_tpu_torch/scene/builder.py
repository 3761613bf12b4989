"""Scene compiler: DSL object graph -> flat SoA tables (slice 1 subset).

Port of the sphere / material / texture part of ``art_tpu/scene/builder.py``
(``_Compiler`` at ``builder.py:186-407`` and ``finish:481-627``), including
the value dedup of material and texture rows and the ``mat_packed`` /
``tex_packed`` row layouts, so the tables come out identical to
``art_tpu``'s.  Quads, boxes, constant media and every texture but solid
and checker belong to later slices of the port and raise
``NotImplementedError``.

``tables_from_numpy`` carries tables compiled by ``art_tpu`` (as numpy
arrays) into this package — the tests use it to run both packages on the
very same scene data.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from art_tpu_torch.core.camera import Camera, make_camera
from art_tpu_torch.scene import materials as M
from art_tpu_torch.scene import objects as O
from art_tpu_torch.scene import textures as X
from art_tpu_torch.scene.tables import MatType, SceneTables, TexType, sphere_rows

_SLICE = "art_tpu_torch slice 1 ports spheres with solid/checker textures"


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
        self.mats: list[dict] = []
        self.texs: list[dict] = []
        self._mat_ids: dict[int, int] = {}
        self._tex_ids: dict[int, int] = {}
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
        elif isinstance(tex, (X.ImageTexture, X.NoiseTexture, X.NoodleTexture,
                              X.FeltTexture, X.UVOffset)):
            raise NotImplementedError(f"{type(tex).__name__}: {_SLICE}")
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
            self.spheres.append((c0, vel, float(obj.radius), self.mat_id(mat)))
        elif isinstance(obj, O.Group):
            for child in obj.children:
                self.visit(child, xf, material_override)
        elif isinstance(obj, (O.Quad, O.Box, O.ConstantMedium)):
            raise NotImplementedError(f"{type(obj).__name__}: {_SLICE}")
        else:
            raise TypeError(f"unknown scene object: {type(obj)!r}")

    def finish(self) -> SceneTables:
        f32 = np.float32
        if not self.spheres:
            raise NotImplementedError(f"a scene without spheres: {_SLICE}")
        if not self.mats:
            self.mat_id(M.Lambertian((0.5, 0.5, 0.5)))
        arrays = dict(
            sph_center=np.stack([s[0] for s in self.spheres]).astype(f32),
            sph_vel=np.stack([s[1] for s in self.spheres]).astype(f32),
            sph_radius=np.asarray([s[2] for s in self.spheres], f32),
            sph_mat=np.asarray([s[3] for s in self.spheres], np.int32),
            mat_type=np.asarray([m["type"] for m in self.mats], np.int32),
            mat_tex=np.asarray([m["tex"] for m in self.mats], np.int32),
            mat_rgb=np.asarray([m["rgb"] for m in self.mats], f32),
            mat_fuzz=np.asarray([m["fuzz"] for m in self.mats], f32),
            mat_ref_idx=np.asarray([m["ref_idx"] for m in self.mats], f32),
            mat_packed=np.asarray(
                [[m["type"], m["tex"], m["fuzz"], m["ref_idx"], *m["rgb"], 0.0]
                 for m in self.mats], f32),
        )
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
        return _tables(arrays)


# one dummy row per empty texture table, as art_tpu's empty_tables()
_EMPTY_TEX = dict(
    tex_type=np.zeros((1,), np.int32),
    tex_rgb=np.ones((1, 3), np.float32),
    tex_rgb2=np.zeros((1, 3), np.float32),
    tex_params=np.zeros((1, 8), np.float32),
    tex_child=np.zeros((1, 2), np.int32),
    tex_img=np.zeros((1,), np.int32),
    tex_packed=np.zeros((1, 18), np.float32),
    tex_types_present=(),
)

_ARRAY_FIELDS = (
    "sph_center", "sph_vel", "sph_radius", "sph_mat",
    "mat_type", "mat_tex", "mat_rgb", "mat_fuzz", "mat_ref_idx",
    "tex_type", "tex_rgb", "tex_rgb2", "tex_params", "tex_child", "tex_img",
    "mat_packed", "tex_packed",
)


def _tables(arrays: dict) -> SceneTables:
    a = {**_EMPTY_TEX, **arrays}
    t = {k: torch.from_numpy(np.array(a[k])) for k in _ARRAY_FIELDS}
    n = int(a.get("n_spheres", t["sph_center"].shape[0]))
    for k in ("sph_center", "sph_vel", "sph_radius", "sph_mat"):
        t[k] = t[k][:n]
    return SceneTables(
        **t,
        sph_rows=sphere_rows(t["sph_center"], t["sph_vel"], t["sph_radius"],
                             t["sph_mat"]),
        n_spheres=n,
        has_moving=bool(a.get("has_moving", bool(np.any(a["sph_vel"] != 0.0)))),
        tex_types_present=tuple(int(x) for x in a["tex_types_present"]),
    )


def tables_from_numpy(arrays: dict, camera: dict) -> tuple[SceneTables, Camera]:
    """Port tables + camera from ``art_tpu`` fields given as numpy arrays.

    ``arrays`` maps ``SceneTables`` field names (at least the sphere,
    material and texture fields; optionally ``n_spheres``, ``has_moving``
    and ``tex_types_present``) to values; ``camera`` maps the ``Camera``
    field names to (3,) or scalar arrays.  Scenes with quads, boxes or media
    raise ``NotImplementedError``."""
    for k in ("n_quads", "n_boxes", "n_media"):
        if int(arrays.get(k, 0)):
            raise NotImplementedError(f"{k}={int(arrays[k])}: {_SLICE}")
    if "tex_types_present" not in arrays:
        arrays = dict(arrays, tex_types_present=tuple(
            sorted({int(x) for x in np.asarray(arrays["tex_type"])})))
    cam = Camera(**{
        f.name: (np.asarray(camera[f.name], np.float32)
                 if np.ndim(camera[f.name]) else np.float32(camera[f.name]))
        for f in dataclasses.fields(Camera)
    })
    return _tables({k: np.asarray(v) if k in _ARRAY_FIELDS else v
                    for k, v in arrays.items()}), cam
