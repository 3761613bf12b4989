"""Host-side geometry DSL.

Mirrors the reference hittables (sphere src/sphere.cuh, quad/make_box
src/quad.cuh, constant_medium src/constant_medium.cuh) plus the instancing
wrappers translate/rotate_y/with_material (src/hittable.cuh:40-178).
Transforms are *baked at compile time*: a y-rotation + translation chain is
an affine map, applied directly to sphere centers and quad frames and kept
as (cos, sin, offset) parameters for oriented boxes — no per-ray transform
work remains in the hot path.
"""

from __future__ import annotations

import dataclasses

from art_tpu_torch.scene.materials import Material
from art_tpu_torch.scene.textures import Texture, as_texture


class SceneObject:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Sphere(SceneObject):
    """Static or moving sphere; radius may be negative for hollow shells
    (reference src/sphere.cuh:21-38, src/main.cu:439)."""

    center: tuple
    radius: float
    material: Material
    center2: tuple | None = None  # moving sphere target at t=1


@dataclasses.dataclass(frozen=True, eq=False)
class Quad(SceneObject):
    """Parallelogram Q + edges u,v (src/quad.cuh:29-41); ``inward`` flips
    the geometric normal."""

    q: tuple
    u: tuple
    v: tuple
    material: Material
    inward: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Box(SceneObject):
    """Axis-aligned box between corners a, b (reference make_box,
    src/quad.cuh:145-162).  Compiles to one oriented-box row, not 6 quads."""

    a: tuple
    b: tuple
    material: Material


@dataclasses.dataclass(frozen=True, eq=False)
class Group(SceneObject):
    """Fixed collection of child objects sharing a transform chain — the
    host-side analog of the reference's ``hittable_list``/``bvh_node``
    aggregates (src/hittable_list.cuh:7-57, src/bvh.cuh:20-116).  Children
    flatten into the scene tables at compile time; as a ConstantMedium
    boundary it selects the general two-traversal medium path."""

    children: tuple

    def __init__(self, *children):
        if len(children) == 1 and isinstance(children[0], (list, tuple)):
            children = tuple(children[0])
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True, eq=False)
class ConstantMedium(SceneObject):
    """Homogeneous medium inside a boundary hittable (src/constant_medium.cuh).

    A boundary reducing to a single (possibly transformed) Sphere or Box
    compiles to the closed-form analytic interval path; ANY other boundary
    (Quad, Group, mixtures) compiles to the general two-traversal path,
    matching the reference's first-hit/second-hit semantics
    (src/constant_medium.cuh:38-44) for arbitrary hittables.
    """

    boundary: SceneObject
    density: float
    texture: Texture

    def __init__(self, boundary, density, tex_or_color):
        object.__setattr__(self, "boundary", boundary)
        object.__setattr__(self, "density", float(density))
        object.__setattr__(self, "texture", as_texture(tex_or_color))


@dataclasses.dataclass(frozen=True, eq=False)
class Translate(SceneObject):
    """src/hittable.cuh:40-69"""

    obj: SceneObject
    offset: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class RotateY(SceneObject):
    """src/hittable.cuh:77-149 (degrees)"""

    obj: SceneObject
    degrees: float


@dataclasses.dataclass(frozen=True, eq=False)
class WithMaterial(SceneObject):
    """Per-instance material override (src/hittable.cuh:154-178)."""

    obj: SceneObject
    material: Material
