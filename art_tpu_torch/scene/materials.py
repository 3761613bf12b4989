"""Host-side material DSL (compiled to the tag-dispatched material table).

Mirrors the reference material classes (src/material.cuh:62-201)."""

from __future__ import annotations

import dataclasses

from art_tpu_torch.scene.textures import Texture, as_texture


class Material:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class Lambertian(Material):
    """Texture-backed diffuse (src/material.cuh:62-87)."""

    texture: Texture

    def __init__(self, tex_or_color):
        object.__setattr__(self, "texture", as_texture(tex_or_color))


@dataclasses.dataclass(frozen=True, eq=False)
class Metal(Material):
    """src/material.cuh:90-110; fuzz clamped to <= 1 at build."""

    albedo: tuple
    fuzz: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class Dielectric(Material):
    """src/material.cuh:113-160."""

    ref_idx: float


@dataclasses.dataclass(frozen=True, eq=False)
class DiffuseLight(Material):
    """src/material.cuh:162-183 (emission from texture or solid color)."""

    texture: Texture

    def __init__(self, tex_or_color):
        object.__setattr__(self, "texture", as_texture(tex_or_color))


@dataclasses.dataclass(frozen=True, eq=False)
class Isotropic(Material):
    """Uniform phase function (src/material.cuh:185-201)."""

    texture: Texture

    def __init__(self, tex_or_color):
        object.__setattr__(self, "texture", as_texture(tex_or_color))
