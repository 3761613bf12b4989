"""Host-side texture DSL (compiled to the tag-dispatched texture table).

Mirrors the reference texture classes (src/texture.cuh:16-164) as plain
Python parameter holders; ``SceneBuilder.compile`` flattens them into
``SceneTables`` rows.  Shared instances are deduplicated by identity, like
the reference sharing one ``checker_texture`` across spheres
(src/main.cu:255-262).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

ColorLike = Union[tuple, list, np.ndarray]


class Texture:
    pass


@dataclasses.dataclass(frozen=True, eq=False)
class SolidColor(Texture):
    """src/texture.cuh:16-23"""

    albedo: ColorLike


@dataclasses.dataclass(frozen=True, eq=False)
class Checker(Texture):
    """3-D lattice checker (src/texture.cuh:25-43); scale is the tile size."""

    scale: float
    even: Texture
    odd: Texture


@dataclasses.dataclass(frozen=True, eq=False)
class ImageTexture(Texture):
    """Nearest-neighbor image lookup (src/texture.cuh:45-60).

    ``image`` is an (H,W,3) uint8 array or an asset file name.
    """

    image: object


@dataclasses.dataclass(frozen=True, eq=False)
class NoiseTexture(Texture):
    """Perlin marble (src/texture.cuh:62-76)."""

    scale: float


@dataclasses.dataclass(frozen=True, eq=False)
class NoodleTexture(Texture):
    """Warped stripes (src/texture.cuh:84-103)."""

    stripes_k: float = 3.0
    wiggle_amp: float = 3.0
    wiggle_freq: float = 0.6
    octaves: int = 3
    direction: ColorLike = (0.0, 0.0, 1.0)
    noodle: ColorLike = (0.92, 0.85, 0.65)
    gap: ColorLike = (0.35, 0.20, 0.10)


@dataclasses.dataclass(frozen=True, eq=False)
class FeltTexture(Texture):
    """Perlin mottling + fibers (src/texture.cuh:109-148)."""

    base: ColorLike = (0.06, 0.36, 0.18)
    mottling_scale: float = 16.0
    mottling_amt: float = 0.08
    fiber_scale: float = 4.0
    fiber_amt: float = 0.03


@dataclasses.dataclass(frozen=True, eq=False)
class UVOffset(Texture):
    """UV rotation wrapper (src/texture.cuh:151-164); du in turns."""

    base: Texture
    u_offset_turns: float
    v_offset: float = 0.0


def as_texture(value) -> Texture:
    """Promote a raw color to SolidColor (reference lambertian(vec3) ctor)."""
    if isinstance(value, Texture):
        return value
    return SolidColor(value)
