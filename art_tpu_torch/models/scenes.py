"""The reference scene suite on the port's DSL (``art_tpu/models/scenes.py``).

Slice 1 ports ``bouncing_spheres`` (``scenes.py:70``) and ``three_spheres``
(``scenes.py:461``) with the same construction order, so their tables equal
``art_tpu``'s.  The other reference scenes are listed with their defaults
and raise ``NotImplementedError`` until their slice lands.
"""

from __future__ import annotations

import numpy as np

from art_tpu_torch.scene.builder import CompiledScene, SceneBuilder
from art_tpu_torch.scene.materials import Dielectric, DiffuseLight, Lambertian, Metal
from art_tpu_torch.scene.objects import Sphere
from art_tpu_torch.scene.textures import Checker, SolidColor

UT_ORANGE = (1.0, 0.51, 0.0)  # src/main.cu:168


def pick_ut_color(r: float) -> tuple:
    """UT palette picker (src/main.cu:149-158)."""
    if r < 0.25:
        return (1.0, 1.0, 1.0)
    if r < 0.50:
        return UT_ORANGE
    if r < 0.75:
        return (0.60, 0.60, 0.60)
    return (0.0, 0.0, 0.0)


def bouncing_spheres(nx: int, ny: int, seed: int = 1984,
                     arg_order: str = "ltr") -> CompiledScene:
    """Book-1 final scene, UT palette + emissive movers (src/main.cu:160-244).

    The grid layout replays the reference's cuRAND XORWOW draw sequence
    (core/xorwow.py); ``arg_order`` resolves the two unspecified
    argument-evaluation-order sites exactly as ``art_tpu`` does."""
    from art_tpu_torch.core.xorwow import XorwowState

    rnd = XorwowState(seed).uniform
    ltr = arg_order == "ltr"
    b = SceneBuilder().set_name("bouncing_spheres")

    checker = Checker(0.64, SolidColor((1.0, 1.0, 1.0)), SolidColor(UT_ORANGE))
    b.add(Sphere((0.0, -1000.0, -1.0), 1000.0, Lambertian(checker)))

    P_EMISSIVE = 0.10
    EMIT_POWER = 4.0
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose_mat = rnd()
            if ltr:
                cx = a + 0.9 * rnd()
                cz = bb + 0.9 * rnd()
            else:
                cz = bb + 0.9 * rnd()
                cx = a + 0.9 * rnd()
            center = (cx, 0.2, cz)
            if choose_mat < 0.8:
                if ltr:
                    vy = 0.5 * rnd()
                    vz = 0.25 * (rnd() - 0.5)
                else:
                    vz = 0.25 * (rnd() - 0.5)
                    vy = 0.5 * rnd()
                vel = (0.0, vy, vz)
                center2 = tuple(c + v for c, v in zip(center, vel))
                if rnd() < P_EMISSIVE:
                    emit = tuple(EMIT_POWER * c for c in UT_ORANGE)
                    b.add(Sphere(center, 0.2, DiffuseLight(emit), center2=center2))
                else:
                    albedo = pick_ut_color(rnd())
                    b.add(Sphere(center, 0.2, Lambertian(albedo), center2=center2))
            elif choose_mat < 0.95:
                albedo = pick_ut_color(rnd())
                if sum(albedo) < 1e-5:
                    albedo = (0.15, 0.15, 0.15)
                b.add(Sphere(center, 0.2, Metal(albedo, 0.5 * rnd())))
            else:
                b.add(Sphere(center, 0.2, Dielectric(1.5)))

    b.add(
        Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)),
        Sphere((-4.0, 1.0, 0.0), 1.0, Lambertian((0.4, 0.2, 0.1))),
        Sphere((4.0, 1.0, 0.0), 1.0, Metal((0.7, 0.6, 0.5), 0.0)),
    )
    lookfrom = np.array([13.0, 2.0, 3.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0),
        vfov_degrees=30.0, aspect=nx / ny, aperture=0.1,
        focus_dist=float(np.linalg.norm(lookfrom)), time0=0.0, time1=1.0,
    )
    b.set_background((0, 0, 0), gradient=False)  # src/main.cu:707
    return b.compile()


def three_spheres(nx: int, ny: int) -> CompiledScene:
    """Minimal lambertian/metal/dielectric validation scene."""
    b = SceneBuilder().set_name("three_spheres")
    b.add(
        Sphere((0.0, -100.5, -1.0), 100.0, Lambertian((0.8, 0.8, 0.0))),
        Sphere((0.0, 0.0, -1.0), 0.5, Lambertian((0.1, 0.2, 0.5))),
        Sphere((-1.0, 0.0, -1.0), 0.5, Dielectric(1.5)),
        Sphere((1.0, 0.0, -1.0), 0.5, Metal((0.8, 0.6, 0.2), 0.0)),
    )
    b.set_camera(
        lookfrom=(0, 0, 0), lookat=(0, 0, -1), vup=(0, 1, 0),
        vfov_degrees=90.0, aspect=nx / ny, aperture=0.0, focus_dist=1.0,
    )
    b.set_background(gradient=True)
    return b.compile()


def _later_slice(name: str):
    def build(nx: int, ny: int) -> CompiledScene:
        raise NotImplementedError(
            f"scene {name!r} needs quads, boxes, media or image/noise "
            "textures, which later slices of art_tpu_torch port; slice 1 "
            "renders bouncing_spheres and three_spheres"
        )

    return build


SCENES = {
    "bouncing_spheres": bouncing_spheres,
    "checkered_spheres": _later_slice("checkered_spheres"),
    "earth": _later_slice("earth"),
    "perlin": _later_slice("perlin"),
    "quads": _later_slice("quads"),
    "simple_light": _later_slice("simple_light"),
    "simple_light_book": _later_slice("simple_light_book"),
    "cornell_box": _later_slice("cornell_box"),
    "cornell_smoke": _later_slice("cornell_smoke"),
    "final_scene": _later_slice("final_scene"),
    "original_scene": _later_slice("original_scene"),
    "three_spheres": three_spheres,
}

_DEFAULTS = {
    "bouncing_spheres": dict(nx=1200, ny=600, spp=10000),
    "checkered_spheres": dict(nx=1200, ny=600, spp=500),
    "earth": dict(nx=1200, ny=600, spp=500),
    "perlin": dict(nx=1200, ny=600, spp=500),
    "quads": dict(nx=1200, ny=600, spp=500),
    "simple_light": dict(nx=1200, ny=600, spp=10000),
    "simple_light_book": dict(nx=1200, ny=600, spp=10000),
    "cornell_box": dict(nx=600, ny=600, spp=10000),
    "cornell_smoke": dict(nx=600, ny=600, spp=1000),
    "final_scene": dict(nx=800, ny=800, spp=10000),
    "original_scene": dict(nx=800, ny=800, spp=10000),
    "three_spheres": dict(nx=400, ny=225, spp=16),
}


def scene_defaults(name: str) -> dict:
    d = dict(_DEFAULTS[name])
    d["gamma"] = 2.2
    return d


def build_scene(name: str, nx: int | None = None, ny: int | None = None) -> CompiledScene:
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    d = _DEFAULTS[name]
    return SCENES[name](nx or d["nx"], ny or d["ny"])
