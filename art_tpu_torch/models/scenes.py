"""The reference scene suite on the port's DSL (``art_tpu/models/scenes.py``).

Every scene of ``art_tpu``'s registry, built in the same construction
order, so their tables equal ``art_tpu``'s: ``bouncing_spheres``
(``scenes.py:70``), ``checkered_spheres`` (``:151``), ``earth`` (``:166``),
``perlin`` (``:179``), ``quads`` (``:193``), ``simple_light`` (``:212``),
``simple_light_book`` (``:239``), ``cornell_box`` (``:266``),
``cornell_smoke`` (``:314``), ``final_scene`` (``:368``),
``original_scene`` (``:417``) and ``three_spheres`` (``:461``).
"""

from __future__ import annotations

import math

import numpy as np

from art_tpu_torch.scene.builder import CompiledScene, SceneBuilder
from art_tpu_torch.scene.materials import Dielectric, DiffuseLight, Lambertian, Metal
from art_tpu_torch.scene.objects import (
    Box,
    ConstantMedium,
    Quad,
    RotateY,
    Sphere,
    Translate,
)
from art_tpu_torch.scene.textures import (
    Checker,
    FeltTexture,
    ImageTexture,
    NoiseTexture,
    NoodleTexture,
    SolidColor,
    UVOffset,
)
from art_tpu_torch.utils import tracing

UT_ORANGE = (1.0, 0.51, 0.0)  # src/main.cu:168


def random_in_unit_cube(seed: int) -> np.ndarray:
    """Bit-exact port of the deterministic LCG+xorshift hash (src/util.cuh:3-11)."""
    s = np.uint32((1103515245 * (seed + 1) + 12345) & 0xFFFFFFFF)

    def next01():
        nonlocal s
        s ^= np.uint32(s << np.uint32(13))
        s ^= np.uint32(s >> np.uint32(17))
        s ^= np.uint32(s << np.uint32(5))
        return float(s & np.uint32(0xFFFFFF)) * (1.0 / 16777216.0)

    return np.array([next01(), next01(), next01()])


def rotate_y_deg(p: np.ndarray, deg: float) -> np.ndarray:
    """src/main.cu:489-496"""
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]])


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


def checkered_spheres(nx: int, ny: int) -> CompiledScene:
    """src/main.cu:246-280: two big spheres sharing one checker material."""
    b = SceneBuilder().set_name("checkered_spheres")
    checker = Checker(0.32, SolidColor((0.2, 0.3, 0.1)), SolidColor((0.9, 0.9, 0.9)))
    lam = Lambertian(checker)  # one shared material, as in the reference
    b.add(Sphere((0, -10, 0), 10.0, lam), Sphere((0, 10, 0), 10.0, lam))
    b.set_camera(
        lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
        vfov_degrees=20.0, aspect=nx / ny, aperture=0.0, focus_dist=10.0,
        time0=0.0, time1=1.0,
    )
    b.set_background(gradient=True)  # src/main.cu:774
    return b.compile()


def earth(nx: int, ny: int) -> CompiledScene:
    """src/main.cu:282-308: one image-textured sphere under a gradient sky
    (the texture from its decoded copy, ``utils/images.py``)."""
    b = SceneBuilder().set_name("earth")
    b.add(Sphere((0, 0, 0), 2.0, Lambertian(ImageTexture("earthmap.jpg"))))
    b.set_camera(
        lookfrom=(0, 0, 12), lookat=(0, 0, 0), vup=(0, 1, 0),
        vfov_degrees=20.0, aspect=nx / ny, aperture=0.0, focus_dist=12.0,
        time0=0.0, time1=1.0,
    )
    b.set_background(gradient=True)
    return b.compile()


def perlin(nx: int, ny: int, scale: float = 4.0) -> CompiledScene:
    """src/main.cu:310-329: a marble ground and ball (scale 4.0, as
    src/main.cu:903 passes it)."""
    b = SceneBuilder().set_name("perlin")
    lam = Lambertian(NoiseTexture(scale))
    b.add(Sphere((0, -1000, 0), 1000.0, lam), Sphere((0, 2, 0), 2.0, lam))
    b.set_camera(
        lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
        vfov_degrees=20.0, aspect=nx / ny, aperture=0.0, focus_dist=10.0,
        time0=0.0, time1=1.0,
    )
    b.set_background(gradient=True)
    return b.compile()


def quads_scene(nx: int, ny: int) -> CompiledScene:
    """src/main.cu:331-358: five quads and no sphere."""
    b = SceneBuilder().set_name("quads")
    b.add(
        Quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), Lambertian((1.0, 0.2, 0.2))),
        Quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), Lambertian((0.2, 1.0, 0.2))),
        Quad((3, -2, 1), (0, 0, 4), (0, 4, 0), Lambertian((0.2, 0.2, 1.0))),
        Quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), Lambertian((1.0, 0.5, 0.0))),
        Quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), Lambertian((0.2, 0.8, 0.8))),
    )
    b.set_camera(
        lookfrom=(0, 0, 9), lookat=(0, 0, 0), vup=(0, 1, 0),
        vfov_degrees=80.0, aspect=nx / ny, aperture=0.0, focus_dist=10.0,
        time0=0.0, time1=1.0,
    )
    b.set_background(gradient=True)
    return b.compile()


def simple_light(nx: int, ny: int) -> CompiledScene:
    """src/main.cu:360-400: a pool ball (an image turned by a uv offset)
    under a glass clear coat, on felt, under a sphere and a quad light."""
    b = SceneBuilder().set_name("simple_light")
    felt = FeltTexture((0.06, 0.36, 0.18), 16.0, 0.08, 4.0, 0.03)
    b.add(Sphere((0, -1000, 0), 1000.0, Lambertian(felt)))
    ball_tex = UVOffset(ImageTexture("poolball.jpg"), 60.0 / 360.0)
    center = (0.0, 2.0, 0.0)
    b.add(Sphere(center, 2.0, Lambertian(ball_tex)))
    b.add(Sphere(center, 2.0 + 0.02, Dielectric(1.5)))  # the clear-coat shell
    b.add(
        Sphere((0, 7, 0), 2.0, DiffuseLight((4, 4, 4))),
        Quad((3, 1, -2), (2, 0, 0), (0, 2, 0), DiffuseLight((4, 4, 4))),
    )
    lookfrom = np.array([26.0, 3.0, 6.0])
    lookat = np.array([0.0, 2.0, 0.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=lookat, vup=(0, 1, 0),
        vfov_degrees=20.0, aspect=nx / ny, aperture=0.0,
        focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def simple_light_book(nx: int, ny: int) -> CompiledScene:
    """The book's simple-light scene (RTNW ch. 7), ``art_tpu``'s variant of
    that name: two marble spheres under a sphere light and a quad light, on
    a black background."""
    b = SceneBuilder().set_name("simple_light_book")
    noise = NoiseTexture(4.0)
    b.add(Sphere((0, -1000, 0), 1000.0, Lambertian(noise)))
    b.add(Sphere((0, 2, 0), 2.0, Lambertian(noise)))
    b.add(
        Sphere((0, 7, 0), 2.0, DiffuseLight((4, 4, 4))),
        Quad((3, 1, -2), (2, 0, 0), (0, 2, 0), DiffuseLight((4, 4, 4))),
    )
    lookfrom = np.array([26.0, 3.0, 6.0])
    lookat = np.array([0.0, 2.0, 0.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=lookat, vup=(0, 1, 0),
        vfov_degrees=20.0, aspect=nx / ny, aperture=0.0,
        focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def cornell_box(nx: int, ny: int, legacy_walls: bool = False) -> CompiledScene:
    """src/main.cu:402-450: six inward quads (one the ceiling light), two
    rotated boxes and a hollow glass sphere.  ``legacy_walls=True`` paints
    the x=0 wall the classic book green (0.12, 0.45, 0.15) instead of the
    source's blue, as ``art_tpu``'s variant of the same name."""
    b = SceneBuilder().set_name("cornell_box")
    red = Lambertian((0.65, 0.05, 0.05))
    blue = (Lambertian((0.12, 0.45, 0.15)) if legacy_walls
            else Lambertian((0.15, 0.15, 0.75)))
    white = Lambertian((0.73, 0.73, 0.73))
    light = DiffuseLight((15.0, 15.0, 15.0))

    b.add(
        Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), blue, inward=True),
        Quad((555, 0, 555), (0, 555, 0), (0, 0, -555), red, inward=True),
        Quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white, inward=True),
        Quad((0, 555, 555), (555, 0, 0), (0, 0, -555), white, inward=True),
        Quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white, inward=True),
        Quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light, inward=True),
    )
    b.add(
        Translate(RotateY(Box((0, 0, 0), (165, 165, 165), white), -18.0), (130, 0, 65)),
        Translate(RotateY(Box((0, 0, 0), (165, 330, 165), white), 15.0), (265, 0, 295)),
    )
    glass = Dielectric(1.5)
    b.add(
        Sphere((278.0, 335.0, 150.0), 60.0, glass),
        Sphere((278.0, 335.0, 150.0), -59.0, glass),  # hollow shell
    )
    lookfrom = np.array([278.0, 278.0, -800.0])
    lookat = np.array([278.0, 278.0, 0.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=lookat, vup=(0, 1, 0),
        vfov_degrees=40.0, aspect=nx / ny, aperture=0.0,
        focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def cornell_smoke(nx: int, ny: int) -> CompiledScene:
    """src/main.cu:452-486: the Cornell room with its two boxes as smoke
    (constant media in rotated box boundaries)."""
    b = SceneBuilder().set_name("cornell_smoke")
    red = Lambertian((0.65, 0.05, 0.05))
    white = Lambertian((0.73, 0.73, 0.73))
    green = Lambertian((0.12, 0.45, 0.15))
    light = DiffuseLight((7.0, 7.0, 7.0))

    b.add(
        Quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green, inward=True),
        Quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red, inward=True),
        Quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white, inward=True),
        Quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white, inward=True),
        Quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white, inward=True),
        Quad((113, 554, 127), (330, 0, 0), (0, 0, 305), light, inward=True),
    )
    b1 = Translate(RotateY(Box((0, 0, 0), (165, 330, 165), white), 15.0), (265, 0, 295))
    b2 = Translate(RotateY(Box((0, 0, 0), (165, 165, 165), white), -18.0), (130, 0, 65))
    b.add(
        ConstantMedium(b1, 0.01, (0.5, 0.5, 0.5)),
        ConstantMedium(b2, 0.01, (1.0, 1.0, 1.0)),
    )
    lookfrom = np.array([278.0, 278.0, -800.0])
    lookat = np.array([278.0, 278.0, 0.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=lookat, vup=(0, 1, 0),
        vfov_degrees=40.0, aspect=nx / ny, aperture=0.0,
        focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def _ground_boxes(b: SceneBuilder, ground) -> None:
    """20x20 box ground with the stable height hash (src/main.cu:509-514)."""
    S = 20
    for ix in range(S):
        for iz in range(S):
            w = 100.0
            x0 = -1000.0 + ix * w
            z0 = -1000.0 + iz * w
            y1 = 1.0 + 100.0 * ((ix * 13 + iz * 37) % 100) / 100.0
            b.add(Box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))


def _ball_cluster(b: SceneBuilder, white) -> None:
    """1000-ball cluster with baked 15-degree rotation (src/main.cu:546-552)."""
    for j in range(1000):
        p = random_in_unit_cube(j) * 165.0
        p = rotate_y_deg(p, 15.0) + np.array([-100.0, 270.0, 395.0])
        b.add(Sphere(tuple(p), 10.0, white))


def _big_scene_camera(b: SceneBuilder, nx: int, ny: int) -> None:
    lookfrom = np.array([478.0, 278.0, -600.0])
    lookat = np.array([278.0, 278.0, 0.0])
    b.set_camera(
        lookfrom=lookfrom, lookat=lookat, vup=(0, 1, 0),
        vfov_degrees=40.0, aspect=nx / ny, aperture=0.0,
        focus_dist=float(np.linalg.norm(lookfrom - lookat)),
        time0=0.0, time1=1.0,
    )


def final_scene(nx: int, ny: int) -> CompiledScene:
    """Book-2 final scene (src/main.cu:498-562): a 20x20 box field, a quad
    light, a moving sphere, glass, metal, blue fog in a glass ball, a global
    thin fog, the earth image, a marble sphere and a 1000-ball cluster."""
    b = SceneBuilder().set_name("final_scene")
    white = Lambertian((0.73, 0.73, 0.73))
    ground = Lambertian((0.48, 0.83, 0.53))
    light = DiffuseLight((7, 7, 7))

    _ground_boxes(b, ground)
    b.add(Quad((123, 554, 147), (300, 0, 0), (0, 0, 265), light, inward=True))
    b.add(Sphere((400.0, 400.0, 200.0), 50.0, Lambertian((0.7, 0.3, 0.1)),
                 center2=(430.0, 400.0, 200.0)))
    b.add(
        Sphere((260, 150, 45), 50.0, Dielectric(1.5)),
        Sphere((0, 150, 145), 50.0, Metal((0.8, 0.8, 0.9), 1.0)),
    )
    # blue fog in a visible glass boundary (src/main.cu:529-532)
    b.add(Sphere((360, 150, 145), 70.0, Dielectric(1.5)))
    b.add(ConstantMedium(Sphere((360, 150, 145), 70.0, Dielectric(1.5)), 0.2,
                         (0.2, 0.4, 0.9)))
    # global thin white fog (src/main.cu:535-536)
    b.add(ConstantMedium(Sphere((0, 0, 0), 5000.0, Dielectric(1.5)), 0.0001,
                         (1.0, 1.0, 1.0)))
    b.add(Sphere((400, 200, 400), 100.0, Lambertian(ImageTexture("earthmap.jpg"))))
    b.add(Sphere((220, 280, 300), 80.0, Lambertian(NoiseTexture(0.2))))
    _ball_cluster(b, white)
    _big_scene_camera(b, nx, ny)
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def original_scene(nx: int, ny: int) -> CompiledScene:
    """Custom variant: porcelain boxes, 8-ball, noodle sphere (src/main.cu:564-635)."""
    b = SceneBuilder().set_name("original_scene")
    white = Lambertian((0.73, 0.73, 0.73))
    ground = Lambertian((0.88, 0.50, 0.76))
    light = DiffuseLight((7, 7, 7))

    _ground_boxes(b, ground)
    b.add(Quad((123, 554, 147), (300, 0, 0), (0, 0, 265), light, inward=True))
    b.add(Sphere((400.0, 400.0, 200.0), 50.0, Lambertian((0.0488, 0.0148, 0.0171)),
                 center2=(430.0, 400.0, 200.0)))
    b.add(
        Sphere((260, 150, 45), 50.0, Dielectric(1.5)),
        Sphere((0, 150, 145), 50.0, Metal((0.6387, 0.3605, 0.8826), 1.0)),
    )
    # 8-ball + clear coat (src/main.cu:594-606)
    b.add(Sphere((360.0, 150.0, 145.0), 70.0, Lambertian(ImageTexture("8ball.jpg"))))
    b.add(Sphere((360.0, 150.0, 145.0), 70.5, Dielectric(1.5)))
    b.add(ConstantMedium(Sphere((0, 0, 0), 5000.0, Dielectric(1.5)), 0.0001,
                         (1.0, 1.0, 1.0)))
    b.add(Sphere((400, 200, 400), 100.0, Metal((0.23, 0.24, 0.85), 0.02)))
    b.add(Sphere((220, 280, 300), 80.0, Lambertian(NoodleTexture(0.2))))
    _ball_cluster(b, white)
    _big_scene_camera(b, nx, ny)
    b.set_background((0.043, 0.030, 0.094), gradient=False)  # src/main.cu:1276
    return b.compile()


SCENES = {
    "bouncing_spheres": bouncing_spheres,
    "checkered_spheres": checkered_spheres,
    "earth": earth,
    "perlin": perlin,
    "quads": quads_scene,
    "simple_light": simple_light,
    "simple_light_book": simple_light_book,
    "cornell_box": cornell_box,
    "cornell_smoke": cornell_smoke,
    "final_scene": final_scene,
    "original_scene": original_scene,
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
    with tracing.span("scene"):
        return SCENES[name](nx or d["nx"], ny or d["ny"])
