"""The package surface of art_tpu_torch: ``examples/custom_scene.py``'s scene
built with the port's DSL, the lazy exports, the PPM formatter.

* The example's scene (motion blur, the hollow glass shell, the
  Group-boundary medium, the rotated box, the emissive quad, checker and
  marble) is built here with the port's DSL, as ``build(aspect)`` builds it
  with ``art_tpu``'s (the example file imports ``art_tpu`` and stays as it
  is).  Its tables and camera are held to ``art_tpu``'s at
  ``tests/test_torch_scene.py``'s tolerances, and a 24x16 @ 4 render on
  ``art_tpu``'s injected threefry stream to ``art_tpu``'s render at
  ``tests/test_torch_render.py``'s bars (>= 98% of the pixels within 1e-3,
  rays within 1e-3, equal iterations).
* ``import art_tpu_torch`` imports no submodule and not even ``torch``;
  each of the nine exported names resolves to its module's object, and
  none of them loads a kernel library.
* ``format_ppm`` (the numpy formatter) gives the Python join's text byte
  for byte, negative, > 255, NaN, infinite and past-the-table (> 65536)
  values included, clamped or not, and ``art_tpu``'s ``format_ppm`` text."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from art_tpu.core import rng as artrng
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu.render.renderer import render_scene as jax_render_scene
from art_tpu.utils.ppm import format_ppm as jax_format_ppm
from art_tpu_torch.render.integrator import n_uniform_cols
from art_tpu_torch.render.renderer import RenderConfig, render_scene
from art_tpu_torch.scene import builder as PB
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.scene import textures as PX
from art_tpu_torch.utils.ppm import format_ppm, format_ppm_plain
from test_torch_scene import _assert_tables_equal, _jax_arrays

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))

NX, NY, SPP = 24, 16, 4


def _port_example(aspect: float):
    """``examples/custom_scene.py``'s ``build(aspect)`` in the port's DSL."""
    ground = PM.Lambertian(
        PX.Checker(2.0, PX.SolidColor((0.05, 0.05, 0.08)), PX.SolidColor((0.9, 0.9, 0.9))))
    marble = PM.Lambertian(PX.NoiseTexture(2.0))
    mirror = PM.Metal((0.9, 0.9, 0.95), fuzz=0.02)
    glass_shell = PO.Group(
        PO.Sphere((0.0, 1.0, 0.0), 1.0, PM.Dielectric(1.5)),
        PO.Sphere((0.0, 1.0, 0.0), -0.9, PM.Dielectric(1.5)),
    )
    column = PO.Translate(PO.RotateY(PO.Box((-0.5, 0.0, -0.5), (0.5, 2.4, 0.5), mirror),
                                     25.0), (3.0, 0.0, -1.0))
    smoke = PO.ConstantMedium(
        PO.Group(
            PO.Box((-4.5, 0.0, -1.0), (-2.5, 1.4, 1.0), PM.Lambertian((1, 1, 1))),
            PO.Box((-3.9, 1.4, -0.4), (-3.1, 2.2, 0.4), PM.Lambertian((1, 1, 1))),
        ),
        density=0.6,
        tex_or_color=(0.75, 0.75, 0.8),
    )
    mover = PO.Sphere((-1.2, 2.6, 1.4), 0.35, marble, center2=(-0.6, 3.0, 1.4))
    light = PM.DiffuseLight((6.0, 5.6, 5.2))
    return (
        PB.SceneBuilder()
        .set_name("example_custom")
        .add(
            PO.Sphere((0.0, -1000.0, 0.0), 1000.0, ground),
            glass_shell,
            column,
            smoke,
            mover,
            PO.Quad((-2.0, 5.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), light, inward=True),
            PO.Sphere((-2.2, 0.7, 2.2), 0.7, marble),
        )
        .set_background((0.02, 0.02, 0.04))
        .set_camera(
            lookfrom=(7.5, 3.2, 7.5),
            lookat=(-0.3, 1.1, 0.0),
            vup=(0, 1, 0),
            vfov_degrees=32.0,
            aspect=aspect,
            aperture=0.08,
            focus_dist=10.5,
            time0=0.0,
            time1=1.0,
        )
        .compile()
    )


@pytest.fixture(scope="module")
def scenes():
    from custom_scene import build

    return build(NX / NY), _port_example(NX / NY)


def test_example_tables_match_art_tpu(scenes):
    jscene, scene = scenes
    want, cam = _jax_arrays(jscene)
    _assert_tables_equal(scene.tables, want)
    for k, v in cam.items():
        np.testing.assert_allclose(np.asarray(getattr(scene.camera, k)), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert scene.background == jscene.background
    assert scene.gradient_bg == jscene.gradient_bg and scene.name == jscene.name
    t = scene.tables
    # what the example exercises
    assert t.has_moving and t.has_rotated_boxes and not t.sph_pos_r
    assert t.n_quads >= 1 and t.n_boxes >= 1 and t.n_media >= 1


def test_example_render_matches_art_tpu(scenes):
    jscene, scene = scenes
    jfb, jst = jax_render_scene(jscene, JaxConfig(nx=NX, ny=NY, spp=SPP))
    master = jax.random.PRNGKey(RenderConfig().seed)
    ncols, R = n_uniform_cols(scene.tables), jst["n_slots"]

    def threefry(tile, chunk, it):
        key = artrng.fold(artrng.fold(master, tile, chunk), it)
        return np.asarray(artrng.uniform(key, (ncols, R)))

    fb, st = render_scene(scene, RenderConfig(nx=NX, ny=NY, spp=SPP), device="cpu",
                          uniforms=threefry)
    for k in ("tile_pixels", "spp_chunk", "n_slots", "spp", "iterations"):
        assert st[k] == jst[k], k
    assert abs(st["rays"] - jst["rays"]) <= 1e-3 * jst["rays"]
    close = np.abs(fb - jfb).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()
    assert np.isfinite(fb).all() and (fb >= 0).all() and fb.max() > 0


NAMES = ("SceneBuilder", "CompiledScene", "render_scene", "RenderConfig", "SCENES",
         "build_scene", "scene_defaults", "render_scene_sharded", "make_mesh")

_LAZY = """
import sys
import art_tpu_torch
loaded = sorted(m for m in sys.modules if m.startswith("art_tpu_torch.") or m == "torch")
print("loaded:", loaded)
assert loaded == [], loaded
assert sorted(art_tpu_torch.__all__) == sorted({names})
for name in {names}:
    assert getattr(art_tpu_torch, name) is not None and name in dir(art_tpu_torch)
from art_tpu_torch.ops import _build
assert _build.library.cache_info().currsize == 0  # no kernel library loaded
assert "jax" not in sys.modules and "art_tpu" not in sys.modules
try:
    art_tpu_torch.no_such_name
except AttributeError:
    print("ok")
"""


def test_lazy_exports():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _LAZY.format(names=NAMES)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_exports_are_the_modules_objects():
    import art_tpu
    import art_tpu_torch
    from art_tpu_torch import models, parallel
    from art_tpu_torch.render import renderer
    from art_tpu_torch.scene import builder

    assert set(art_tpu.__all__) <= set(art_tpu_torch.__all__)
    assert art_tpu_torch.render_scene is renderer.render_scene
    assert art_tpu_torch.RenderConfig is renderer.RenderConfig
    assert art_tpu_torch.SceneBuilder is builder.SceneBuilder
    assert art_tpu_torch.CompiledScene is builder.CompiledScene
    assert art_tpu_torch.SCENES is models.SCENES
    assert art_tpu_torch.build_scene is models.build_scene
    assert art_tpu_torch.scene_defaults is models.scene_defaults
    assert art_tpu_torch.make_mesh is parallel.make_mesh
    assert art_tpu_torch.render_scene_sharded is parallel.render_scene_sharded


def _frame(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    fb = rng.uniform(0.0, 1.0, (9, 13, 3)).astype(np.float32)
    if kind == "wide":  # emissive: negative and > 255 values
        fb = rng.uniform(-3.0, 40.0, (9, 13, 3)).astype(np.float32)
    elif kind == "nan":
        fb[2, 3, 1] = np.nan
        fb[0, 0] = [np.inf, -np.inf, -0.5]
    elif kind == "bright":  # past the formatter's table, beside small values
        fb[1::2] *= 1e4
        fb[0, :4] = [[-400.0, 2.0, 0.1], [300.0, -1e5, 3e3], [1e9, 0.0, -1e9], [0.5, 0.5, 0.5]]
    elif kind == "empty":
        fb = np.zeros((0, 4, 3), np.float32)
    return fb


@pytest.mark.parametrize("kind", ["unit", "wide", "nan", "bright", "empty"])
@pytest.mark.parametrize("clamp", [False, True])
def test_ppm_formatter_is_the_python_join(kind, clamp):
    fb = _frame(kind)
    with np.errstate(invalid="ignore"):
        text = format_ppm(fb, clamp=clamp)
        assert text == format_ppm_plain(fb, clamp=clamp)
        assert text == jax_format_ppm(fb, clamp=clamp)
