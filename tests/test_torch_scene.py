"""art_tpu_torch's scene layer against art_tpu's: the compiled tables and the
camera of both slice scenes, ``tables_from_numpy`` (how tests carry
art_tpu's tables into the port), and the cuRAND XORWOW stream.

Tolerance: float tables and camera 1e-6 (both build in float32 from the same
float64 host values, so they agree exactly in practice); integer tables and
static metadata exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from art_tpu.core.xorwow import XorwowState as JaxXorwow
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.xorwow import XorwowState
from art_tpu_torch.models import SCENES, build_scene
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as O
from art_tpu_torch.scene import textures as X
from art_tpu_torch.scene.builder import SceneBuilder, tables_from_numpy
from art_tpu_torch.scene.materials import Lambertian
from art_tpu_torch.scene.tables import SceneTables

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

SLICE_SCENES = ["bouncing_spheres", "three_spheres"]
ARRAY_FIELDS = [f.name for f in dataclasses.fields(SceneTables)
                if f.type == "torch.Tensor" and f.name != "sph_rows"]


def _jax_arrays(scene):
    t = scene.tables
    arrays = {k: np.asarray(getattr(t, k)) for k in ARRAY_FIELDS}
    arrays.update(n_spheres=t.n_spheres, has_moving=t.has_moving,
                  tex_types_present=t.tex_types_present)
    cam = {f.name: np.asarray(getattr(scene.camera, f.name))
           for f in dataclasses.fields(scene.camera)}
    return arrays, cam


def _assert_tables_equal(port: SceneTables, want: dict):
    for k in ARRAY_FIELDS:
        got = getattr(port, k).numpy()
        assert got.shape == want[k].shape, k
        if np.issubdtype(want[k].dtype, np.integer):
            np.testing.assert_array_equal(got, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert port.n_spheres == want["n_spheres"]
    assert port.has_moving == want["has_moving"]
    assert port.tex_types_present == tuple(want["tex_types_present"])


@pytest.mark.parametrize("name", SLICE_SCENES)
def test_builder_matches_art_tpu(name):
    nx, ny = 96, 48
    want, cam = _jax_arrays(jax_build_scene(name, nx, ny))
    scene = build_scene(name, nx, ny)
    _assert_tables_equal(scene.tables, want)
    for k, v in cam.items():
        np.testing.assert_allclose(np.asarray(getattr(scene.camera, k)), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    js = jax_build_scene(name, nx, ny)
    assert scene.background == js.background
    assert scene.gradient_bg == js.gradient_bg


@pytest.mark.parametrize("name", SLICE_SCENES)
def test_tables_from_numpy_round_trip(name):
    arrays, cam = _jax_arrays(jax_build_scene(name, 64, 32))
    tables, camera = tables_from_numpy(arrays, cam)
    _assert_tables_equal(tables, arrays)
    built = build_scene(name, 64, 32)
    np.testing.assert_array_equal(tables.sph_rows.numpy(), built.tables.sph_rows.numpy())
    for k, v in cam.items():
        np.testing.assert_array_equal(np.asarray(getattr(camera, k)), v)


def test_sphere_rows_layout():
    t = build_scene("three_spheres", 32, 16).tables
    rows = t.sph_rows.numpy()
    assert rows.shape == (4, 10)
    np.testing.assert_array_equal(rows[:, 0:3], t.sph_center.numpy())
    np.testing.assert_array_equal(rows[:, 6], t.sph_radius.numpy())
    np.testing.assert_array_equal(rows[:, 7], t.sph_mat.numpy().astype(np.float32))
    r = t.sph_radius.numpy()
    np.testing.assert_array_equal(rows[:, 8], r * r)


def test_bouncing_spheres_counts():
    t = build_scene("bouncing_spheres", 64, 32).tables
    assert t.n_spheres == 488
    assert t.mat_packed.shape[0] == 82
    assert t.has_moving
    assert t.tex_types_present == (0, 1)


def test_xorwow_stream_matches_art_tpu():
    a, b = XorwowState(1984), JaxXorwow(1984)
    got = [a.uniform() for _ in range(2000)]
    want = [b.uniform() for _ in range(2000)]
    assert got == want


@pytest.mark.parametrize("name", sorted(set(SCENES) - set(SLICE_SCENES)))
def test_later_slice_scenes_raise(name):
    with pytest.raises(NotImplementedError, match="slice"):
        build_scene(name, 32, 16)


@pytest.mark.parametrize("obj", [
    O.Quad((0, 0, 0), (1, 0, 0), (0, 1, 0), Lambertian((0.5, 0.5, 0.5))),
    O.Sphere((0, 0, 0), 1.0, Lambertian(X.NoiseTexture(4.0))),
    O.Sphere((0, 0, 0), 1.0, Lambertian(X.ImageTexture("earthmap.jpg"))),
])
def test_later_slice_objects_raise_in_builder(obj):
    b = SceneBuilder().add(obj)
    b.set_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0)
    with pytest.raises(NotImplementedError, match="slice 1"):
        b.compile()


def test_tables_move_between_devices():
    t = build_scene("three_spheres", 32, 16).tables
    t2 = t.to(torch.device("cpu"))
    assert t2.sph_rows.device.type == "cpu"
    assert t2.n_spheres == t.n_spheres


def _transformed(b_mod, O, M):
    """Spheres under the DSL's transform and override wrappers."""
    glass, red = M.Dielectric(1.5), M.Lambertian((0.9, 0.1, 0.1))
    b = b_mod.SceneBuilder().add(
        O.Translate(O.RotateY(O.Sphere((1.0, 0.5, 0.0), 0.5, red,
                                       center2=(1.0, 0.8, 0.2)), 30.0), (0.0, 0.0, -2.0)),
        O.WithMaterial(O.Group(O.Sphere((0, 0, 0), 1.0, red),
                               O.Sphere((0, 0, 0), -0.9, red)), glass),
    )
    b.set_camera(lookfrom=(0, 1, 5), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=2.0, time0=0.0, time1=1.0)
    return b.compile()


def test_transform_wrappers_match_art_tpu():
    want, _ = _jax_arrays(_transformed(jax_builder, JO, JM))
    _assert_tables_equal(_transformed(port_builder, O, PM).tables, want)
