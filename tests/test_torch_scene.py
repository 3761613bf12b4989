"""art_tpu_torch's scene layer against art_tpu's: the compiled tables, the
image atlas and the camera of every scene of the registry (cornell_box in
both wall variants, and a hand-built scene of translated, unrotated boxes),
the media tables of medium objects and scenes, the baked
shade constants with their special leaves (noise; earth's image;
simple_light's felt and uv-offset image), the short path's gate and constants
(``sp_consts``), the kernels' row tables, ``tables_from_numpy`` (how tests
carry art_tpu's tables into the port), and the cuRAND XORWOW stream.

Tolerance: float tables and camera 1e-6 (both build in float32 from the same
float64 host values, so they agree exactly in practice); integer tables,
the atlas, the kernel row tables and static metadata exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from art_tpu.core.xorwow import XorwowState as JaxXorwow
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.models.scenes import cornell_box as jax_cornell_box
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.xorwow import XorwowState
from art_tpu_torch.models import SCENES, build_scene
from art_tpu_torch.models.scenes import cornell_box
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as O
from art_tpu_torch.scene import textures as X
from art_tpu_torch.scene.builder import SceneBuilder, tables_from_numpy
from art_tpu_torch.scene.materials import Lambertian
from art_tpu_torch.scene.tables import SceneTables

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

SLICE_SCENES = ["bouncing_spheres", "three_spheres", "cornell_box", "quads",
                "checkered_spheres", "perlin", "simple_light_book", "earth",
                "simple_light"]
# art_tpu's fields (the kernels' row tables are the port's own)
ARRAY_FIELDS = [f.name for f in dataclasses.fields(SceneTables)
                if f.type == "torch.Tensor" and not f.name.endswith("_rows")]
META = ("n_spheres", "n_quads", "n_boxes", "has_moving", "has_rotated_boxes",
        "shade_consts", "sp_consts")
SP_ROWS = ("sp_sph_rows", "sp_quad_rows", "sp_mat_rows")
ATLAS = ("data", "heights", "widths", "hmax", "wmax")


def _jax_arrays(scene):
    t = scene.tables
    arrays = {k: np.asarray(getattr(t, k)) for k in ARRAY_FIELDS}
    arrays.update({k: getattr(t, k) for k in META},
                  tex_types_present=t.tex_types_present,
                  atlas={k: np.asarray(getattr(t.atlas, k)) for k in ATLAS})
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
    for k in META:
        assert getattr(port, k) == want[k], k
    assert port.tex_types_present == tuple(want["tex_types_present"])
    assert port.atlas.data.dtype == torch.int32
    for k in ATLAS:
        np.testing.assert_array_equal(np.asarray(getattr(port.atlas, k)),
                                      want["atlas"][k].astype(np.int64), err_msg=k)


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
    for k in SP_ROWS:
        a, b = getattr(tables, k), getattr(built.tables, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
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


MEDIA_SCENES = ["cornell_smoke", "final_scene", "original_scene"]
MEDIA_META = ("n_media", "med_kinds", "gb_sph_meds", "gb_quad_meds", "gb_box_meds")


def test_every_registry_scene_is_ported():
    assert sorted(SCENES) == sorted(SLICE_SCENES + MEDIA_SCENES)


@pytest.mark.parametrize("name", MEDIA_SCENES)
def test_media_scenes_match_art_tpu(name):
    """The scenes with constant media: tables (media, grid and tail
    included), camera to 1e-6 and background as art_tpu's."""
    nx, ny = 48, 48
    js = jax_build_scene(name, nx, ny)
    want, cam = _jax_arrays(js)
    scene = build_scene(name, nx, ny)
    _assert_tables_equal(scene.tables, want)
    for k in MEDIA_META + ("box_grid_kx", "box_grid_cells", "sph_n_tail", "sph_tail_box"):
        assert getattr(scene.tables, k) == getattr(js.tables, k), k
    for k, v in cam.items():
        np.testing.assert_allclose(np.asarray(getattr(scene.camera, k)), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert scene.background == js.background and scene.gradient_bg == js.gradient_bg
    assert scene.tables.n_media == (1 if name == "original_scene" else 2)


def _medium_objects(O, M, X):
    """A medium alone, around a box, under a transform with a texture, and
    beside an image-textured sphere — in either package's DSL."""
    return [
        O.ConstantMedium(O.Sphere((0, 0, 0), 1.0, M.Lambertian((0.5, 0.5, 0.5))), 0.5,
                         (1.0, 1.0, 1.0)),
        O.ConstantMedium(O.Box((0, 0, 0), (1, 1, 1), M.Lambertian((0.5, 0.5, 0.5))), 0.01,
                         (0.2, 0.2, 0.2)),
        O.Translate(O.ConstantMedium(O.Sphere((0, 0, 0), 1.0, M.Lambertian((1, 1, 1))), 0.2,
                                     X.NoiseTexture(4.0)), (1.0, 0.0, 0.0)),
        O.Group(O.Sphere((0, 0, 0), 1.0, M.Lambertian(X.ImageTexture("earthmap.jpg"))),
                O.ConstantMedium(O.Sphere((0, 0, 0), 2.0, M.Lambertian((1, 1, 1))), 0.1,
                                 (1.0, 1.0, 1.0))),
    ]


@pytest.mark.parametrize("k", range(4))
def test_medium_objects_compile_as_art_tpu(k):
    """Media (M8) compile: their media tables, phase materials and textures
    equal art_tpu's."""
    from art_tpu.scene import textures as JX

    scenes = []
    for b_mod, objs in ((jax_builder, _medium_objects(JO, JM, JX)),
                        (port_builder, _medium_objects(O, PM, X))):
        b = b_mod.SceneBuilder().add(objs[k])
        b.set_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov_degrees=40.0, aspect=1.0)
        scenes.append(b.compile())
    want, _ = _jax_arrays(scenes[0])
    t = scenes[1].tables
    _assert_tables_equal(t, want)
    for name in MEDIA_META:
        assert getattr(t, name) == getattr(scenes[0].tables, name), name
    assert t.n_media == 1 and t.mat_type.numpy()[t.med_mat.numpy()[0]] == 4  # isotropic


@pytest.mark.parametrize("tex,kind", [
    (X.FeltTexture(), "felt"), (X.ImageTexture("earthmap.jpg"), "image"),
    (X.NoodleTexture(), "noodle"), (X.UVOffset(X.ImageTexture("8ball.jpg"), 0.25, 0.1), "image"),
])
def test_m10_textures_compile(tex, kind):
    """Felt, image, noodle and uv_offset textures compile and bake as one
    special leaf each; only the image kinds fill the atlas."""
    b = SceneBuilder().add(O.Sphere((0, 0, 0), 1.0, Lambertian(tex)))
    b.set_camera(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0)
    t = b.compile().tables
    (special,) = t.shade_consts[1]
    assert special[:2] == (0, kind) and t.sp_consts is None
    assert (t.atlas.data.shape[0] > 1) == (kind == "image")


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


def _boxes(b_mod, O, M, checker_tex):
    """Translated, unrotated boxes (their offsets fold into the kernel rows),
    a quad, a sphere and a checker of solids: 5 materials, a baked scene."""
    white = M.Lambertian((0.73, 0.73, 0.73))
    b = b_mod.SceneBuilder().add(
        O.Quad((-4, 0, -4), (8, 0, 0), (0, 0, 8), M.Lambertian(checker_tex), inward=True),
        O.Translate(O.Box((0, 0, 0), (1.25, 0.75, 1.5), white), (-2.3, 0.0, -0.7)),
        O.Translate(O.Box((0, 0, 0), (0.8, 1.9, 0.6), M.Metal((0.8, 0.7, 0.6), 0.2)),
                    (0.4, 0.1, 0.35)),
        O.Box((1.5, 0, -2.5), (2.5, 1.0, -1.5), M.DiffuseLight((4.0, 4.0, 4.0))),
        O.Sphere((0.0, 2.5, 0.0), 0.6, M.Dielectric(1.5)),
    )
    b.set_camera(lookfrom=(0, 3, 8), lookat=(0, 0.5, 0), vup=(0, 1, 0),
                 vfov_degrees=45.0, aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


def unrotated_scenes():
    """The hand-built unrotated-box scene in both packages."""
    from art_tpu.scene import textures as JX

    jc = JX.Checker(0.5, JX.SolidColor((0.2, 0.3, 0.1)), JX.SolidColor((0.9, 0.9, 0.9)))
    pc = X.Checker(0.5, X.SolidColor((0.2, 0.3, 0.1)), X.SolidColor((0.9, 0.9, 0.9)))
    return _boxes(jax_builder, JO, JM, jc), _boxes(port_builder, O, PM, pc)


def _scene_pair(name):
    if name == "cornell_legacy":
        return jax_cornell_box(64, 64, legacy_walls=True), cornell_box(64, 64, True)
    if name == "unrotated_boxes":
        return unrotated_scenes()
    return jax_build_scene(name, 64, 64), build_scene(name, 64, 64)


@pytest.mark.parametrize("name", ["cornell_legacy", "unrotated_boxes"])
def test_quad_box_scenes_match_art_tpu(name):
    jscene, scene = _scene_pair(name)
    want, _ = _jax_arrays(jscene)
    _assert_tables_equal(scene.tables, want)
    assert scene.tables.has_rotated_boxes == (name != "unrotated_boxes")


@pytest.mark.parametrize("name", ["cornell_box", "cornell_legacy", "unrotated_boxes",
                                  "quads"])
def test_kernel_rows_equal_art_tpu_packed_tables(name):
    """quad_rows / box_rows are art_tpu's pack_quads / pack_boxes without
    the padding rows — offsets folded into min/max when no box rotates."""
    jscene, scene = _scene_pair(name)
    t = scene.tables
    np.testing.assert_array_equal(t.quad_rows.numpy(),
                                  np.asarray(jscene.tables.quad_packed)[:t.n_quads])
    np.testing.assert_array_equal(t.box_rows.numpy(),
                                  np.asarray(jscene.tables.box_packed)[:t.n_boxes])


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "cornell_legacy",
                                  "unrotated_boxes", "bouncing_spheres", "perlin",
                                  "simple_light_book", "earth", "simple_light"])
def test_shade_consts_match_art_tpu(name):
    """The baked gate and constants: ≤ 24 materials with solid,
    checker-of-solids or special textures bake (noise, image, felt; the
    pool ball's uv offset folds into its image leaf); bouncing_spheres' 82
    do not."""
    jscene, scene = _scene_pair(name)
    assert scene.tables.shade_consts == jscene.tables.shade_consts
    assert (scene.tables.shade_rows is None) == (name == "bouncing_spheres")
    if name in ("perlin", "simple_light_book"):
        assert scene.tables.shade_consts[1] == ((0, "noise", 4.0),)
        rows = scene.tables.shade_rows.numpy()
        assert rows[0, 6] == 2.0 and not rows[0, 7:].any()
    if name == "earth":
        assert scene.tables.shade_consts[1] == ((0, "image", 0, 0.0, 0.0),)
    if name == "simple_light":
        felt, ball = scene.tables.shade_consts[1]
        assert felt[:2] == (0, "felt") and ball == (1, "image", 0, float(np.float32(1 / 6)),
                                                    0.0)


def _light_checker(b_mod, O, M, X):
    """A checker ground, a fuzzy metal ball and a quad light: the light and
    checker case of art_tpu's tests/test_sp_kernel.py:41-58."""
    check = X.Checker(0.8, X.SolidColor((0.9, 0.9, 0.9)), X.SolidColor((0.1, 0.2, 0.3)))
    b = b_mod.SceneBuilder().add(
        O.Sphere((0, -100.5, -1), 100.0, M.Lambertian(check)),
        O.Sphere((0, 0, -1), 0.5, M.Metal((0.8, 0.6, 0.2), 0.3)),
        O.Quad((-1, 2, -2), (2, 0, 0), (0, 0, 2), M.DiffuseLight((4, 4, 4))),
    )
    b.set_camera(lookfrom=(0, 0, 2), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_degrees=60.0, aspect=2.0, aperture=0.0, focus_dist=3.0)
    b.set_background((0, 0, 0), gradient=False)
    return b.compile()


def light_checker_scenes():
    """The light-and-checker scene in both packages."""
    from art_tpu.scene import textures as JX

    return _light_checker(jax_builder, JO, JM, JX), _light_checker(port_builder, O, PM, X)


SP_SCENES = ["quads", "checkered_spheres", "perlin", "simple_light_book", "light_checker",
             "three_spheres"]


@pytest.mark.parametrize("name", SP_SCENES + ["cornell_box", "bouncing_spheres",
                                              "unrotated_boxes", "earth", "simple_light"])
def test_sp_consts_match_art_tpu(name):
    """The short path's gate and its float32 constants: the small static
    scenes pass (three_spheres too: its dielectric keeps it staged only at
    the integrator), cornell_box (boxes), bouncing_spheres (488 spheres,
    moving), the box scene, earth and simple_light (image and felt
    textures) do not."""
    jscene, scene = light_checker_scenes() if name == "light_checker" else _scene_pair(name)
    assert scene.tables.sp_consts == jscene.tables.sp_consts
    assert (scene.tables.sp_consts is None) == (name not in SP_SCENES)


@pytest.mark.parametrize("name", SP_SCENES)
def test_sp_rows_layout(name):
    """sp_sph_rows [c(3) r inv_r mat] with inv_r the float32 of the float64
    1 / r (art_tpu's kernel bakes it so); sp_quad_rows art_tpu's pack_quads
    row plus the material; sp_mat_rows the 14-value material tuple."""
    jscene, scene = light_checker_scenes() if name == "light_checker" else _scene_pair(name)
    spheres, quads, mats = scene.tables.sp_consts
    sph = scene.tables.sp_sph_rows.numpy()
    assert sph.shape == (len(spheres), 6) and sph.dtype == np.float32
    for row, (cx, cy, cz, r, m) in zip(sph, spheres):
        np.testing.assert_array_equal(row[:4], (cx, cy, cz, r))
        assert row[4] == np.float32(1.0 / r) and row[5] == m
    qr = scene.tables.sp_quad_rows.numpy()
    assert qr.shape == (len(quads), 13)
    np.testing.assert_array_equal(qr[:, :12], np.asarray(jscene.tables.quad_packed)[:len(quads)])
    np.testing.assert_array_equal(qr[:, 12], [q[12] for q in quads])
    np.testing.assert_array_equal(scene.tables.sp_mat_rows.numpy(),
                                  np.asarray(mats, np.float32).reshape(-1, 14))


def test_shade_rows_layout():
    """One (16,) row per material: [mtype fuzz ref_idx malb(3) kind isc
    rgb_or_even(3) odd(3) 0 0], art_tpu's blend defaults where a family does
    not read a value."""
    _, scene = unrotated_scenes()
    rows = scene.tables.shade_rows.numpy()
    mats = scene.tables.shade_consts[0]
    assert rows.shape == (len(mats), 16) and rows.dtype == np.float32
    for row, (mtype, fuzz, ref_idx, malb, kind, data) in zip(rows, mats):
        assert row[0] == mtype and row[6] == kind
        assert row[1] == (fuzz if mtype == 1 else 0.0)
        assert row[2] == (ref_idx if mtype == 2 else 1.0)
        np.testing.assert_array_equal(row[3:6], malb if mtype == 1 else (0, 0, 0))
        if kind == 1:
            assert row[7] == data[0]
            np.testing.assert_array_equal(row[8:14], (*data[1], *data[2]))
        elif mtype in (0, 3, 4):
            np.testing.assert_array_equal(row[8:11], data)
    assert {int(r[6]) for r in rows} == {0, 1}


@pytest.mark.parametrize("name", ["cornell_box", "unrotated_boxes"])
def test_tables_from_numpy_carries_quads_and_boxes(name):
    jscene, scene = _scene_pair(name)
    arrays, cam = _jax_arrays(jscene)
    tables, _ = tables_from_numpy(arrays, cam)
    _assert_tables_equal(tables, arrays)
    for k in ("sph_rows", "quad_rows", "box_rows", "shade_rows"):
        np.testing.assert_array_equal(getattr(tables, k).numpy(),
                                      getattr(scene.tables, k).numpy(), err_msg=k)


def test_tables_from_numpy_carries_media():
    """cornell_smoke's two box media (kind 1) through tables_from_numpy."""
    js = jax_build_scene("cornell_smoke", 32, 32)
    arrays, cam = _jax_arrays(js)
    arrays.update({k: getattr(js.tables, k) for k in MEDIA_META})
    tables, _ = tables_from_numpy(arrays, cam)
    _assert_tables_equal(tables, arrays)
    assert tables.n_media == 2 and tables.med_kinds == (1, 1)
    built = build_scene("cornell_smoke", 32, 32).tables
    for k in ("med_min", "med_max", "med_cos", "med_sin", "med_off", "med_neg_inv_density",
              "med_mat"):
        assert torch.equal(getattr(tables, k), getattr(built, k)), k
