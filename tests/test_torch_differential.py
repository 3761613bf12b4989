"""Randomized scene-level differential test of the port's intersection
(after ``tests/test_differential.py``).

Random builder-gate mixes, built from one numpy seed with both packages'
DSLs: a >= 192-row (radius, material)-uniform sphere tail beside a hollow
(negative-radius) shell (so ``sph_pos_r`` is False), moving and static
spheres, quads, axis-aligned and rotated boxes, and Translate / RotateY
chains.  The port's ``closest_surface_p`` (the plain twins, on the CPU)
is held to ``art_tpu``'s on 8192 random rays at
``tests/test_torch_intersect.py``'s closest-surface bars: at most 2
hit/miss disagreements (knife edges of a last-ulp difference), and on the
agreeing hits the material equal, the point within 1e-5, the normal within
1e-4, (u, v) within 2e-6; on the misses the normals equal.  The tables are
held to ``art_tpu``'s as ``tests/test_torch_scene.py`` holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.vecmath import T_MIN
from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu.scene import builder as JB
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu.scene import textures as JX
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.scene import builder as PB
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.scene import textures as PX
from test_torch_scene import _assert_tables_equal, _jax_arrays

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
SEEDS = [11, 23, 5, 37, 41]


def _random_scene(seed: int, B, O, M, X):
    """``tests/test_differential.py``'s mix, built with the DSL modules
    ``B`` (builder), ``O`` (objects), ``M`` (materials), ``X`` (textures)."""
    rng = np.random.default_rng(seed)

    def vec(lo, hi, n=3):
        return tuple(float(x) for x in rng.uniform(lo, hi, n))

    mats = [
        M.Lambertian(vec(0.1, 0.9)),
        M.Lambertian(X.Checker(0.5, X.SolidColor(vec(0, 1)), X.SolidColor(vec(0, 1)))),
        M.Metal(vec(0.5, 1.0), float(rng.uniform(0, 1))),
        M.Dielectric(1.5),
        M.DiffuseLight(vec(1, 6)),
    ]
    b = B.SceneBuilder()
    b.add(O.Sphere((0.0, -1000.0, 0.0), 1000.0, mats[1]))  # ground
    for _ in range(int(rng.integers(4, 12))):  # static spheres
        b.add(O.Sphere(vec(-8, 8), float(rng.uniform(0.3, 1.5)),
                       mats[int(rng.integers(len(mats)))]))
    for _ in range(int(rng.integers(2, 5))):  # moving spheres
        c = vec(-8, 8)
        b.add(O.Sphere(c, float(rng.uniform(0.2, 0.8)), mats[int(rng.integers(len(mats)))],
                       center2=tuple(c[i] + rng.uniform(-0.5, 0.5) for i in range(3))))
    # the hollow shell: a negative radius turns the builder's pos_r gate off
    b.add(O.Sphere((3.0, 1.0, 3.0), 1.0, M.Dielectric(1.5)))
    b.add(O.Sphere((3.0, 1.0, 3.0), -0.9, M.Dielectric(1.5)))
    for _ in range(200):  # the (radius, material)-uniform tail
        b.add(O.Sphere(vec(-30, 30), 0.5, mats[0]))
    for _ in range(int(rng.integers(2, 5))):
        b.add(O.Quad(vec(-8, 8), vec(-3, 3), vec(-3, 3), mats[int(rng.integers(len(mats)))]))
    for _ in range(2):  # axis-aligned boxes
        a = np.array(vec(-8, 8))
        b.add(O.Box(tuple(a), tuple(a + rng.uniform(0.5, 3.0, 3)),
                    mats[int(rng.integers(len(mats)))]))
    for _ in range(2):  # rotated, translated boxes
        a = np.array(vec(-8, 8))
        box = O.Box(tuple(a), tuple(a + rng.uniform(0.5, 3.0, 3)),
                    mats[int(rng.integers(len(mats)))])
        b.add(O.Translate(O.RotateY(box, float(rng.uniform(-80, 80))), vec(-2, 2)))
    b.set_camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0), vfov_degrees=30.0,
                 aspect=1.0)
    return b.compile()


def _rays(seed: int):
    rng = np.random.default_rng(seed + 1000)
    o = ((rng.uniform(0.0, 1.0, (3, R)) - 0.5) * 24.0).astype(np.float32)
    o[1] += 4.0
    d = rng.standard_normal((3, R)).astype(np.float32)
    tm = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return o, d, tm


@pytest.mark.parametrize("seed", SEEDS)
def test_random_mix_matches_art_tpu(seed):
    jscene = _random_scene(seed, JB, JO, JM, JX)
    scene = _random_scene(seed, PB, PO, PM, PX)
    tables = scene.tables
    want_tables, _ = _jax_arrays(jscene)
    _assert_tables_equal(tables, want_tables)
    # the mix reaches the builder's gates
    assert tables.sph_n_tail >= 192 and not tables.sph_pos_r
    assert tables.has_moving and tables.has_rotated_boxes
    assert tables.n_boxes >= 4 and tables.n_quads >= 2

    o, d, tm = _rays(seed)
    want = jax_closest(jscene.tables, tuple(map(jnp.asarray, o)),
                       tuple(map(jnp.asarray, d)), jnp.asarray(tm), T_MIN)
    got = closest_surface_p(tables, tuple(torch.from_numpy(x.copy()) for x in o),
                            tuple(torch.from_numpy(x.copy()) for x in d),
                            torch.from_numpy(tm), T_MIN)
    whit = np.asarray(want.hit)
    agree = whit == got.hit.numpy()
    assert np.sum(~agree) <= 2, np.sum(~agree)
    assert whit.any() and (~whit).any()
    mask = agree & whit
    np.testing.assert_array_equal(got.mat.numpy()[mask], np.asarray(want.mat)[mask])
    for c in range(3):
        np.testing.assert_allclose(got.p[c].numpy()[mask], np.asarray(want.p[c])[mask],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.normal[c].numpy()[mask],
                                   np.asarray(want.normal[c])[mask], atol=1e-4)
        miss = agree & ~whit
        np.testing.assert_array_equal(got.normal[c].numpy()[miss],
                                      np.asarray(want.normal[c])[miss])
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[mask],
                                   np.asarray(getattr(want, k))[mask], atol=2e-6)
