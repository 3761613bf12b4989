"""The port's plain sphere kernel (K2, ops/intersect_kernels.py) against
art_tpu: the jnp reference (``sphere_candidates_p`` + ``sphere_attributes_p``)
and the Pallas kernel ``sphere_hit_attrs_planar`` in interpret mode, at
R = 8192 rays from a numpy seed on three_spheres and on a 64-sphere scene
with moving spheres and hollow (negative-radius) shells.

Tolerances: at most 2 hit/miss or winner disagreements per 8192 rays —
knife edges where a last-ulp difference between the frameworks' float
programs flips a tangent or a near-tie; on agreeing
rays t to rtol 1e-5 and normals to 1e-4 (a normal is (p - c) / r, so a
1-ulp change of t moves it by t * |d| * ulp / r).  Against the
interpret-mode Pallas kernel t also gets atol 5e-5: XLA compiles that
kernel body as one fused program with its own float contraction, and for
an origin next to a surface the near root -b - sqrt(b*b - a*c) cancels, so
its error is absolute (about ulp(b*b) / a), not relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu.ops.intersect import sphere_attributes_p as jax_attrs
from art_tpu.ops.intersect import sphere_candidates_p as jax_candidates
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene as port_build_scene
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.ops.intersect_kernels import sphere_hit_attrs, sphere_hit_attrs_plain
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192


def _moving_scene(builder_mod, O, M):
    """64 spheres from a numpy seed: a third moving, some hollow shells."""
    rng = np.random.default_rng(64)
    mats = [M.Lambertian((0.5, 0.2, 0.1)), M.Metal((0.7, 0.6, 0.5), 0.1),
            M.Dielectric(1.5)]
    b = builder_mod.SceneBuilder()
    for k in range(64):
        c = tuple(float(x) for x in rng.uniform(-3.0, 3.0, 3))
        r = float(rng.uniform(0.2, 0.8)) * (-1.0 if k % 9 == 4 else 1.0)
        c2 = (tuple(ci + float(v) for ci, v in zip(c, rng.uniform(-0.5, 0.5, 3)))
              if k % 3 == 0 else None)
        b.add(O.Sphere(c, r, mats[k % 3], center2=c2))
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


def _scenes(name):
    if name == "three_spheres":
        return jax_build_scene(name, 64, 32), port_build_scene(name, 64, 32)
    return (_moving_scene(jax_builder, JO, JM),
            _moving_scene(port_builder, PO, PM))


def _rays(seed, center):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-4.0, 4.0, (3, R)) + np.asarray(center)[:, None]).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (3, R)).astype(np.float32)
    tm = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return o, d, tm


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def _jax(o, d, tm):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)


def _compare(got, want, t_atol=0.0):
    """got/want: (t, (nx, ny, nz), mat) as numpy; misses carry t = BIG."""
    t, n, m = got
    wt, wn, wm = want
    hit, whit = t < BIG, wt < BIG
    same = (hit == whit) & (~hit | (m == wm))
    assert np.sum(~same) <= 2, np.sum(~same)
    both = same & hit
    assert both.sum() > R // 10  # the rays really hit something
    np.testing.assert_allclose(t[both], wt[both], rtol=1e-5, atol=t_atol)
    for c in range(3):
        np.testing.assert_allclose(n[c][both], wn[c][both], atol=1e-4)


def _np(res):
    t, n, m = res
    return (np.asarray(t), tuple(np.asarray(x) for x in n), np.asarray(m))


@pytest.mark.parametrize("name", ["three_spheres", "moving64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k2_matches_jnp_reference(name, seed):
    jscene, pscene = _scenes(name)
    o, d, tm = _rays(seed, (0.0, 0.0, -1.0) if name == "three_spheres" else (0, 0, 0))
    t, idx = jax_candidates(jscene.tables, *_jax(o, d, tm), T_MIN)
    n, _, _, m = jax_attrs(jscene.tables, *_jax(o, d, tm), t, idx, False)
    got = _np(sphere_hit_attrs_plain(pscene.tables, *_port(o, d, tm)))
    _compare(got, _np((t, n, m)))


@pytest.mark.parametrize("name", ["three_spheres", "moving64"])
def test_plain_k2_matches_pallas_interpret(name):
    jscene, pscene = _scenes(name)
    jt = jscene.tables
    o, d, tm = _rays(5, (0.0, 0.0, -1.0) if name == "three_spheres" else (0, 0, 0))
    t, n, _, _, m = pk.sphere_hit_attrs_planar(
        jt.sph_packed, *_jax(o, d, tm), n_moving=jt.sph_n_moving_pad,
        n_static=jt.sph_n_static, needs_uv=False, n_tail=jt.sph_n_tail,
        tail_r=jt.sph_tail_r, tail_mat=jt.sph_tail_mat, pos_r=jt.sph_pos_r,
        interpret=True)
    got = _np(sphere_hit_attrs_plain(pscene.tables, *_port(o, d, tm)))
    _compare(got, _np((t, n, m)), t_atol=5e-5)


@pytest.mark.parametrize("name", ["three_spheres", "moving64"])
def test_closest_surface_matches_art_tpu(name):
    jscene, pscene = _scenes(name)
    o, d, tm = _rays(9, (0.0, 0.0, -1.0) if name == "three_spheres" else (0, 0, 0))
    want = jax_closest(jscene.tables, *_jax(o, d, tm), T_MIN)
    got = closest_surface_p(pscene.tables, *_port(o, d, tm), T_MIN)
    agree = np.asarray(want.hit) == got.hit.numpy()
    assert np.sum(~agree) <= 2
    mask = agree & np.asarray(want.hit)
    np.testing.assert_array_equal(got.mat.numpy()[mask], np.asarray(want.mat)[mask])
    for c in range(3):
        np.testing.assert_allclose(got.p[c].numpy()[mask], np.asarray(want.p[c])[mask],
                                   rtol=1e-5, atol=1e-5)
        miss = agree & ~np.asarray(want.hit)
        np.testing.assert_array_equal(got.normal[c].numpy()[miss],
                                      np.asarray(want.normal[c])[miss])


def test_cpu_wrapper_takes_the_plain_path():
    _, pscene = _scenes("three_spheres")
    o, d, tm = _port(*_rays(3, (0.0, 0.0, -1.0)))
    a = sphere_hit_attrs(pscene.tables, o, d, tm)
    b = sphere_hit_attrs_plain(pscene.tables, o, d, tm)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_other_t_min_reaches_the_wrapper():
    """``closest_surface_p`` hands any ``t_min`` to the K2 wrapper as an
    argument (the kernel takes it at run time; chip_smoke.py holds the
    kernel to its plain twin at ``t_min`` 0.25 on the card); on CPU tensors
    the wrapper's plain path honours it: every hit lies beyond it, and rays
    starting inside a sphere's first 0.25 of travel take the far root or
    another sphere."""
    _, pscene = _scenes("three_spheres")
    o, d, tm = _port(*_rays(4, (0.0, 0.0, -1.0)))
    rec = closest_surface_p(pscene.tables, o, d, tm, 0.25)
    t, _, m = sphere_hit_attrs(pscene.tables, o, d, tm, 0.25)
    t_plain, _, _ = sphere_hit_attrs_plain(pscene.tables, o, d, tm, 0.25)
    assert torch.equal(rec.t, t) and torch.equal(t, t_plain)
    assert torch.equal(rec.mat, m)
    assert bool((rec.t[rec.hit] > 0.25).all())
    t_default, _, _ = sphere_hit_attrs(pscene.tables, o, d, tm)
    assert bool((t != t_default).any())
