"""Constant media (M8) against art_tpu: ``apply_media_p`` and its kind-2
boundary traversal (``_gb_first_hit``) on the same rays, uniforms and
surface records from a numpy seed, after ``tests/test_media_general.py``;
and cornell_smoke rendered whole.

Media kinds: an analytic sphere (kind 0), a rotated, translated box (kind
1) and general boundaries (kind 2): a Group, a bare Quad, a union of two
boxes, a moving sphere, and two media at once.  The surface records carry
hits at random t, so the surface clips the interval on some lanes.  The
hit mask, material, normal and (u, v) are equal; t to 1e-6 relative.  The
scatter decision ``hit_distance <= distance_inside`` may flip on a lane
where the two sides of it lie within 1e-5 relative of each other: XLA's CPU
build and ATen round ``log`` and ``sqrt`` differently in the last ulp.
Such lanes are measured in float64 here and bounded at 0.1% of the lanes
(none was seen at R = 8192).

cornell_smoke at 32x32 @ 4 against art_tpu's render on its own uniforms
(``n_uniform_cols`` = 11 columns for two media): equal iterations, rays
within 1% and >= 98% of the pixels within 1e-3, the budgets of cornell_box
in ``tests/test_torch_render.py`` (measured: equal rays, every pixel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops.intersect import HitRecordP as JaxHit
from art_tpu.ops.intersect import apply_media_p as jax_apply_media
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu.render.renderer import render_scene as jax_render_scene
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops.intersect import (
    HitRecordP,
    _box_interval,
    _gb_first_hit,
    apply_media_p,
)
from art_tpu_torch.render.integrator import n_uniform_cols
from art_tpu_torch.render.renderer import RenderConfig, render_scene
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from test_torch_render import _threefry

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192


def _media(O, M, case):
    mat = M.Lambertian((0.5, 0.5, 0.5))
    box = O.Box((-3, -2, -4), (2, 3, 1), mat)
    return {
        "sphere": [O.ConstantMedium(O.Sphere((0.5, -1.0, 2.0), 3.0, mat), 0.5, (1, 1, 1))],
        "box": [O.ConstantMedium(O.Translate(O.RotateY(O.Box((-1, -1, -1), (1, 1, 1), mat),
                                                       30.0), (2, 0, -1)), 0.4, (1, 1, 1))],
        "group": [O.ConstantMedium(O.Group(box, O.Sphere((4, 0, 0), 1.5, mat)), 0.35,
                                   (0.2, 0.4, 0.9))],
        "quad": [O.ConstantMedium(O.Quad((-1, -1, 0), (2, 0, 0), (0, 2, 0), mat), 5.0,
                                  (1, 1, 1))],
        "union": [O.ConstantMedium(O.Group(O.Box((-1, -1, 0), (1, 1, 2), mat),
                                           O.Box((-1, -1, 5), (1, 1, 7), mat)), 0.8,
                                   (1, 1, 1))],
        "moving_sphere": [O.ConstantMedium(O.Sphere((0, 0, 0), 3.0, mat,
                                                    center2=(4, 0, 0)), 0.6, (1, 1, 1))],
        "two_media": [O.ConstantMedium(box, 0.05, (1, 1, 1)),
                      O.ConstantMedium(O.Sphere((0, 0, 0), 8.0, mat), 0.02, (0.5, 0.5, 0.5))],
    }[case]


def _scene(B, O, M, case):
    b = B.SceneBuilder().add(*_media(O, M, case))
    b.set_camera(lookfrom=(0, 0, 10), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.compile()


KINDS = {"sphere": (0,), "box": (1,), "group": (2,), "quad": (2,), "union": (2,),
         "moving_sphere": (2,), "two_media": (1, 0)}


def _inputs(seed, n_media):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (3, R)).astype(np.float32)
    d = rng.uniform(-1, 1, (3, R)).astype(np.float32)
    tm = rng.uniform(0, 1, R).astype(np.float32)
    u = rng.random((n_media, R), dtype=np.float32)
    hit = rng.random(R) < 0.5  # a surface clips the interval on these lanes
    t = np.where(hit, rng.uniform(1.0, 30.0, R), BIG).astype(np.float32)
    p = rng.uniform(-5, 5, (3, R)).astype(np.float32)
    n = rng.uniform(-1, 1, (3, R)).astype(np.float32)
    uv = rng.random((2, R), dtype=np.float32)
    mat = rng.integers(0, 3, R).astype(np.int32)
    return o, d, tm, u, (hit, t, p, n, uv, mat)


def _margin(tables, o, d, tm, u, surf_t):
    """Per lane, the smallest |hit_distance - distance_inside| /
    distance_inside over the media whose interval is open, in float64."""
    o, d = (tuple(torch.from_numpy(c).double() for c in x) for x in (o, d))
    tm, surf_t = torch.from_numpy(tm).double(), torch.from_numpy(surf_t).double()
    ray_len = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    margin = torch.full_like(ray_len, np.inf)
    for m, kind in enumerate(tables.med_kinds):
        if kind == 0:
            c, r = tables.med_center[m].double(), float(tables.med_radius[m])
            oc = tuple(o[k] - c[k] for k in range(3))
            a = sum(dk * dk for dk in d)
            b = sum(ock * dk for ock, dk in zip(oc, d))
            disc = b * b - a * (sum(x * x for x in oc) - r * r)
            s = torch.sqrt(disc.clamp_min(0.0))
            entry, exit_, ok = (-b - s) / a, (-b + s) / a, disc > 0
        elif kind == 1:
            entry, exit_ = _box_interval(o, d, tables.med_min[m].double(),
                                         tables.med_max[m].double(), float(tables.med_cos[m]),
                                         float(tables.med_sin[m]), tables.med_off[m].double())
            ok = entry < exit_
        else:
            entry, h1 = _gb_first_hit(tables, m, o, d, tm, torch.full_like(tm, -BIG))
            exit_, h2 = _gb_first_hit(tables, m, o, d, tm, entry + 1e-4)
            ok = h1 & h2
        rec1, rec2 = entry.clamp_min(T_MIN), torch.minimum(exit_, surf_t)
        inside = (rec2 - rec1) * ray_len
        hd = float(tables.med_neg_inv_density[m]) * torch.log(
            torch.from_numpy(np.maximum(u[m], 1e-6)).double())
        rel = (hd - inside).abs() / inside.abs().clamp_min(1e-12)
        margin = torch.where(ok & (rec1 < rec2), torch.minimum(margin, rel), margin)
    return margin.numpy()


@pytest.mark.parametrize("case", sorted(KINDS))
def test_apply_media_matches_art_tpu(case):
    jt = _scene(jax_builder, JO, JM, case).tables
    pt = _scene(port_builder, PO, PM, case).tables
    assert pt.med_kinds == jt.med_kinds == KINDS[case]
    for k in ("gb_sph_meds", "gb_quad_meds", "gb_box_meds"):
        assert getattr(pt, k) == getattr(jt, k), k
    o, d, tm, u, (hit, t, p, n, uv, mat) = _inputs(7, pt.n_media)
    J = jnp.asarray
    want = jax_apply_media(jt, tuple(map(J, o)), tuple(map(J, d)), T_MIN,
                           JaxHit(hit=J(hit), t=J(t), p=tuple(map(J, p)), normal=tuple(map(J, n)),
                                  u=J(uv[0]), v=J(uv[1]), mat=J(mat)), J(u), time=J(tm))

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    surf = HitRecordP(hit=T(hit), t=T(t), p=tuple(map(T, p)), normal=tuple(map(T, n)),
                      u=T(uv[0]), v=T(uv[1]), mat=T(mat))
    got = apply_media_p(pt, tuple(map(T, o)), tuple(map(T, d)), T_MIN, surf, T(u), time=T(tm))
    w_t, g_t = np.asarray(want.t), got.t.numpy()
    scattered = g_t != t
    # lanes whose scatter decision differs: knife edges only, at most 0.1%
    flip = scattered != (w_t != t)
    assert flip.sum() <= R // 1000, flip.sum()
    assert (_margin(pt, o, d, tm, u, t)[flip] <= 1e-5).all()
    same = ~flip
    np.testing.assert_array_equal(got.hit.numpy()[same], np.asarray(want.hit)[same])
    np.testing.assert_array_equal(got.mat.numpy()[same], np.asarray(want.mat)[same])
    np.testing.assert_allclose(g_t[same], w_t[same], rtol=1e-6)
    for c in range(3):
        np.testing.assert_array_equal(got.normal[c].numpy()[same],
                                      np.asarray(want.normal[c])[same])
        np.testing.assert_allclose(got.p[c].numpy()[same], np.asarray(want.p[c])[same],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.u.numpy()[same], np.asarray(want.u)[same])
    if case == "quad":  # a bare quad has no second hit: no volume
        assert not scattered.any()
    else:
        assert scattered.sum() >= 10  # the media really scatter


def test_group_box_matches_analytic_box():
    """Group([Box]) takes the general path and scatters as the analytic box."""
    box = PO.Box((-3, -2, -4), (2, 3, 1), PM.Lambertian((0.5, 0.5, 0.5)))
    ta = _media_tables(PO.ConstantMedium(box, 0.35, (1, 1, 1)))
    tg = _media_tables(PO.ConstantMedium(PO.Group(box), 0.35, (1, 1, 1)))
    assert ta.med_kinds == (1,) and tg.med_kinds == (2,) and tg.gb_box_meds == (0,)
    o, d, tm, u, _ = _inputs(3, 1)
    ra, rg = (apply_media_p(t, *_miss(o, d, u, tm)) for t in (ta, tg))
    assert torch.equal(ra.hit, rg.hit) and bool(ra.hit.any())
    torch.testing.assert_close(ra.t, rg.t, rtol=1e-6, atol=1e-6)


def test_union_first_second_hit_semantics():
    """Two disjoint boxes along +z: the interval is the first box only
    (rec1 its entry, rec2 the next hit, its exit)."""
    mat = PM.Lambertian((0.5, 0.5, 0.5))
    t = _media_tables(PO.ConstantMedium(PO.Group(PO.Box((-1, -1, 0), (1, 1, 2), mat),
                                                 PO.Box((-1, -1, 5), (1, 1, 7), mat)),
                                        123.0, (1, 1, 1)))
    assert t.med_kinds == (2,) and t.gb_box_meds == (0, 0)
    z = torch.zeros(64)
    o, d = (z, z, z - 10.0), (z, z, z + 1.0)
    t1, h1 = _gb_first_hit(t, 0, o, d, z, torch.full_like(z, -BIG))
    t2, h2 = _gb_first_hit(t, 0, o, d, z, t1 + 1e-4)
    assert bool(h1.all()) and bool(h2.all())
    torch.testing.assert_close(t1, z + 10.0)
    torch.testing.assert_close(t2, z + 12.0)
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.random((1, 64), dtype=np.float32))
    rec = apply_media_p(t, o, d, T_MIN, _miss_record(64), u)
    # dense: every ray scatters within -ln(1e-6) / 123 < 0.12 of the entry
    assert bool(rec.hit.all()) and bool(((rec.t - 10.0).abs() < 0.15).all())


@pytest.mark.parametrize("bare", [False, True])
def test_moving_sphere_boundary_uses_ray_time(bare):
    """A moving sphere boundary, in a Group or bare, is kind 2 and its center
    moves with the ray's shutter time."""
    sph = PO.Sphere((0, 0, 0), 1.0, PM.Lambertian((0.5, 0.5, 0.5)), center2=(6, 0, 0))
    t = _media_tables(PO.ConstantMedium(sph if bare else PO.Group(sph), 50.0, (1, 1, 1)))
    assert t.med_kinds == (2,) and t.gb_sph_meds == (0,)
    z = torch.zeros(64)
    o, d = (z, z, z - 10.0), (z, z, z + 1.0)
    u = torch.from_numpy(np.random.default_rng(2).random((1, 64), dtype=np.float32))
    at0 = apply_media_p(t, o, d, T_MIN, _miss_record(64), u, time=z)
    at1 = apply_media_p(t, o, d, T_MIN, _miss_record(64), u, time=z + 1.0)
    assert bool(at0.hit.all()) and not bool(at1.hit.any())


def test_nested_and_empty_boundaries_raise():
    mat = PM.Lambertian((0.5, 0.5, 0.5))
    inner = PO.ConstantMedium(PO.Box((-1, -1, -1), (1, 1, 1), mat), 1.0, (1, 1, 1))
    with pytest.raises(TypeError, match="cannot contain another"):
        _media_tables(PO.ConstantMedium(PO.Group(inner), 1.0, (1, 1, 1)))
    with pytest.raises(TypeError, match="no geometry"):
        _media_tables(PO.ConstantMedium(PO.Group(), 1.0, (1, 1, 1)))


def test_media_stay_off_the_short_path():
    """A small static scene that would pass the short-path gate fails it
    once it holds a medium (art_tpu builder.py:951)."""
    mat = PM.Lambertian((0.5, 0.5, 0.5))
    plain = _media_tables(PO.Sphere((0, 0, 0), 1.0, mat))
    fog = _media_tables(PO.Sphere((0, 0, 0), 1.0, mat),
                        PO.ConstantMedium(PO.Sphere((0, 0, 0), 3.0, mat), 0.1, (1, 1, 1)))
    assert plain.sp_consts is not None and fog.sp_consts is None


def test_cornell_smoke_render_matches_art_tpu():
    nx = ny = 32
    seed = 1984
    jfb, jst = jax_render_scene(jax_build_scene("cornell_smoke", nx, ny),
                                JaxConfig(nx=nx, ny=ny, spp=4, seed=seed))
    scene = build_scene("cornell_smoke", nx, ny)
    assert n_uniform_cols(scene.tables) == 11
    fb, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=4, seed=seed), device="cpu",
                          uniforms=_threefry(seed, jst["n_slots"], n_uniform_cols(scene.tables)),
                          short_path=False)
    assert not st["short_path"] and st["n_slots"] == jst["n_slots"]
    assert st["iterations"] == jst["iterations"]
    assert abs(st["rays"] - jst["rays"]) <= 1e-2 * jst["rays"]
    assert (np.abs(fb - jfb).max(axis=-1) <= 1e-3).mean() >= 0.98
    assert np.isfinite(fb).all() and (fb >= 0).all() and fb.max() > 0


def _media_tables(*objs):
    b = port_builder.SceneBuilder().add(*objs)
    b.set_camera(lookfrom=(0, 0, 10), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.compile().tables


def _miss_record(n):
    z = torch.zeros(n)
    return HitRecordP(hit=torch.zeros(n, dtype=torch.bool), t=torch.full((n,), BIG),
                      p=(z, z, z), normal=(z + 1, z, z), u=z, v=z,
                      mat=torch.zeros(n, dtype=torch.int32))


def _miss(o, d, u, tm):
    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    return (tuple(map(T, o)), tuple(map(T, d)), T_MIN, _miss_record(R), T(u[:1]),
            T(tm))
