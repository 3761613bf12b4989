"""The port's plain intersection kernels (ops/intersect_kernels.py) against
art_tpu: the jnp references and the Pallas kernels in interpret mode, at
R = 8192 rays from a numpy seed.  K2 (spheres) on three_spheres and on a
64-sphere scene with moving spheres and hollow (negative-radius) shells;
K5 (quads) and K6 (oriented boxes) on cornell_box (rotated boxes) and on a
hand-built scene of translated, unrotated boxes; ``closest_surface_p`` on
all of them, including cornell_box rays that meet the floor where the box
bottoms lie on it (a quad/box tie the quad must win).

K2 tolerances:
Tolerances: at most 2 hit/miss or winner disagreements per 8192 rays —
knife edges where a last-ulp difference between the frameworks' float
programs flips a tangent or a near-tie; on agreeing
rays t to rtol 1e-5 and normals to 1e-4 (a normal is (p - c) / r, so a
1-ulp change of t moves it by t * |d| * ulp / r).  Against the
interpret-mode Pallas kernel t also gets atol 5e-5: XLA compiles that
kernel body as one fused program with its own float contraction, and for
an origin next to a surface the near root -b - sqrt(b*b - a*c) cancels, so
its error is absolute (about ulp(b*b) / a), not relative.

K5 and K6 tolerances, measured: K5's t and index (its twin's candidate
pass) equal both references bit for bit.  K6's hit set, material and normal equal both; its t equals
the jnp pass on rotated boxes and the Pallas kernel on unrotated ones bit
for bit.  Elsewhere t gets rtol 2e-6 and atol 1e-3 (cornell_box's room
is 555 wide, where one ulp of a coordinate is 6e-5): the Pallas kernel in
interpret mode is one fused XLA program that contracts the box-frame
rotation into FMAs, which moves the box-frame origin by about an ulp of
its coordinates and so t by that over the ray's direction component, and
the jnp pass subtracts each unrotated box's offset per ray where the
kernel tables fold it into min/max (another rounding of the same sum).  (u, v) get atol 2e-6: a
difference of t moves the hit point, and the interpret program may
round u = (x - min) / w through another division form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.ops.intersect import box_attributes_p as jax_box_attrs
from art_tpu.ops.intersect import box_candidates_p as jax_box_candidates
from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu.ops.intersect import quad_candidates_p as jax_quad_candidates
from art_tpu.ops.intersect import sphere_attributes_p as jax_attrs
from art_tpu.ops.intersect import sphere_candidates_p as jax_candidates
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene as port_build_scene
from art_tpu_torch.ops.intersect import closest_surface_p, quad_candidates_p
from art_tpu_torch.ops.intersect_kernels import (
    box_hit_attrs,
    box_hit_attrs_plain,
    quad_hit_attrs,
    quad_hit_attrs_plain,
    sphere_hit_attrs,
    sphere_hit_attrs_plain,
)
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from test_torch_scene import unrotated_scenes

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
    if name in ("three_spheres", "cornell_box"):
        return jax_build_scene(name, 64, 32), port_build_scene(name, 64, 32)
    if name == "unrotated_boxes":
        return unrotated_scenes()
    return (_moving_scene(jax_builder, JO, JM),
            _moving_scene(port_builder, PO, PM))


def _rays(seed, center, half=4.0):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-half, half, (3, R)) + np.asarray(center)[:, None]).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (3, R)).astype(np.float32)
    tm = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return o, d, tm


# ray origins filling each scene: cornell_box's room is [0, 555]^3
_SPAN = {"three_spheres": ((0.0, 0.0, -1.0), 4.0), "moving64": ((0, 0, 0), 4.0),
         "cornell_box": ((277.5, 277.5, 277.5), 277.5),
         "unrotated_boxes": ((0.0, 1.0, 0.0), 4.0)}


def _floor_rays(seed):
    """Origins inside cornell_box's two boxes, directions downward: each ray
    meets the floor quad and its box's bottom face at the same t."""
    rng = np.random.default_rng(seed)
    # (size, y extent, degrees, offset) of the two boxes (scenes.py:294-295)
    boxes = (((165, 165, 165), -18.0, (130, 0, 65)), ((165, 330, 165), 15.0, (265, 0, 295)))
    o = []
    for k in range(2):
        size, deg, off = boxes[k]
        # low and central, so a steep ray leaves through the bottom face
        local = rng.uniform((0.3, 0.02, 0.3), (0.7, 0.3, 0.7), (R // 2, 3)) * np.asarray(size)
        th = np.radians(deg)
        c, s = np.cos(th), np.sin(th)
        world = np.stack([c * local[:, 0] + s * local[:, 2], local[:, 1],
                          -s * local[:, 0] + c * local[:, 2]], 1) + np.asarray(off)
        o.append(world)
    o = np.concatenate(o).T.astype(np.float32)
    d = rng.uniform(-0.1, 0.1, (3, R))
    d[1] = -rng.uniform(0.5, 1.0, R)
    return o, d.astype(np.float32), np.zeros(R, np.float32)


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


@pytest.mark.parametrize("name", ["three_spheres", "moving64", "cornell_box",
                                  "unrotated_boxes", "cornell_floor"])
def test_closest_surface_matches_art_tpu(name):
    jscene, pscene = _scenes("cornell_box" if name == "cornell_floor" else name)
    if name == "cornell_floor":
        o, d, tm = _floor_rays(9)
    else:
        o, d, tm = _rays(9, *_SPAN[name])
    want = jax_closest(jscene.tables, *_jax(o, d, tm), T_MIN)
    got = closest_surface_p(pscene.tables, *_port(o, d, tm), T_MIN)
    agree = np.asarray(want.hit) == got.hit.numpy()
    assert np.sum(~agree) <= 2
    mask = agree & np.asarray(want.hit)
    np.testing.assert_array_equal(got.mat.numpy()[mask], np.asarray(want.mat)[mask])
    for c in range(3):
        np.testing.assert_allclose(got.p[c].numpy()[mask], np.asarray(want.p[c])[mask],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.normal[c].numpy()[mask],
                                   np.asarray(want.normal[c])[mask], atol=1e-4)
        miss = agree & ~np.asarray(want.hit)
        np.testing.assert_array_equal(got.normal[c].numpy()[miss],
                                      np.asarray(want.normal[c])[miss])
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[mask],
                                   np.asarray(getattr(want, k))[mask], atol=2e-6)
    if name == "cornell_floor":
        # every ray ends on the floor (y = 0), on the floor quad's material
        floor = pscene.tables.quad_mat[2]
        assert mask.all() and bool((got.mat == floor).all())
        np.testing.assert_allclose(got.p[1].numpy(), 0.0, atol=1e-3)


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


def _quad_box_case(name, seed):
    scene_name = "cornell_box" if name == "cornell_box" else "unrotated_boxes"
    jscene, pscene = _scenes(scene_name)
    o, d, _ = _rays(seed, *_SPAN[scene_name])
    return jscene.tables, pscene.tables, o, d


@pytest.mark.parametrize("name", ["cornell_box", "unrotated_boxes"])
def test_plain_k5_matches_art_tpu(name):
    """K5's twin: its candidate pass's t and index bit-equal to the Pallas
    kernel (interpret mode) and to the jnp candidate pass (index -1 on a
    miss, where art_tpu's argmin gives 0 and closest_surface_p clamps it),
    and the twin's t that t."""
    jt, pt, o, d = _quad_box_case(name, 21)
    t, idx = quad_candidates_p(pt, *_port(o, d, o[0])[:2], T_MIN)
    assert torch.equal(quad_hit_attrs_plain(pt, *_port(o, d, o[0])[:2])[0], t)
    t, idx = t.numpy(), idx.numpy()
    kt, kidx = pk.quad_closest_hit_planar(jt.quad_packed, *_jax(o, d, o[0])[:2],
                                          n_quads=jt.n_quads, interpret=True)
    np.testing.assert_array_equal(t, np.asarray(kt))
    np.testing.assert_array_equal(idx, np.asarray(kidx))
    jt_, jidx = jax_quad_candidates(jt, *_jax(o, d, o[0])[:2], T_MIN)
    np.testing.assert_array_equal(t, np.asarray(jt_))
    np.testing.assert_array_equal(idx, np.where(np.asarray(jt_) < BIG, np.asarray(jidx), -1))
    assert (idx >= 0).sum() > R // 10


@pytest.mark.parametrize("name", ["cornell_box", "unrotated_boxes"])
def test_plain_k6_matches_art_tpu(name):
    """K6's twin against the Pallas kernel (interpret mode, rotated or
    unrotated form as the scene has) and against the jnp passes."""
    jt, pt, o, d = _quad_box_case(name, 22)
    t, n, u, v, m = box_hit_attrs_plain(pt, *_port(o, d, o[0])[:2])
    t, n, u, v, m = t.numpy(), [x.numpy() for x in n], u.numpy(), v.numpy(), m.numpy()
    hit = t < BIG
    assert hit.sum() > R // 20
    kt, kn, ku, kv, km = pk.box_hit_attrs_planar(
        jt.box_packed, *_jax(o, d, o[0])[:2], n_boxes=jt.n_boxes,
        rotated=jt.has_rotated_boxes, interpret=True)
    jt_, jidx = jax_box_candidates(jt, *_jax(o, d, o[0])[:2], T_MIN)
    jn, ju, jv, jm = jax_box_attrs(jt, *_jax(o, d, o[0])[:2], jt_, jidx)
    exact = "jnp" if jt.has_rotated_boxes else "pallas"
    for ref, (rt, rn, ru, rv, rm) in (("pallas", (kt, kn, ku, kv, km)),
                                      ("jnp", (jt_, jn, ju, jv, jm))):
        rt = np.asarray(rt)
        np.testing.assert_array_equal(hit, rt < BIG, err_msg=ref)
        if ref == exact:
            np.testing.assert_array_equal(t, rt, err_msg=ref)
        else:
            np.testing.assert_allclose(t, rt, rtol=2e-6, atol=1e-3, err_msg=ref)
        np.testing.assert_array_equal(m[hit], np.asarray(rm)[hit], err_msg=ref)
        for c in range(3):
            np.testing.assert_array_equal(n[c][hit], np.asarray(rn[c])[hit], err_msg=ref)
        np.testing.assert_allclose(u[hit], np.asarray(ru)[hit], atol=2e-6, err_msg=ref)
        np.testing.assert_allclose(v[hit], np.asarray(rv)[hit], atol=2e-6, err_msg=ref)
    # a miss carries closest_surface_p's blend defaults
    assert (n[0][~hit] == 1).all() and (n[1][~hit] == 0).all() and (m[~hit] == 0).all()


def test_k5_k6_cpu_wrappers_take_the_plain_path():
    _, pscene = _scenes("cornell_box")
    o, d, _ = _port(*_rays(3, *_SPAN["cornell_box"]))
    for kernel, plain in ((quad_hit_attrs, quad_hit_attrs_plain),
                          (box_hit_attrs, box_hit_attrs_plain)):
        a, b = kernel(pscene.tables, o, d), plain(pscene.tables, o, d)
        assert torch.equal(a[0], b[0]) and torch.equal(a[-1], b[-1])
        # t_min reaches the twin: every hit lies beyond it
        t = kernel(pscene.tables, o, d, 50.0)[0]
        assert bool((t[t < BIG] > 50.0).all()) and bool((t != a[0]).any())
