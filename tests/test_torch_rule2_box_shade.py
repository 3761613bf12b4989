"""The arithmetic of the H100 designs of K6's merge form (``csrc/box_hit.cu``
with ``box_attrs.cuh merge_box_hit``: the boxes merged into the quads'
running closest hit in one launch) and of K3's per-pixel flush
(``csrc/shade_flush.cu`` through ``csrc/flush_warp.cuh``), held on the CPU
on numpy-seeded inputs, bit for bit unless stated.

* (a) The merge form's twin ``box_hit_attrs_merge_plain`` equals
  ``_closer(quad best, box_hit_attrs_plain(...))`` and a model of the
  kernel's own order (``_kernel_order``: the scan starts at the incoming t
  with a strict ``<``, box by box in scene order, and only a lane a box
  wins takes that box's attributes), in all seven outputs, signed zeros
  included, and leaves the incoming hit untouched; on cornell_box's tables,
  a scene of translated and rotated boxes and one of unrotated boxes
  (the folded form), with rays that hit a box, point away from one, tie a
  quad exactly (they leave a box through its bottom face on the floor
  quad), start on a box face, and run parallel to a slab (d.y = 0, some in
  the plane of a face), at t_min = T_MIN and 0.25.  On the same rays
  ``closest_surface_p`` meets art_tpu's (its jnp route, and at T_MIN its
  Pallas route in interpret mode) at the tolerances of
  tests/test_torch_intersect.py.
* (b) ``sp_kernel.flush_warp_p`` (the warp order of K11 and K3) applied to
  K3's deaths matches ``flush_plain``'s ``index_add_`` within 1e-6
  relative, with ``lost`` equal, in both K3 modes: on a pool whose samples
  of a pixel sit side by side (up to 32 slots of a warp dying into one
  pixel), R not a multiple of 32, phase 2b's eight pixels outside the tile,
  and on a cornell_box render's pool 1 and 20 staged iterations in;
  ``flush_census`` counts the adds each flush makes.
* (c) ``closest_surface_p`` routes a quad scene's boxes through the merge
  form (on the CPU its twin), once a call, and a scene without quads through
  K6's plain form; cornell_box's staged step takes the merge form.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl_module

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import intersect as jax_intersect
from art_tpu.ops import pallas_kernels as pk
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import (
    _closer,
    box_attributes_rows,
    box_candidates_rows,
    closest_surface_p,
)
from art_tpu_torch.ops.shade import shade_params_p
from art_tpu_torch.ops.shade_kernel import (
    REC_BAKED,
    REC_F,
    flush_plain,
    shade_flush_plain,
)
from art_tpu_torch.ops.sp_kernel import flush_census, flush_warp_p
from art_tpu_torch.render.integrator import n_uniform_cols, staged_step
from art_tpu_torch.render.renderer import RenderConfig, plan_batches
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from test_torch_scene import unrotated_scenes

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = pk.RAY_BLOCK  # 8192: art_tpu's Pallas route takes whole ray blocks
BOX_SCENES = ("cornell_box", "mixed_boxes", "unrotated_boxes")


def _mixed_boxes(builder_mod, O, M):
    """A floor quad at y = 0 and four boxes standing on it: translated,
    rotated, rotated then translated (both signs of the angle), and a
    quad light."""
    white, red = M.Lambertian((0.73, 0.73, 0.73)), M.Lambertian((0.65, 0.05, 0.05))
    b = builder_mod.SceneBuilder()
    b.add(
        O.Quad((-6, 0, -6), (12, 0, 0), (0, 0, 12), white, inward=True),
        O.Quad((-1, 5, -1), (2, 0, 0), (0, 0, 2), M.DiffuseLight((4.0, 4.0, 4.0))),
        O.Translate(O.Box((0, 0, 0), (1.25, 0.75, 1.5), red), (-3.3, 0.0, -0.7)),
        O.RotateY(O.Box((-0.5, 0, -0.5), (0.5, 1.2, 0.5), white), 30.0),
        O.Translate(O.RotateY(O.Box((0, 0, 0), (1.0, 2.0, 0.8), M.Metal((0.8, 0.7, 0.6), 0.2)),
                              -18.0), (1.8, 0.0, 0.9)),
        O.Translate(O.RotateY(O.Box((0, 0, 0), (0.9, 0.6, 0.9), red), 15.0), (-1.2, 0.0, 2.4)),
    )
    b.set_camera(lookfrom=(0, 3, 9), lookat=(0, 0.5, 0), vup=(0, 1, 0), vfov_degrees=45.0,
                 aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


@functools.lru_cache(maxsize=None)
def _scenes(name):
    if name == "mixed_boxes":
        return _mixed_boxes(jax_builder, JO, JM), _mixed_boxes(port_builder, PO, PM)
    if name == "unrotated_boxes":
        return unrotated_scenes()
    return jax_build_scene(name, 32, 32), build_scene(name, 32, 32)


def _to_world(row, local):
    """Box-frame points (N, 3) of box rows (N, 12) to world: R(theta) then
    the offset (box_attrs.cuh to_box_frame, inverted)."""
    c, s = row[:, 6:7], row[:, 7:8]
    x, y, z = local[:, 0:1], local[:, 1:2], local[:, 2:3]
    return np.concatenate([c * x + s * z, y, -s * x + c * z], 1) + row[:, 8:11]


def _box_rays(tables, seed):
    """R rays, a fifth of each kind (the rest hits): aimed at a random
    interior point of a random box (hits); pointed away from it; from a low
    point inside a box straight down through its bottom face onto the floor
    (y = 0 for every scene's boxes: an exact quad/box tie); from a point on
    a box face in any direction; horizontal (d.y = 0, parallel to the y
    slabs), a quarter of them at a box's bottom or top height exactly.
    Returns (o, d, tm) as float32 numpy."""
    rng = np.random.default_rng(seed)
    rows = tables.box_rows.numpy().astype(np.float64)
    k = rng.integers(0, rows.shape[0], R)
    row = rows[k]
    lo, hi = row[:, 0:3], row[:, 3:6]
    span = float(np.abs(rows[:, :6]).max() + np.abs(rows[:, 8:11]).max())
    inner = _to_world(row, lo + rng.uniform(0.1, 0.9, (R, 3)) * (hi - lo))
    away = rng.normal(size=(R, 3))
    away *= span * rng.uniform(0.1, 0.8, (R, 1)) / np.linalg.norm(away, axis=1, keepdims=True)
    o, d = inner + away, -away
    m = R // 5
    d[m:2 * m] = away[m:2 * m]  # away from the box
    # inside, low and central, straight down: out through the bottom face,
    # where the floor quad lies (the boxes stand on y = 0)
    low = lo + rng.uniform((0.3, 0.02, 0.3), (0.7, 0.3, 0.7), (R, 3)) * (hi - lo)
    o[2 * m:3 * m] = _to_world(row, low)[2 * m:3 * m]
    d[2 * m:3 * m] = np.stack([rng.uniform(-0.05, 0.05, m), -np.ones(m),
                               rng.uniform(-0.05, 0.05, m)], 1)
    # on a face: one box-frame coordinate at its min or max
    face = lo + rng.uniform(0.05, 0.95, (R, 3)) * (hi - lo)
    axis, top = rng.integers(0, 3, R), rng.random(R) < 0.5
    face[np.arange(R), axis] = np.where(top[:, None], hi, lo)[np.arange(R), axis]
    o[3 * m:4 * m] = _to_world(row, face)[3 * m:4 * m]
    d[3 * m:4 * m] = rng.normal(size=(m, 3))
    # horizontal, toward the box's interior point from outside it; a
    # quarter at the box's bottom (y = 0, the floor plane) or top height
    o[4 * m:] = inner[4 * m:] + away[4 * m:] * np.array([1.0, 0.0, 1.0])
    d[4 * m:] = -away[4 * m:] * np.array([1.0, 0.0, 1.0])
    edge = 4 * m + np.arange((R - 4 * m) // 4)
    o[edge, 1] = np.where(top[edge], hi[edge, 1], lo[edge, 1])
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[4 * m:, 1] = 0.0
    tm = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return (tuple(np.ascontiguousarray(o[:, c]) for c in range(3)),
            tuple(np.ascontiguousarray(d[:, c]) for c in range(3)), tm)


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def _jax(o, d, tm):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)


def _flat(res):
    """(t, normal, u, v, mat) -> seven numpy arrays."""
    return [np.asarray(x) for x in (res[0], *res[1], res[2], res[3], res[4])]


def _assert_bits_equal(got, want, what):
    for k, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        assert g.dtype == w.dtype, (what, k)
        bits = (g.view(np.int32) != w.view(np.int32)) if g.dtype == np.float32 else g != w
        assert int(bits.sum()) == 0, f"{what}: output {k}: {int(bits.sum())} values differ"


def _kernel_order(tables, o, d, best, t_min):
    """box_hit.cu's merge form lane by lane: the running t starts at the
    incoming one, each box in scene order replaces it where its candidate t
    is strictly smaller, and only a lane a box won takes that box's
    attributes at its t; every other lane keeps the incoming values."""
    rows = tables.box_rows
    t, win = best[0].clone(), torch.full(best[0].shape, -1, dtype=torch.int64)
    for b in range(rows.shape[0]):
        t_b, _ = box_candidates_rows(rows[b:b + 1], tables.has_rotated_boxes, o, d, t_min)
        closer = t_b < t
        t, win = torch.where(closer, t_b, t), torch.where(closer, b, win)
    won = win >= 0
    normal, u, v, mat = box_attributes_rows(rows[win.clamp_min(0)], o, d, t)
    keep = (best[1], best[2], best[3], best[4])
    return (t, tuple(torch.where(won, n, k) for n, k in zip(normal, keep[0])),
            torch.where(won, u, keep[1]), torch.where(won, v, keep[2]),
            torch.where(won, mat, keep[3]))


def _clone_hit(h):
    return (h[0].clone(), tuple(c.clone() for c in h[1]), *(x.clone() for x in h[2:]))


@pytest.mark.parametrize("t_min", [T_MIN, 0.25])
@pytest.mark.parametrize("name", BOX_SCENES)
def test_merge_twin_equals_closer_and_the_kernel_order(name, t_min):
    tables = _scenes(name)[1].tables
    o, d, _ = _port(*_box_rays(tables, 31))
    quad = K.quad_hit_attrs_plain(tables, o, d, t_min)
    before = _clone_hit(quad)
    got = K.box_hit_attrs_merge_plain(tables, o, d, quad, t_min)
    _assert_bits_equal(quad, before, "the incoming hit is not changed")
    box = K.box_hit_attrs_plain(tables, o, d, t_min)
    _assert_bits_equal(got, _closer(quad, box), "_closer")
    _assert_bits_equal(got, _kernel_order(tables, o, d, quad, t_min), "kernel order")
    _assert_bits_equal(K.box_hit_attrs_merge(tables, o, d, quad, t_min), got, "CPU wrapper")
    # every kind of ray took place: box wins, quad wins, exact ties the
    # quad keeps (straight down onto the floor), misses, horizontal rays
    # that hit a box
    m = R // 5
    wins = box[0] < quad[0]
    ties = (box[0] == quad[0]) & (quad[0] < BIG)
    assert int(wins[:m].sum()) > m // 2 and int((quad[0][m:2 * m] < box[0][m:2 * m]).sum()) > 0
    # (t_min = 0.25 puts some boxes' floors out of a low origin's reach)
    assert int(ties[2 * m:3 * m].sum()) > (m // 2 if t_min == T_MIN else m // 20)
    assert int((got[0][m:2 * m] >= BIG).sum()) > 0 or name == "cornell_box"  # closed room
    assert int(wins[4 * m:].sum()) > m // 4 and bool((d[1][4 * m:] == 0).all())
    assert bool((got[0][got[0] < BIG] > t_min).all())
    if t_min == 0.25:  # from a face: nothing within 0.25
        assert not bool((got[0][3 * m:4 * m] <= 0.25).any())


def _closest_meets(got, want):
    """tests/test_torch_intersect.py's bars for closest_surface_p: at most 2
    knife edges, lanes where the hit, the material or t (beyond K6's bar
    against the Pallas kernel, rtol 2e-6 and atol 1e-3) part; a ray that
    starts on a box face finds its next face near t_min, where art_tpu's
    contracted box frame may take another root."""
    t, wt = got.t.numpy(), np.asarray(want.t)
    agree = (np.asarray(want.hit) == got.hit.numpy()) & (
        ~got.hit.numpy() | ((got.mat.numpy() == np.asarray(want.mat))
                            & (np.abs(t - wt) <= 1e-3 + 2e-6 * np.abs(wt))))
    assert np.sum(~agree) <= 2
    hit = agree & np.asarray(want.hit)
    assert hit.sum() > R // 10
    np.testing.assert_array_equal(got.mat.numpy()[hit], np.asarray(want.mat)[hit])
    miss = agree & ~np.asarray(want.hit)
    for c in range(3):
        np.testing.assert_allclose(got.p[c].numpy()[hit], np.asarray(want.p[c])[hit],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.normal[c].numpy()[hit],
                                   np.asarray(want.normal[c])[hit], atol=1e-4)
        np.testing.assert_array_equal(got.normal[c].numpy()[miss],
                                      np.asarray(want.normal[c])[miss])
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[hit],
                                   np.asarray(getattr(want, k))[hit], atol=2e-6)


@pytest.mark.parametrize("t_min", [T_MIN, 0.25])
@pytest.mark.parametrize("name", BOX_SCENES)
def test_closest_surface_meets_art_tpu_jnp(name, t_min):
    jscene, pscene = _scenes(name)
    o, d, tm = _box_rays(pscene.tables, 32)
    _closest_meets(closest_surface_p(pscene.tables, *_port(o, d, tm), t_min),
                   jax_intersect.closest_surface_p(jscene.tables, *_jax(o, d, tm), t_min))


@pytest.mark.parametrize("name", BOX_SCENES)
def test_closest_surface_meets_art_tpu_pallas(name, monkeypatch):
    """art_tpu's Pallas route (every backend gate answering TPU, every
    pallas_call in interpret mode, as tests/test_differential.py runs it)."""
    jscene, pscene = _scenes(name)
    o, d, tm = _box_rays(pscene.tables, 33)
    monkeypatch.setenv("ART_TPU_FORCE_PALLAS", "1")
    orig = pl_module.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl_module, "pallas_call", interpret)
    assert jax_intersect._use_pallas(R)
    want = jax_intersect.closest_surface_p(jscene.tables, *_jax(o, d, tm), T_MIN)
    _closest_meets(closest_surface_p(pscene.tables, *_port(o, d, tm), T_MIN), want)


# ---- (b) K3's flush in the warp order ----

P_TILE = 1024
N = R - 13  # not a multiple of 32: the last warp part-filled
# phase 2b's eight deaths outside the tile
OUT = (-1, P_TILE, P_TILE + 1, -7, 1 << 30, 2 * P_TILE, -(1 << 30), P_TILE + 99)


def _shade_inputs(name, seed):
    """A pool of N slots on ``name``'s rays with the samples of a pixel side
    by side (slot i on pixel (i // 64) mod P_TILE), half the slots at their
    last bounce, radiance >= 0, the first eight dying outside the tile; its
    hit record and K3's planes (baked by the scene's shade_rows, else
    plane-fed)."""
    rng = np.random.default_rng(seed)
    scene = build_scene(name, 32, 32)
    tables = scene.tables
    pool = rk.new_pool(N, "cpu")
    if tables.n_boxes:
        o, d, _ = _port(*_box_rays(tables, seed))
    else:
        o = tuple(torch.from_numpy(rng.uniform(-4, 4, R).astype(np.float32)) for _ in range(3))
        d = tuple(torch.from_numpy(rng.uniform(-1, 1, R).astype(np.float32)) for _ in range(3))
    for k, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
        pool[k].copy_(c[:N])
    for k in ("t0", "t1", "t2", "r0", "r1", "r2"):
        pool[k].copy_(torch.from_numpy(rng.uniform(0.0, 1.0, N).astype(np.float32)))
    pool["pix"].copy_(torch.div(torch.arange(N, dtype=torch.int32), 64,
                                rounding_mode="floor") % P_TILE)
    pool["pix"][:8] = torch.tensor(OUT, dtype=torch.int32)
    pool["bounce"].copy_(torch.from_numpy(np.where(rng.random(N) < 0.5, 49,
                                                   rng.integers(0, 49, N)).astype(np.int32)))
    pool["act"].copy_(torch.from_numpy(rng.random(N) < 0.9))
    pool["act"][:8] = True
    pool["bounce"][:8] = 49
    o, d = (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(tables, o, d, pool["tm"], T_MIN)
    u = torch.from_numpy(rng.random((4, N), dtype=np.float32))
    if tables.shade_rows is None:
        params = shade_params_p(tables, rec)
        planes = dict(zip(REC_F, (*rec.p, *rec.normal, *params[:3], *params[3], *params[4],
                                  *u)))
    else:
        planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u)))
    return scene, pool, rec.hit, planes


def _staged_inputs(name, iters):
    """A staged render's pool of ``name`` at 32x32 @ 64 after ``iters``
    iterations and the next refill: its samples of a pixel side by side as
    the refill lays them out; its hit record and K3's planes."""
    scene = build_scene(name, 32, 32)
    tables = scene.tables
    tile_pixels, spp, R_pool = plan_batches(32 * 32, 64, 4, RenderConfig(), "cpu")
    scal = rk.RefillScal(spp, tile_pixels, 0, 32 * 32, 32, 32)
    pool = rk.new_pool(R_pool, "cpu")
    q, hist = torch.zeros(2, dtype=torch.int64), torch.zeros(iters + 2, dtype=torch.int64)
    fb, lost = torch.zeros((tile_pixels, 3)), torch.zeros(1, dtype=torch.int32)
    ncols = n_uniform_cols(tables)
    for it in range(iters):
        staged_step(pool, scene.camera, q, it % 2, hist, it, scal, tables, scene.background,
                    fb, lost, key=(7, 0, 0), ncols=ncols, max_depth=50,
                    gradient=scene.gradient_bg)
    u_ball, u_choice, _ = rk.fused_refill_plain(pool, scene.camera, q, iters % 2, hist, iters,
                                                scal, key=(7, 0, 0), ncols=ncols)
    o, d = (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(tables, o, d, pool["tm"], T_MIN)
    planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u_ball, u_choice)))
    return scene, pool, rec.hit, planes, tile_pixels


@pytest.mark.parametrize("case", ["cornell_box", "bouncing_spheres", "cornell_box staged 1",
                                  "cornell_box staged 20"])
def test_warp_flush_of_k3_deaths_matches_index_add(case):
    if "staged" in case:
        scene, pool, hit, planes, P = _staged_inputs("cornell_box", int(case.split()[-1]))
        n_out = 0
    else:
        (scene, pool, hit, planes), P, n_out = _shade_inputs(case, 41), P_TILE, len(OUT)
    consts = scene.tables.shade_rows
    assert (consts is None) == (case == "bouncing_spheres")  # both K3 modes
    before = {k: v.clone() for k, v in pool.items()}
    fb, lost = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    shade_flush_plain(pool, hit, planes, scene.background, fb, lost, max_depth=50,
                      gradient=scene.gradient_bg, consts=consts)
    died = before["act"] & ~pool["act"]
    rad = (pool["r0"], pool["r1"], pool["r2"])
    fb_w, lost_w = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    fb_p, lost_p = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    flush_warp_p(before["pix"], died, rad, fb_w, lost_w)
    flush_plain(before["pix"], died, rad, fb_p, lost_p)
    assert torch.equal(fb_p, fb)  # K3's twin flushes by index_add_
    rel = float(((fb_w - fb_p).abs() / (fb_p.abs() + 1e-6)).max())
    assert int(lost_w) == int(lost_p) == int(lost) == n_out
    assert rel <= 1e-6, rel
    deaths, pixels, shared = flush_census(before["pix"], died, P)
    print(f"{case}: {deaths} deaths in the tile, {pixels} adds a channel in the warp flush, "
          f"{shared / max(deaths, 1):.3f} share a pixel in their warp, max rel {rel:.3g}")
    assert deaths == int(died.sum()) - n_out and int(fb_p.ne(0).any(dim=1).sum()) <= pixels
    if case != "cornell_box staged 20":
        assert pixels < deaths // 8  # many deaths of one pixel in a warp


def test_flush_census_counts():
    """A hand-made warp and a half: deaths on pixels 3, 3, 3, 5, an
    outside pixel, and in the next warp 3 again."""
    pix = torch.tensor([3, 3, 7, 3, 5, -1] + [0] * 26 + [3, 3, 9], dtype=torch.int32)
    died = torch.zeros(35, dtype=torch.bool)
    died[[0, 1, 3, 4, 5, 32, 33]] = True
    assert flush_census(pix, died, 8) == (6, 3, 5)
    fb, lost = torch.zeros((8, 3)), torch.zeros(1, dtype=torch.int32)
    rad = tuple(torch.arange(35, dtype=torch.float32) + c for c in range(3))
    flush_warp_p(pix, died, rad, fb, lost)
    assert int(lost) == 1
    assert fb[3].tolist() == [0 + 1 + 3 + 32 + 33, 5 + 69, 10 + 69]
    assert fb[5].tolist() == [4.0, 5.0, 6.0]


# ---- (c) the route ----


def _counting(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(K, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(K, name, counted)
    return calls


NAMES = ("box_hit_attrs", "box_hit_attrs_plain", "box_hit_attrs_merge",
         "box_hit_attrs_merge_plain")


@pytest.mark.parametrize("plain", [False, True])
def test_cornell_staged_step_takes_the_merge_form(plain, monkeypatch):
    calls = _counting(monkeypatch, NAMES)
    _, pool, _, _, _ = _staged_inputs("cornell_box", 0)  # the refill only
    scene = build_scene("cornell_box", 32, 32)
    tile_pixels, spp, R_pool = plan_batches(32 * 32, 64, 4, RenderConfig(), "cpu")
    scal = rk.RefillScal(spp, tile_pixels, 0, 32 * 32, 32, 32)
    q, hist = torch.zeros(2, dtype=torch.int64), torch.zeros(4, dtype=torch.int64)
    fb, lost = torch.zeros((tile_pixels, 3)), torch.zeros(1, dtype=torch.int32)
    for k in calls:
        calls[k] = 0
    for it in range(2):
        staged_step(pool, scene.camera, q, it % 2, hist, it, scal, scene.tables,
                    scene.background, fb, lost, key=(7, 0, 0),
                    ncols=n_uniform_cols(scene.tables), max_depth=50,
                    gradient=scene.gradient_bg, plain=plain)
    # the wrapper runs the twin on the CPU; the twin's K6 is the plain
    # form's twin, never its wrapper
    assert calls == {"box_hit_attrs": 0, "box_hit_attrs_plain": 2,
                     "box_hit_attrs_merge": 0 if plain else 2, "box_hit_attrs_merge_plain": 2}


def _bare_boxes(builder_mod, O, M):
    """``_mixed_boxes``' four boxes alone: no quad comes before them."""
    white, red = M.Lambertian((0.73, 0.73, 0.73)), M.Lambertian((0.65, 0.05, 0.05))
    b = builder_mod.SceneBuilder()
    b.add(
        O.Translate(O.Box((0, 0, 0), (1.25, 0.75, 1.5), red), (-3.3, 0.0, -0.7)),
        O.RotateY(O.Box((-0.5, 0, -0.5), (0.5, 1.2, 0.5), white), 30.0),
        O.Translate(O.RotateY(O.Box((0, 0, 0), (1.0, 2.0, 0.8), M.Metal((0.8, 0.7, 0.6), 0.2)),
                              -18.0), (1.8, 0.0, 0.9)),
        O.Translate(O.RotateY(O.Box((0, 0, 0), (0.9, 0.6, 0.9), red), 15.0), (-1.2, 0.0, 2.4)),
    )
    b.set_camera(lookfrom=(0, 3, 9), lookat=(0, 0.5, 0), vup=(0, 1, 0), vfov_degrees=45.0,
                 aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


def test_boxes_without_quads_take_the_plain_form(monkeypatch):
    jscene = _bare_boxes(jax_builder, JO, JM)
    tables = _bare_boxes(port_builder, PO, PM).tables
    assert tables.n_quads == 0 and tables.n_boxes == 4
    o, d, tm = _box_rays(tables, 34)
    calls = _counting(monkeypatch, NAMES)
    got = closest_surface_p(tables, *_port(o, d, tm), T_MIN)
    assert calls == {"box_hit_attrs": 1, "box_hit_attrs_plain": 1, "box_hit_attrs_merge": 0,
                     "box_hit_attrs_merge_plain": 0}
    _closest_meets(got, jax_intersect.closest_surface_p(jscene.tables, *_jax(o, d, tm), T_MIN))
