"""The big scenes (M12, final_scene and original_scene) against art_tpu: the
sphere tail, the split sphere pass (``ops/compact_sphere.py``), the scene
tables carried by ``tables_from_numpy``, and whole renders.

Tail: ``sph_n_tail``, ``sph_tail_r``, ``sph_tail_mat`` and ``sph_tail_box``
equal art_tpu's ``pack_spheres`` / ``pack_tail_spheres``; ``sph_tail_rows``
are art_tpu's tail rows in scene order, ``sph_head_rows`` the rest.
``tail_box_needy`` equals art_tpu's, rays with zero direction components
included.  The split's twin is bit-equal to the full-table K2 twin at needy
shares of 0, about 30% and 100% on final_scene rays, but on exact head/tail
ties, which are counted (none occurs).

Renders, on art_tpu's threefry uniforms (``n_uniform_cols`` columns) and
its camera (carried with the tables by ``tables_from_numpy``; art_tpu's
jnp camera frame rounds v_y to 1.0000001 on these scenes, the port's numpy
one to 1.0):

* final_scene 24x24 @ 4 against art_tpu's render: equal iterations, rays
  within 1% and >= 98% of the pixels within 1e-3, cornell_box's budgets
  (measured: rays 0.28%, 98.4% of the pixels).
* original_scene 16x16 @ 4, lock-step: every iteration of a render, the
  port's staged step (K1, K5, K9, the full-table K2, media, K7's noodle,
  the 8-ball's compacted fetch, baked K3) against art_tpu's op-by-op
  ``_bounce_step`` from the same state, with the box grid off (art_tpu's
  CPU route is the brute box test), at most 2 flips an iteration (measured:
  none, and every state plane within 2e-4).
* original_scene 16x16 @ 4 whole, against art_tpu's jitted render: equal
  iterations, rays within 2% and >= 85% of the pixels within 1e-3
  (measured: 1.4% and 87.1%).  The looser bar is art_tpu's, not the
  port's: its render is one jitted XLA program, which rounds otherwise than
  its op-by-op functions, and the fuzzy and near-mirror metal spheres of
  this scene turn a last-ulp difference into another path (jitting
  art_tpu's own ``_bounce_step`` moves the same pixels); art_tpu's render
  run op by op (``jax.disable_jit``, 84 s, too slow here) agreed with the
  port on 98.8% of the pixels and on the rays to 0.03%."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops.compact_sphere import tail_box_needy as jax_tail_box_needy
from art_tpu.render.integrator import _bounce_step as jax_bounce_step
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu.render.renderer import render_scene as jax_render_scene
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import compact_sphere as cs
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import apply_media_p, closest_surface_p
from art_tpu_torch.ops.shade_kernel import REC_BAKED, REC_SP, STATE_F, shade_flush
from art_tpu_torch.ops.texture_eval import eval_special_p
from art_tpu_torch.render.integrator import n_uniform_cols
from art_tpu_torch.render.renderer import RenderConfig, plan_batches, render_scene
from art_tpu_torch.scene.builder import CompiledScene, tables_from_numpy
from test_torch_scene import _assert_tables_equal, _jax_arrays
from test_torch_render import _threefry

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
BIG_SCENES = ["cornell_smoke", "final_scene", "original_scene"]
TAIL_META = ("sph_n_tail", "sph_tail_r", "sph_tail_mat", "sph_tail_box")


def _carried(name, nx, ny):
    """art_tpu's scene carried into the port: tables and camera through
    ``tables_from_numpy`` (the grid and tail fields too)."""
    jscene = jax_build_scene(name, nx, ny)
    arrays, cam = _jax_arrays(jscene)
    jt = jscene.tables
    arrays.update({k: getattr(jt, k) for k in TAIL_META})
    arrays.update({k: getattr(jt, k) for k in (
        "n_media", "med_kinds", "gb_sph_meds", "gb_quad_meds", "gb_box_meds",
        "box_grid_kx", "box_grid_kz", "box_grid_x0", "box_grid_z0", "box_grid_w",
        "box_grid_y0", "box_grid_mat", "box_grid_cells")})
    tables, camera = tables_from_numpy(arrays, cam)
    return jscene, arrays, CompiledScene(tables=tables, camera=camera,
                                         background=jscene.background,
                                         gradient_bg=jscene.gradient_bg, name=name)


@pytest.mark.parametrize("name", BIG_SCENES)
def test_tables_from_numpy_carries_big_scenes(name):
    """Media, gb, grid and tail fields through ``tables_from_numpy`` equal
    the port's own build, kernel tables included."""
    _, arrays, carried = _carried(name, 32, 32)
    built = build_scene(name, 32, 32).tables
    _assert_tables_equal(carried.tables, arrays)
    for k in TAIL_META + ("n_media", "med_kinds", "box_grid_kx", "box_grid_cells"):
        assert getattr(carried.tables, k) == getattr(built, k), k
    for k in ("sph_rows", "sph_head_rows", "sph_tail_rows", "box_grid_rows",
              "box_grid_cell_rows", "quad_rows", "shade_rows"):
        a, b = getattr(carried.tables, k), getattr(built, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


@pytest.mark.parametrize("name", ["final_scene", "original_scene"])
def test_sphere_tail_matches_art_tpu(name):
    jt = jax_build_scene(name, 16, 16).tables
    t = build_scene(name, 16, 16).tables
    for k in TAIL_META:
        assert getattr(t, k) == getattr(jt, k), k
    assert t.sph_n_tail == 1000 and cs.use_split(t)
    np.testing.assert_array_equal(t.sph_tail_rows.numpy()[:, :9],
                                  np.asarray(jt.sph_tail_packed)[:1000, :9])
    assert t.sph_head_rows.shape[0] + 1000 == t.n_spheres
    head = t.sph_head_rows.numpy()
    assert not ((head[:, 6] == t.sph_tail_r) & (head[:, 7] == t.sph_tail_mat)
                & ~head[:, 3:6].any(axis=1)).any()


def _box_rays(seed, box, share):
    """Rays at final_scene's tail box: a ``share`` of them aimed at a point
    inside it, the rest from 600 away pointed away from its centre (such a
    ray never meets the box)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(box[:3]), np.asarray(box[3:])
    centre = (lo + hi) / 2
    away = rng.normal(size=(R, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    o = centre + 600.0 * away
    aim = rng.random(R) < share
    target = lo + rng.random((R, 3)) * (hi - lo)
    d = np.where(aim[:, None], target - o, away * rng.uniform(0.5, 2.0, (R, 1)))
    return o.T.astype(np.float32), d.T.astype(np.float32), aim


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_split_equals_the_full_table_k2(share):
    t = build_scene("final_scene", 16, 16).tables
    o, d, aim = _box_rays(int(share * 10) + 3, t.sph_tail_box, share)
    tm = np.random.default_rng(5).random(R, dtype=np.float32)
    P = tuple(torch.from_numpy(x.copy()) for x in o), tuple(torch.from_numpy(x.copy())
                                                           for x in d)
    needy = cs.tail_box_needy(t.sph_tail_box, *P, T_MIN).numpy()
    np.testing.assert_array_equal(needy, aim)  # 0, ~30% and 100% needy
    st, sn, sm = cs.sphere_hit_attrs_split(t, *P, torch.from_numpy(tm), plain=True)
    ft, fn, fm = K.sphere_hit_attrs_plain(t, *P, torch.from_numpy(tm))
    # exact head/tail ties: the head's closest t equals the tail's
    ht = K.sphere_hit_attrs_plain(t, *P, torch.from_numpy(tm), rows=t.sph_head_rows)[0]
    tt = K.sphere_hit_attrs_plain(t, *P, torch.from_numpy(tm), rows=t.sph_tail_rows)[0]
    ties = ((ht == tt) & (ht < BIG)).numpy()
    assert ties.sum() == 0
    assert torch.equal(st, ft) and torch.equal(sm, fm)
    for c in range(3):
        assert torch.equal(sn[c], fn[c])
    hits_tail = (tt < ht).numpy()
    assert (hits_tail.sum() > R // 20) == (share > 0)


def test_tail_box_needy_matches_art_tpu():
    """Zero direction components (1e-20 in the slab division) included."""
    t = build_scene("final_scene", 16, 16).tables
    rng = np.random.default_rng(8)
    o = rng.uniform(-700, 700, (3, R)).astype(np.float32)
    o[1] = rng.uniform(0, 700, R)
    d = rng.uniform(-1, 1, (3, R)).astype(np.float32)
    d[0, :R // 4] = 0.0
    d[2, R // 8:R // 2] = 0.0
    d[1, R // 2:R // 2 + 64] = 0.0
    o[0, :64] = 0.0  # inside the x slab
    want = np.asarray(jax_tail_box_needy(t.sph_tail_box, tuple(map(jnp.asarray, o)),
                                         tuple(map(jnp.asarray, d)), 1e-3))
    got = cs.tail_box_needy(t.sph_tail_box, tuple(torch.from_numpy(x.copy()) for x in o),
                            tuple(torch.from_numpy(x.copy()) for x in d), T_MIN).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < R


def test_n_live_makes_the_later_lanes_miss():
    t = build_scene("final_scene", 16, 16).tables
    o, d, _ = _box_rays(4, t.sph_tail_box, 1.0)
    P = tuple(torch.from_numpy(x.copy()) for x in o), tuple(torch.from_numpy(x.copy())
                                                           for x in d)
    tm = torch.zeros(R)
    full = K.sphere_hit_attrs(t, *P, tm, rows=t.sph_tail_rows)
    part = K.sphere_hit_attrs(t, *P, tm, rows=t.sph_tail_rows,
                              n_live=torch.tensor([1000], dtype=torch.int32))
    assert torch.equal(part[0][:1000], full[0][:1000])
    assert bool((part[0][1000:] == BIG).all()) and bool((part[2][1000:] == 0).all())
    assert bool((part[1][0][1000:] == 1).all()) and int((full[0][1000:] < BIG).sum()) > 100


def test_final_scene_render_matches_art_tpu():
    nx, ny, seed = 24, 24, 1984
    jscene, _, scene = _carried("final_scene", nx, ny)
    jfb, jst = jax_render_scene(jscene, JaxConfig(nx=nx, ny=ny, spp=4, seed=seed))
    fb, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=4, seed=seed), device="cpu",
                          uniforms=_threefry(seed, jst["n_slots"], n_uniform_cols(scene.tables)),
                          short_path=False)
    for k in ("tile_pixels", "spp_chunk", "n_slots"):
        assert st[k] == jst[k], k
    assert st["iterations"] == jst["iterations"]
    assert abs(st["rays"] - jst["rays"]) <= 1e-2 * jst["rays"]
    assert (np.abs(fb - jfb).max(axis=-1) <= 1e-3).mean() >= 0.98
    assert np.isfinite(fb).all() and (fb >= 0).all() and fb.max() > 0


def test_original_scene_render_matches_art_tpu():
    nx, ny, seed = 16, 16, 1984
    jscene, _, scene = _carried("original_scene", nx, ny)
    jfb, jst = jax_render_scene(jscene, JaxConfig(nx=nx, ny=ny, spp=4, seed=seed))
    fb, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=4, seed=seed), device="cpu",
                          uniforms=_threefry(seed, jst["n_slots"], n_uniform_cols(scene.tables)),
                          short_path=False)
    assert st["iterations"] == jst["iterations"]
    assert abs(st["rays"] - jst["rays"]) <= 2e-2 * jst["rays"]
    assert (np.abs(fb - jfb).max(axis=-1) <= 1e-3).mean() >= 0.85
    assert np.isfinite(fb).all() and (fb >= 0).all() and fb.max() > 0


def test_original_scene_lockstep():
    """Every iteration of an original_scene render (module docstring)."""
    nx = ny = 16
    spp = 4
    jscene, _, scene = _carried("original_scene", nx, ny)
    t = dataclasses.replace(scene.tables, box_grid_kx=0)  # art_tpu's CPU route
    P = nx * ny
    R_ = plan_batches(P, spp, max(t.n_spheres, t.n_quads, t.n_boxes), RenderConfig(),
                      "cpu")[2]
    ncols = n_uniform_cols(t)
    uniforms = _threefry(1984, R_, ncols)
    pool = rk.new_pool(R_, "cpu")
    q, hist = torch.zeros(2, dtype=torch.int64), torch.zeros(64, dtype=torch.int64)
    fb, lost = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    scal = rk.RefillScal(spp, P, 0, P, nx, ny)
    J = jnp.asarray
    for it in range(64):
        block = torch.from_numpy(uniforms(0, 0, it).copy())
        u_ball, u_choice, u_media = rk.fused_refill(pool, scene.camera, q, it % 2, hist, it,
                                                    scal, block=block, ncols=ncols)
        if not bool(pool["act"].any()):
            break
        before = {k: v.numpy().copy() for k, v in pool.items()}
        o = (pool["ox"], pool["oy"], pool["oz"])
        d = (pool["dx"], pool["dy"], pool["dz"])
        surf = closest_surface_p(t, o, d, pool["tm"], T_MIN)
        rec = apply_media_p(t, o, d, T_MIN, surf, u_media, time=pool["tm"])
        planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u_ball, u_choice)))
        planes.update(zip(REC_SP, eval_special_p(t, t.shade_consts[1], rec.mat, rec.u,
                                                 rec.v, rec.p, valid=rec.hit & pool["act"])))
        shade_flush(pool, rec.hit, planes, scene.background, fb, lost, max_depth=50,
                    gradient=False, consts=t.shade_rows)

        b = {k: J(v) for k, v in before.items()}
        o2, d2, thr2, rad2, surv = jax_bounce_step(
            jscene.tables, (b["ox"], b["oy"], b["oz"]), (b["dx"], b["dy"], b["dz"]),
            b["tm"], (b["t0"], b["t1"], b["t2"]), (b["r0"], b["r1"], b["r2"]),
            b["act"], tuple(J(u.numpy()) for u in u_ball), J(u_choice.numpy()),
            J(torch.stack(u_media).numpy()), J(np.asarray(scene.background, np.float32)),
            False)
        still = np.asarray(surv) & (before["bounce"] + before["act"] < 50)
        agree = pool["act"].numpy() == still
        assert np.sum(~agree) <= 2, it
        want = dict(zip(STATE_F, map(np.asarray, (*o2, *d2, *thr2, *rad2))))
        for n in STATE_F:
            np.testing.assert_allclose(pool[n].numpy()[agree], want[n][agree],
                                       rtol=2e-4, atol=2e-5, err_msg=f"{n} it={it}")
    assert not bool(pool["act"].any()) and int(lost) == 0
    assert int(q[it % 2]) == P * spp
