"""The order of the H100 designs of K10 and K12, held on the CPU on
numpy-seeded inputs against their unchanged plain twins.

* (a) A model of K10's culled walk (``csrc/box_grid.cu box_grid_kernel``):
  per ray the twin's inverses and slab terms, the y window of the floor and
  the table's lowest and highest tops, the columns whose x slab can meet
  that window (and the z window of the first and last rows) as one interval,
  and in each column the rows whose z slab can meet it, each interval's first
  index settled from a float estimate by exact steps of the per-cell
  expressions and its last where the walk's exact test first fails; those cells
  visited in row-major order with the twin's float32 operations into a
  strict-``<`` carry.  It equals ``box_grid_hit_attrs_plain`` bit for bit
  on the 40x40 box field (``chip_smoke._box_field``), on final_scene's
  20x20 table with ``box_grid_cells`` unset and on a field with empty
  cells, for camera rays, bounce rays, rays that start inside a box, rays
  from above pointing up and rays with zero direction components, at
  t_min 1e-3 and 0.25.  Each settled interval is the set of indices whose
  conditions hold (they are monotone in the index).
* (b) A mutant whose row interval is one row short at either end parts from
  the twin on those rays.
* (c) The model's tests a ray (mean and warp max) are ``chip_smoke._grid_tests``'.
* (d) On a CPU seam pool whose samples of a pixel sit side by side (plain
  ``seam_step``s), ``sp_kernel.flush_warp_p`` over K12's flush lanes (dead,
  inside the tile, radiance not zero) equals ``flush_dead_plain``'s
  framebuffer within 1e-6 relative, exactly on the pixels whose warps hold
  one death of them each, and ``lost`` is the same.
* (e) K12's new order (the flush, the zero radiance written only on the dead
  slots the refill does not take, then K1's twin) equals
  ``fused_refill_flush_plain`` bit for bit."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN, safe_dir
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import (box_grid_attributes_p, box_grid_candidates_p,
                                         grid_cells, miss_defaults)
from art_tpu_torch.ops.shade_kernel import flush_plain
from art_tpu_torch.ops.sp_kernel import flush_census, flush_warp_p
from art_tpu_torch.render.integrator import n_uniform_cols, seam_step
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.scene.builder import SceneBuilder

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
R = 2048


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


# ---- K10's culled walk ---------------------------------------------------------

def _slab(e0, s, k):
    """The slab (lo, hi) of index ``k`` (an int, or an int64 tensor of one a
    ray) as the twin forms it: ``ta = e0 + f32(k) s``, ``tb = ta + s``."""
    fk = k.to(torch.float32) if isinstance(k, torch.Tensor) else float(k)
    ta = e0 + fk * s
    tb = ta + s
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def _settle(e0, s, n, a, b):
    """The indices k in [0, n) whose slab has hi > a and lo < b, one
    interval a ray (first, last), as ``box_grid.cu SlabWalk`` finds it.
    With s >= 0 both ends of the slab rise with k, so hi > a ("rises") holds
    from some index on and lo < b ("falls") up to some index; with s < 0 lo <
    b from some index on and hi > a up to some index.  ``first`` comes from a
    float estimate, then exact steps until "rises" holds there and fails one
    index before; the walk from it ends where "falls" first fails."""
    up = s >= 0
    e = (torch.where(up, a, b) - e0) * (1.0 / s)
    e = torch.nan_to_num(e, nan=-1.0).clamp(-1.0, n + 1.0)
    first = torch.floor(e).to(torch.int64).clamp(0, n)

    def rises(k):
        lo, hi = _slab(e0, s, k.clamp(0, n - 1))
        return torch.where(up, hi > a, lo < b)

    def falls(k):
        lo, hi = _slab(e0, s, k.clamp(0, n - 1))
        return torch.where(up, lo < b, hi > a)

    while bool((m := (first < n) & ~rises(first)).any()):
        first = first + m
    while bool((m := (first > 0) & rises(first - 1)).any()):
        first = first - m.to(torch.int64)
    last = first - 1
    while bool((m := (last + 1 < n) & falls(last + 1)).any()):
        last = last + m
    return first, last


def _k10_model(tables, o, d, t_min=T_MIN, short=None):
    """K10's culled walk (module note) on CPU tensors: (t, normal, u, v,
    mat), the (R,) tests each ray makes and the settled intervals
    ``(cols, rows)`` (rows (R, kx, 2): each column's, for every column).
    ``short`` ("first" or "last") cuts each row interval by one row at that
    end: the mutant."""
    kx, kz, w = tables.box_grid_kx, tables.box_grid_kz, tables.box_grid_w
    heights = tables.box_grid_rows[:, 0::2]
    h_lo, h_hi = heights.min(), heights.max()
    inv = tuple(1.0 / safe_dir(c) for c in d)
    ex0, sxv = (tables.box_grid_x0 - o[0]) * inv[0], w * inv[0]
    ez0, szv = (tables.box_grid_z0 - o[2]) * inv[2], w * inv[2]
    ty0p = (tables.box_grid_y0 - o[1]) * inv[1]
    ta, tb = (h_lo - o[1]) * inv[1], (h_hi - o[1]) * inv[1]
    y_lo = torch.minimum(ty0p, torch.minimum(ta, tb))
    y_hi = torch.maximum(ty0p, torch.maximum(ta, tb))
    z0_lo, z0_hi = _slab(ez0, szv, 0)
    zn_lo, zn_hi = _slab(ez0, szv, kz - 1)
    low = y_lo.clamp_min(t_min)
    c_first, c_last = _settle(ex0, sxv, kx, torch.maximum(low, torch.minimum(z0_lo, zn_lo)),
                              torch.minimum(y_hi, torch.maximum(z0_hi, zn_hi)))
    c_last = torch.where(y_hi > t_min, c_last, c_first - 1)  # else no cell can hit
    lanes = o[0].shape[0]
    best = torch.full((lanes,), BIG)
    idx = torch.full((lanes,), -1, dtype=torch.int64)
    tests = torch.zeros(lanes, dtype=torch.int64)
    rows = torch.zeros(lanes, kx, 2, dtype=torch.int64)
    for ix in range(kx):
        xlo, xhi = _slab(ex0, sxv, ix)
        r_first, r_last = _settle(ez0, szv, kz, torch.maximum(low, xlo),
                                  torch.minimum(y_hi, xhi))
        rows[:, ix, 0], rows[:, ix, 1] = r_first, r_last
        if short == "first":
            r_first = r_first + 1
        elif short == "last":
            r_last = r_last - 1
        col = (c_first <= ix) & (ix <= c_last)
        for iz in range(kz):
            m = col & (r_first <= iz) & (iz <= r_last)
            if not bool(m.any()):
                continue
            zlo, zhi = _slab(ez0, szv, iz)
            ty1 = (heights[ix, iz] - o[1]) * inv[1]
            ylo, yhi = torch.minimum(ty0p, ty1), torch.maximum(ty0p, ty1)
            t0 = torch.maximum(torch.maximum(xlo, zlo), ylo)
            t1 = torch.minimum(torch.minimum(xhi, zhi), yhi)
            through = t0 < t1
            t = torch.where(through & (t0 > t_min), t0,
                            torch.where(through & (t1 > t_min), t1, BIG))
            win = m & (t < best)
            best = torch.where(win, t, best)
            idx = torch.where(win, ix * kz + iz, idx)
            tests += m
    cells = grid_cells(tables, False)
    normal, u, v, mat = box_grid_attributes_p(tables, cells, o, d, best, idx.clamp_min(0))
    normal, (u, v, mat) = miss_defaults(best < BIG, normal, (u, v, mat))
    return (best, normal, u, v, mat), tests, ((c_first, c_last), rows)


def _camera_rays(scene, seed, n=R):
    from art_tpu_torch.core.camera import rays_from_uniforms_p

    u = torch.from_numpy(np.random.default_rng(seed).random((5, n), dtype=np.float32))
    o, d, _ = rays_from_uniforms_p(scene.camera, u[0], u[1], u[2], u[3], u[4])
    return tuple(c.contiguous() for c in o), tuple(c.contiguous() for c in d)


def _field_rays(scene, kind, seed, n=R):
    """``n`` rays of ``kind`` over ``scene``'s box field: "camera" (its
    camera's), "bounce" (from the camera rays' hits on the field, diffuse
    about the normal, a third of them grazing), "inside" (from points inside
    the boxes, any direction), "up" (from above the highest top, pointing
    up or level), "edges" (aimed at the edges between neighbouring cells'
    tops, where equal heights make exact ties) or "zero" (camera rays
    diffused off their hits, with one or two direction components exactly
    0)."""
    t = scene.tables
    rng = np.random.default_rng(seed)
    if kind in ("camera", "bounce", "zero"):
        o, d = _camera_rays(scene, seed, n)
        if kind != "camera":
            hit = K.box_grid_hit_attrs_plain(t, o, d)
            th, nrm = hit[0], hit[1]
            ok = th < BIG
            p = tuple(torch.where(ok, oc + th * dc, oc) for oc, dc in zip(o, d))
            r = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
            r = r / r.norm(dim=0, keepdim=True)
            nn = torch.stack(nrm)
            dn = r + nn * torch.from_numpy(np.where(rng.random(n) < 1 / 3, 0.05, 1.0)
                                           .astype(np.float32))
            dn = torch.where(ok[None], dn, torch.stack(d))
            o, d = p, tuple(dn[k].contiguous() for k in range(3))
        if kind == "zero":
            dn = torch.stack(d).clone()
            axis = torch.from_numpy(rng.integers(0, 3, n))
            pick = torch.from_numpy(rng.random(n) < 0.5)
            dn[axis[pick], torch.nonzero(pick)[:, 0]] = 0.0
            two = torch.from_numpy(rng.random(n) < 0.1)
            dn[(axis[two] + 1) % 3, torch.nonzero(two)[:, 0]] = 0.0
            d = tuple(dn[k].contiguous() for k in range(3))
        return o, d
    kx, kz, w = t.box_grid_kx, t.box_grid_kz, t.box_grid_w
    heights = t.box_grid_rows[:, 0::2].numpy()
    if kind == "inside":
        ix, iz = rng.integers(0, kx, n), rng.integers(0, kz, n)
        f = rng.random((3, n))
        y0 = t.box_grid_y0
        o = np.stack([t.box_grid_x0 + (ix + f[0]) * w,
                      y0 + f[1] * (heights[ix, iz] - y0),
                      t.box_grid_z0 + (iz + f[2]) * w])
        d = rng.normal(size=(3, n))
    elif kind == "edges":  # aimed at top-face edges between neighbours
        ix, iz = rng.integers(1, kx, n), rng.integers(0, kz, n)
        tx = t.box_grid_x0 + ix.astype(np.float32) * np.float32(w)
        tz = t.box_grid_z0 + (iz + rng.random(n)) * w
        ty = np.maximum(heights[ix, iz], heights[ix - 1, iz])
        o = np.stack([tx + rng.normal(scale=20.0, size=n), ty + 10.0 + 30.0 * rng.random(n),
                      tz + rng.normal(scale=20.0, size=n)])
        d = np.stack([tx, ty, tz]) - o
    else:  # "up"
        o = np.stack([t.box_grid_x0 + rng.random(n) * kx * w,
                      heights.max() + rng.random(n) * 5.0 * np.where(rng.random(n) < 0.2, 0, 1),
                      t.box_grid_z0 + rng.random(n) * kz * w])
        d = rng.normal(size=(3, n))
        d[1] = np.abs(d[1]) * np.where(rng.random(n) < 0.2, 0.0, 1.0)
    return (tuple(torch.from_numpy(c.astype(np.float32)) for c in o),
            tuple(torch.from_numpy(c.astype(np.float32)) for c in d))


def _holes():
    """A 12x12 lattice off the origin (y0 = -2, cell width 3.5) with about
    half its cells empty and heights from a few values, so neighbours tie."""
    rng = np.random.default_rng(17)
    mats = [PM.Lambertian((0.7, 0.6, 0.5)), PM.Lambertian((0.3, 0.5, 0.7))]
    b = SceneBuilder().set_name("holes")
    for ix in range(12):
        for iz in range(12):
            if rng.random() < 0.45 and not (ix, iz) in ((0, 0), (11, 11)):
                continue
            x, z = -20.0 + 3.5 * ix, 7.0 + 3.5 * iz
            h = -2.0 + float(rng.choice([1.5, 3.0, 4.5]))
            b.add(PO.Box((x, -2.0, z), (x + 3.5, h, z + 3.5), mats[(ix * 3 + iz) % 2]))
    b.set_camera(lookfrom=(0, 30, -25), lookat=(0, 0, 28), vup=(0, 1, 0), vfov_degrees=60.0,
                 aspect=1.0, time0=0.0, time1=1.0)
    b.set_background(gradient=True)
    return b.compile()


@pytest.fixture(scope="module")
def fields():
    def no_cell_list(scene):  # K10's table alone, as past K9's gate
        return dataclasses.replace(scene, tables=dataclasses.replace(
            scene.tables, box_grid_cells=None, box_grid_cell_rows=None))

    return {"box field": SMOKE._box_field(16, 16),
            "final_scene": no_cell_list(build_scene("final_scene", 16, 16)),
            "holes": no_cell_list(_holes())}


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _flat(r):
    return (r[0], *r[1], r[2], r[3], r[4])


def _differ(got, want):
    """(R,) lanes where any output differs in bits."""
    out = torch.zeros(got[0].shape[0], dtype=torch.bool)
    for a, b in zip(_flat(got), _flat(want)):
        out |= _bits(a) != _bits(b)
    return out


def _ties(t, o, d, best):
    """Lanes whose closest cell ties with another: the twin's t again with
    the winner's cell emptied (h = y0) is the same."""
    cells = grid_cells(t, False).clone()
    _, idx = box_grid_candidates_p(t, cells, o, d, T_MIN)
    hit = idx >= 0
    out = torch.zeros_like(hit)
    for k in torch.unique(idx[hit]).tolist():
        lanes = hit & (idx == k)
        emptied = cells.clone()
        emptied[k, 2] = t.box_grid_y0
        again, _ = box_grid_candidates_p(t, emptied, tuple(c[lanes] for c in o),
                                         tuple(c[lanes] for c in d), T_MIN)
        out[lanes] = again == best[lanes]
    return out


KINDS = ("camera", "bounce", "inside", "up", "edges", "zero")
K10_CASES = [(f, k, tm) for f in ("box field", "final_scene", "holes") for k in KINDS
             for tm in (T_MIN, 0.25)]


@pytest.mark.parametrize("field,kind,t_min", K10_CASES)
def test_k10_culled_walk_equals_the_twin(fields, field, kind, t_min):
    scene = fields[field]
    t = scene.tables
    assert t.box_grid_kx and t.box_grid_cell_rows is None
    o, d = _field_rays(scene, kind, 11 + KINDS.index(kind))
    want = K.box_grid_hit_attrs_plain(t, o, d, t_min)
    got, tests, _ = _k10_model(t, o, d, t_min)
    assert not bool(_differ(got, want).any())
    hits = int((want[0] < BIG).sum())
    if kind != "up":
        assert hits > R // 20
    if kind == "inside" and t_min == T_MIN:
        assert int(_ties(t, o, d, want[0]).sum()) > 0
    kx, kz = t.box_grid_kx, t.box_grid_kz
    assert torch.equal(tests, SMOKE._grid_tests(t, o, d, t_min))
    assert int(tests.sum()) < o[0].shape[0] * kx * kz // 8
    if kind == "up":  # from above the tops, up or level: every y window <= 0
        assert int(tests.sum()) == 0


@pytest.mark.parametrize("field,kind", [(f, k) for f in ("box field", "holes")
                                        for k in ("camera", "bounce", "zero")])
def test_k10_intervals_are_the_conditions(fields, field, kind):
    """The settled ends: the column interval and each column's row interval
    are exactly where the conditions hold (monotone in the index)."""
    t = fields[field].tables
    o, d = _field_rays(fields[field], kind, 29)
    _, _, ((c_first, c_last), rows) = _k10_model(t, o, d)
    cols, row_ok = SMOKE._grid_conditions(t, o, d)
    kx, kz = t.box_grid_kx, t.box_grid_kz
    ix, iz = torch.arange(kx)[None], torch.arange(kz)[None, None]
    assert torch.equal((c_first[:, None] <= ix) & (ix <= c_last[:, None]), cols)
    assert torch.equal((rows[:, :, :1] <= iz) & (iz <= rows[:, :, 1:]), row_ok)


@pytest.mark.parametrize("field,short", [(f, s) for f in ("box field", "final_scene", "holes")
                                         for s in ("first", "last")])
def test_k10_mutant_one_row_short_fails(fields, field, short):
    """A row interval one row short at either end loses hits the twin makes."""
    scene = fields[field]
    t = scene.tables
    for kind in ("camera", "bounce", "zero"):
        o, d = _field_rays(scene, kind, 11 + KINDS.index(kind))
        want = K.box_grid_hit_attrs_plain(t, o, d)
        got, _, _ = _k10_model(t, o, d, short=short)
        if bool(_differ(got, want).any()):
            return
    raise AssertionError(f"the mutant short at its {short} row equals the twin")


@pytest.mark.parametrize("field", ["box field", "final_scene"])
def test_k10_tests_are_chip_smokes(fields, field):
    """The model's tests a ray, mean and warp max, as chip_smoke reports
    them for K10, and far fewer than the table's cells a ray."""
    scene = fields[field]
    t = scene.tables
    o, d = _field_rays(scene, "camera", 41)
    ob, db = _field_rays(scene, "bounce", 42)
    o = tuple(torch.cat([a, b]) for a, b in zip(o, ob))
    d = tuple(torch.cat([a, b]) for a, b in zip(d, db))
    _, tests, _ = _k10_model(t, o, d)
    stats = SMOKE._grid_test_stats(tests)
    assert stats == SMOKE._grid_test_stats(SMOKE._grid_tests(t, o, d))
    n = tests.shape[0] // 32 * 32
    assert stats["warp_max_mean"] == float(tests[:n].reshape(-1, 32).max(dim=1).values
                                           .double().mean())
    assert stats["mean"] < 20 and stats["warp_max_mean"] < 64


# ---- K12's flush and its order ---------------------------------------------

def _seam_pool(iters=3, spp=8, R=4096):
    """three_spheres 32x24 @ ``spp`` on the CPU, ``iters`` plain seam
    iterations in: its dead slots hold the radiance of the deaths K12
    flushes next; the refill handed the queue out in sample-major order, so
    the samples of a pixel sit side by side.  (scene, pool, q, fb, scal)."""
    scene = build_scene("three_spheres", 32, 24)
    tables, P = scene.tables, 32 * 24
    scal = rk.RefillScal(spp, P, 0, P, 32, 24)
    pool = rk.new_pool(R, "cpu")
    q = torch.zeros(2, dtype=torch.int64)
    hist = torch.zeros(iters + 2, dtype=torch.int64)
    fb = torch.zeros((P, 3))
    lost = torch.zeros(1, dtype=torch.int32)
    for it in range(iters):
        seam_step(pool, scene.camera, q, it % 2, hist, it, scal, tables, scene.background, fb,
                  lost, key=(5, 0, 0), ncols=n_uniform_cols(tables), max_depth=50,
                  gradient=scene.gradient_bg)
    return scene, pool, q, fb, scal


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


RAD = ("r0", "r1", "r2")


def test_k12_flush_warp_matches_the_twin():
    """flush_warp over K12's flush lanes against flush_dead_plain."""
    _, pool, _, fb0, _ = _seam_pool()
    P = fb0.shape[0]
    dead = ~pool["act"]
    out = torch.nonzero(dead)[:6, 0]  # a few deaths outside the tile: lost
    pool["pix"][out] = torch.tensor([-1, P, P + 7, -(1 << 30), 1 << 30, P + 1],
                                    dtype=torch.int32)
    rad = tuple(pool[n] for n in RAD)
    lit = dead & ((rad[0] != 0) | (rad[1] != 0) | (rad[2] != 0))
    inside = (pool["pix"] >= 0) & (pool["pix"] < P)
    flushed = lit & inside
    deaths, adds, shared = flush_census(pool["pix"], flushed, P)
    assert deaths > 500 and shared > deaths // 2 and adds < deaths

    want, want_fb, want_lost = _clone(pool), fb0.clone(), torch.zeros(1, dtype=torch.int32)
    rk.flush_dead_plain(want, want_fb, want_lost)
    got_fb, unused = fb0.clone(), torch.zeros(1, dtype=torch.int32)
    flush_warp_p(pool["pix"], flushed, rad, got_fb, unused)
    got_lost = (dead & ~inside).sum().to(torch.int32)  # every dead slot outside
    assert int(got_lost) == int(want_lost) == 6
    rel = ((got_fb - want_fb).abs() / (want_fb.abs() + 1e-6)).max()
    assert float(rel) <= 1e-6
    # exact where each warp holds at most one death of the pixel
    n = pool["pix"].shape[0]
    key = pool["pix"].reshape(-1, 32)
    fl = flushed.reshape(-1, 32)
    same = (key[:, :, None] == key[:, None, :]) & fl[:, :, None] & fl[:, None, :]
    many = torch.unique(key[fl & (same.sum(dim=-1) > 1)])
    touched = torch.unique(pool["pix"][flushed])
    single = touched[~torch.isin(touched, many)]
    assert n == key.numel() and single.numel() > 0 and many.numel() > 0
    assert torch.equal(_bits(got_fb[single]), _bits(want_fb[single]))
    assert not bool((got_fb[many] != want_fb[many]).all())


def _new_order(pool, cam, q, parity, hist, it, scal, fb, lost, **src):
    """K12 as the kernel orders it: the flush, the zero radiance written on
    the dead slots whose radiance is not +0 and that the refill does not
    take (rank past the queue's end), then K1's twin (whose refill writes
    the taken slots' zero)."""
    dead = ~pool["act"]
    flush_plain(pool["pix"], dead, tuple(pool[n] for n in RAD), fb, lost)
    dead_i = dead.to(torch.int64)
    rank = torch.cumsum(dead_i, 0) - dead_i
    take = dead & (q[parity] + rank < scal.P * scal.spp)
    bits = pool["r0"].view(torch.int32) | pool["r1"].view(torch.int32) | pool["r2"].view(
        torch.int32)
    for n in RAD:
        pool[n].masked_fill_(dead & ~take & (bits != 0), 0.0)
    return rk.fused_refill_plain(pool, cam, q, parity, hist, it, scal, **src)


@pytest.mark.parametrize("mode", ["injected", "philox"])
@pytest.mark.parametrize("room", [0, 300, 1 << 20])
def test_k12_order_equals_the_twin(mode, room):
    """Zeroing only the dead slots the refill leaves, then K1's twin, equals
    fused_refill_flush_plain bit for bit: with no queue left, a few hundred
    elements left (some dead slots taken, the rest left dead) and plenty."""
    scene, base, q0, fb0, scal = _seam_pool()
    dead = ~base["act"]
    minus = torch.nonzero(dead)[10:20, 0]  # -0.0 radiance: zeroed to +0 all the same
    for n in RAD:
        base[n][minus] = -0.0
    ncols = n_uniform_cols(scene.tables)
    rng = np.random.default_rng(3)
    src = (dict(block=torch.from_numpy(rng.random((ncols, base["act"].shape[0]),
                                                  dtype=np.float32)))
           if mode == "injected" else dict(key=(1984, 3, 1)))
    n_q = scal.P * scal.spp
    start = max(0, n_q - room)
    runs = []
    for fn in (_new_order, rk.fused_refill_flush_plain):
        pool, fb = _clone(base), fb0.clone()
        q = torch.tensor([start, 0], dtype=torch.int64)
        hist = torch.zeros(8, dtype=torch.int64)
        lost = torch.zeros(1, dtype=torch.int32)
        u = fn(pool, scene.camera, q, 0, hist, 4, scal, fb, lost, ncols=ncols, **src)
        runs.append((pool, fb, q, hist, lost, u))
    (kp, kfb, kq, kh, kl, ku), (pp, pfb, pq, ph, pl, pu) = runs
    for n in kp:
        assert torch.equal(_bits(kp[n]), _bits(pp[n])), n
    assert torch.equal(_bits(kfb), _bits(pfb))
    assert torch.equal(kq, pq) and torch.equal(kh, ph) and torch.equal(kl, pl)
    for a, b in zip(ku[0] + (ku[1],) + ku[2], pu[0] + (pu[1],) + pu[2]):
        assert torch.equal(_bits(a), _bits(b))
    taken = int(kq[1] - kq[0])
    assert taken == min(int(dead.sum()), n_q - start)
    if 0 < room < int(dead.sum()):
        assert 0 < taken < int(dead.sum())
