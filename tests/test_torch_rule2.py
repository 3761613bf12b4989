"""The arithmetic that K2's and K9's H100 designs (``csrc/sphere_hit.cu``,
``csrc/box_grid.cu``) rest on, held on the CPU against their plain twins,
bit for bit, on numpy-seeded rays.

* (a) K2 gives a static row (v = 0) its own branch with c as the centre.
  ``sphere_candidates_p`` with each static row's centre taken as c equals
  the twin's (t, row index) bit for bit on bouncing_spheres' and
  final_scene's tables and on a table of signed-zero centres, on rays with
  shutter times 0, 1 and between, at t_min = T_MIN and 0.25.
* (b) K9 skips a warp whose every lane passes ``box_grid_skip_p`` (the ray
  starts at or above the floor and every top, does not point down, and
  t_min >= 0).  Every lane it marks is a miss of
  ``box_grid_cells_hit_attrs_plain``: on random rays, on final_scene camera
  rays from art_tpu's camera, on edge rays (oy equal to a top, dy = +-0 and
  +-1e-13, where ``safe_inv`` clamps) and on a final_scene pool four staged
  iterations in, at t_min = 0, T_MIN and 0.25; it marks nothing at
  t_min < 0.  The test prints the shares it marks.
* (c) K9 computes the x slab once a column and the z slab once a row and
  gathers them by a cell's ix and iz; over final_scene's 400 cells that
  equals the per-cell slab of ``box_grid_candidates_p`` bit for bit, and
  every cell's ix and iz are integers in [0, kx) and [0, kz) (the kernel's
  slab indices).
"""

import functools

import numpy as np
import pytest
import torch

from art_tpu.core.camera import rays_from_uniforms_p
from art_tpu.models import build_scene as jax_build_scene
from art_tpu_torch.core.vecmath import BIG, T_MIN, safe_dir, sqrt
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import sphere_candidates_p
from art_tpu_torch.render.integrator import n_uniform_cols, staged_step
from art_tpu_torch.scene.tables import sphere_rows

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 4096


@functools.lru_cache(maxsize=None)
def _tables(name):
    return build_scene(name, 32, 32).tables


def _static_as_c(rows, o, d, tm, t_min):
    """``sphere_candidates_p`` with a static row's centre taken as c (K2's
    static branch), every other operation as the twin's."""
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a = dx * dx + dy * dy + dz * dz
    static = (rows[:, 3:6] == 0.0).all(dim=1)[None, :]
    tcol = tm[:, None]
    cx, cy, cz = (torch.where(static, rows[None, :, k],
                              rows[None, :, k] + tcol * rows[None, :, 3 + k]) for k in range(3))
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    csq = ocx * ocx + ocy * ocy + ocz * ocz - rows[None, :, 8]
    disc = b * b - a * csq
    s = sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-b - s) * inv_a
    t2 = (-b + s) * inv_a
    valid = disc > 0.0
    t = torch.where(valid & (t1 > t_min), t1,
                    torch.where(valid & (t2 > t_min), t2, torch.full_like(t1, BIG)))
    t_best, idx = torch.min(t, dim=1)
    return t_best, idx.to(torch.int32)


def _signed_zero_rows():
    """Static spheres with +-0 centre components (and two moving ones)."""
    rng = np.random.default_rng(7)
    n = 64
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    c[rng.random((n, 3)) < 0.4] = 0.0
    c[rng.random((n, 3)) < 0.3] = -0.0
    v = np.zeros((n, 3), np.float32)
    v[:2] = (0.5, -0.0, 0.25)
    v[2] = (-0.0, 0.0, -0.0)  # a zero velocity with negative zeros: static
    r = rng.uniform(0.2, 1.0, n).astype(np.float32)
    r[::5] *= -1  # hollow shells
    return sphere_rows(torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(r),
                       torch.from_numpy(np.arange(n) % 4))


def _sphere_rays(rows, seed):
    """Rays from inside and around the table's spheres, a third of them at
    tm = 0, a third at tm = 1; some origins with +-0 components."""
    rng = np.random.default_rng(seed)
    c = rows[:, :3].numpy()
    lo, hi = np.percentile(c, 5, axis=0), np.percentile(c, 95, axis=0)
    span = np.maximum(hi - lo, 1.0)
    o = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (R, 3)).astype(np.float32)
    o[rng.random((R, 3)) < 0.05] = 0.0
    o[rng.random((R, 3)) < 0.05] = -0.0
    d = rng.normal(size=(R, 3)).astype(np.float32)
    tm = rng.random(R).astype(np.float32)
    tm[: R // 3] = 0.0
    tm[R // 3: 2 * R // 3] = 1.0
    ot = tuple(torch.from_numpy(o[:, k].copy()) for k in range(3))
    dt = tuple(torch.from_numpy(d[:, k].copy()) for k in range(3))
    return ot, dt, torch.from_numpy(tm)


@pytest.mark.parametrize("t_min", [T_MIN, 0.25])
@pytest.mark.parametrize("table", ["bouncing_spheres", "final_scene", "signed zeros"])
def test_static_rows_take_c_as_their_centre(table, t_min):
    """(a): K2's static branch keeps the twin's t and winner bit for bit."""
    rows = _signed_zero_rows() if table == "signed zeros" else _tables(table).sph_rows
    o, d, tm = _sphere_rays(rows, 11)
    t, idx = sphere_candidates_p(rows, o, d, tm, t_min)
    t_c, idx_c = _static_as_c(rows, o, d, tm, t_min)
    hit = t < BIG
    assert hit.sum() > R // 10 and (~hit).any()
    assert torch.equal(t.view(torch.int32), t_c.view(torch.int32))
    assert torch.equal(idx, idx_c)
    static = int((rows[:, 3:6] == 0.0).all(dim=1).sum())
    assert 0 < static  # the branch is exercised (final_scene: 1005 of 1006 rows)


def _grid():
    return _tables("final_scene")


def _random_rays(seed):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-1100, 1100, R), rng.uniform(-50, 300, R),
                  rng.uniform(-1100, 1100, R)]).astype(np.float32)
    d = rng.uniform(-1, 1, (3, R)).astype(np.float32)
    return tuple(map(torch.from_numpy, o)), tuple(map(torch.from_numpy, d))


def _camera_rays(seed):
    """final_scene camera rays from art_tpu's camera (R jittered pixels)."""
    rng = np.random.default_rng(seed)
    cam = jax_build_scene("final_scene", 64, 64).camera
    u = rng.random((5, R), dtype=np.float32)
    o, d, _ = rays_from_uniforms_p(cam, u[0], u[1], u[2], u[3], u[4])
    return (tuple(torch.from_numpy(np.asarray(x, np.float32).copy()) for x in o),
            tuple(torch.from_numpy(np.asarray(x, np.float32).copy()) for x in d))


def _edge_rays(seed):
    """Origins on a top, on the floor and just above or below them; dy in
    {+0, -0, +1e-13, -1e-13} and random; x and z across the field."""
    t = _grid()
    rng = np.random.default_rng(seed)
    tops = t.box_grid_cell_rows[:, 2].numpy()
    oy = rng.choice(np.concatenate([tops, [t.box_grid_y0]]), R).astype(np.float32)
    oy[: R // 2] = tops.max()  # half of them on the highest top
    step = rng.choice([0.0, 1.0, -1.0], R)
    oy = np.where(step > 0, np.nextafter(oy, np.float32(np.inf)),
                  np.where(step < 0, np.nextafter(oy, np.float32(-np.inf)), oy))
    dy = rng.choice(np.array([0.0, -0.0, 1e-13, -1e-13, 0.5, -0.5], np.float32), R)
    o = np.stack([rng.uniform(-1100, 1100, R), oy, rng.uniform(-1100, 1100, R)])
    d = np.stack([rng.uniform(-1, 1, R), dy, rng.uniform(-1, 1, R)])
    d[0][rng.random(R) < 0.1] = 0.0
    return (tuple(torch.from_numpy(x.astype(np.float32)) for x in o),
            tuple(torch.from_numpy(x.astype(np.float32)) for x in d))


@functools.lru_cache(maxsize=None)
def _pool_rays():
    """A final_scene 64x64 @ 4 pool of R slots four staged iterations in,
    its dead slots refilled (the plain K1, Philox)."""
    scene = build_scene("final_scene", 64, 64)
    tables = scene.tables
    P = 64 * 64
    ncols = n_uniform_cols(tables)
    pool = rk.new_pool(R, "cpu")
    q, hist = torch.zeros(2, dtype=torch.int64), torch.zeros(64, dtype=torch.int64)
    fb, lost = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    scal = rk.RefillScal(4, P, 0, P, 64, 64)
    for it in range(4):
        staged_step(pool, scene.camera, q, it % 2, hist, it, scal, tables, scene.background,
                    fb, lost, key=(7, 0, 0), ncols=ncols, max_depth=50,
                    gradient=scene.gradient_bg)
    rk.fused_refill_plain(pool, scene.camera, q, 0, hist, 4, scal, key=(7, 0, 0), ncols=ncols)
    return (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])


_RAYS = {"random": lambda: _random_rays(3), "camera": lambda: _camera_rays(5),
         "edges": lambda: _edge_rays(9), "pool": _pool_rays}


@pytest.mark.parametrize("t_min", [0.0, T_MIN, 0.25])
@pytest.mark.parametrize("rays", list(_RAYS))
def test_box_grid_skip_marks_only_misses(rays, t_min):
    """(b): every lane ``box_grid_skip_p`` marks is a miss of K9's twin."""
    t = _grid()
    o, d = _RAYS[rays]()
    skip = K.box_grid_skip_p(t, o, d, t_min)
    hit_t = K.box_grid_cells_hit_attrs_plain(t, o, d, t_min)[0]
    warps = skip.reshape(-1, 32).all(dim=1)
    print(f"{rays}, t_min {t_min}: the skip predicate holds on {float(skip.float().mean()):.4f} "
          f"of the lanes and {float(warps.float().mean()):.4f} of the 32-lane warps; "
          f"{int((hit_t < BIG).sum())} hits of {R}")
    assert skip.any() and (hit_t < BIG).any()
    assert bool((hit_t[skip] == BIG).all())
    assert not K.box_grid_skip_p(t, o, d, -1e-3).any()


def test_hoisted_slabs_equal_the_per_cell_slabs():
    """(c): the x and z slabs once a column and row, gathered by the cells,
    equal the twin's per-cell slabs bit for bit over final_scene's cells."""
    t = _grid()
    cells = t.box_grid_cell_rows
    kx, kz = t.box_grid_kx, t.box_grid_kz
    ix, iz = cells[:, 0], cells[:, 1]
    assert torch.equal(ix, ix.round()) and torch.equal(iz, iz.round())
    assert int(ix.min()) >= 0 and int(ix.max()) < kx and int(iz.min()) >= 0
    assert int(iz.max()) < kz and cells.shape[0] == 400
    for make in (_random_rays, _camera_rays):
        o, d = make(13)
        inv = tuple(1.0 / safe_dir(c) for c in d)
        ex0, sxv = ((t.box_grid_x0 - o[0]) * inv[0])[:, None], (t.box_grid_w * inv[0])[:, None]
        ez0, szv = ((t.box_grid_z0 - o[2]) * inv[2])[:, None], (t.box_grid_w * inv[2])[:, None]
        for e0, sv, col, k in ((ex0, sxv, ix, kx), (ez0, szv, iz, kz)):
            # the twin's per cell (box_grid_candidates_p)
            ta = e0 + col[None, :] * sv
            tb = ta + sv
            lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
            # once a column (the kernel's f32(c)), gathered by the cells
            ta = e0 + torch.arange(k, dtype=torch.float32)[None, :] * sv
            tb = ta + sv
            pick = col.long()
            assert torch.equal(torch.minimum(ta, tb)[:, pick].view(torch.int32),
                               lo.view(torch.int32))
            assert torch.equal(torch.maximum(ta, tb)[:, pick].view(torch.int32),
                               hi.view(torch.int32))
    # the heights come in runs (box_grid_cells order): the y slab once a run
    h = cells[:, 2]
    runs = 1 + int((h[1:] != h[:-1]).sum())
    print(f"final_scene: {cells.shape[0]} cells in {runs} runs of one height")
    assert runs < cells.shape[0] // 4
