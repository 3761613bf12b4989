"""The arithmetic that K7's and K11's H100 designs (``csrc/perlin.cuh``
``turbulence_warp``, ``csrc/sp_step.cu`` ``flush_warp``) rest on, held on
the CPU against the plain twins on numpy-seeded inputs and on pools of
short-path renders (perlin and quads 1200x600 @ 64, 64 samples a pixel as
``plan_batches`` gives on the card, a pool of R = 8192 slots, Philox key
(7, 0, 0), as ``chip_smoke.py`` builds its rendered pools).

* (a) ``perlin.turb_shared_p`` (per warp of 32 lanes and octave: a
  gradient once a (cell, corner) when the warp's needing lanes lie in at
  most 4 cells, else per lane) equals ``turb_p`` bit for bit at depths 7, 2
  and under a random mask: on the hit points of perlin's iterations 20
  (camera rays) and 21 (their bounces), misses at o + 1e30 d included, and
  on its marble lanes alone; on random points; on misses, NaN, negative
  and integer coordinates; on warps of exactly 4 and of 5 cells.  It
  equals art_tpu's ``turb_pallas`` in interpret mode within
  ``tests/test_torch_perlin.py``'s 2e-6 (lanes with |p| < 2^30).
* (b) ``sp_kernel.flush_warp_p`` (a warp's deaths of one pixel summed
  pairwise in lane order, one add a pixel) stays within 1e-6 relative of
  ``flush_plain`` (the gate ``chip_smoke.py`` holds K11's framebuffer to)
  on quads' iteration 20 and perlin's iteration 21, and counts the same
  lost slots.
* (c) On perlin's iteration 20, at every octave at least 95% of the warps
  with a marble hit take the shared form (their hits in at most 4 cells at
  that octave and every earlier one: ``perlin.noise_census``; the test
  prints the shares).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops.perlin_kernel import turb_pallas
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import perlin
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.ops.shade_kernel import flush_plain
from art_tpu_torch.ops.sp_kernel import flush_warp_p, sp_step_plain
from art_tpu_torch.render.renderer import RenderConfig, plan_batches

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
NX, NY, SPP = 1200, 600, 64


def _bits_differ(a, b) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


@functools.lru_cache(maxsize=None)
def _render(name: str, iters: int):
    """A short-path render of ``name`` at R slots after ``iters`` iterations,
    then the refill of the next: (scene, scal, pool, q, hist)."""
    scene = build_scene(name, NX, NY)
    tile_pixels, spp_chunk, _ = plan_batches(NX * NY, SPP, 2, RenderConfig(), "cuda")
    scal = rk.RefillScal(spp_chunk, tile_pixels, 0, NX * NY, NX, NY)
    pool = rk.new_pool(R, "cpu")
    q = torch.zeros(2, dtype=torch.int64)
    hist = torch.zeros(iters + 2, dtype=torch.int64)
    fb = torch.zeros((tile_pixels, 3))
    lost = torch.zeros(1, dtype=torch.int32)
    for it in range(iters):
        sp_step_plain(pool, scene.camera, q, it % 2, hist, it, scal, scene.tables,
                      scene.background, fb, lost, key=(7, 0, 0), ncols=10, max_depth=50,
                      gradient=scene.gradient_bg)
    return scene, scal, pool, q, hist


@functools.lru_cache(maxsize=None)
def _perlin_hits(it: int):
    """perlin's iteration ``it``: the hit points of every slot after its
    refill (p, as the staged path feeds K7) and its live marble hits (K11's
    turbulence lanes)."""
    scene, scal, pool, q, hist = _render("perlin", it)
    pool = {k: v.clone() for k, v in pool.items()}
    rk.fused_refill_plain(pool, scene.camera, q.clone(), it % 2, hist.clone(), it, scal,
                          key=(7, 0, 0), ncols=10)
    rec = closest_surface_p(scene.tables, (pool["ox"], pool["oy"], pool["oz"]),
                            (pool["dx"], pool["dy"], pool["dz"]), pool["tm"], T_MIN,
                            plain=True)
    return tuple(c.contiguous() for c in rec.p), rec.hit & pool["act"]


def _special_points():
    """Misses at o + 1e30 d, NaN, negative and integer coordinates, warp by
    warp (32 lanes each)."""
    rng = np.random.default_rng(21)
    p = rng.uniform(-3.0, 3.0, (3, 32 * 8)).astype(np.float32)
    p[:, :32] = p[:, :32] + 1e30 * np.sign(rng.standard_normal((3, 32))).astype(np.float32)
    p[0, 32:48] = np.nan
    p[:, 64:96] = -np.abs(p[:, 64:96]) - 1e-3
    p[:, 96:128] = np.round(p[:, 96:128])
    p[:, 128:160] = np.float32(2.0 ** 31)
    p[:, 160:192] = -np.float32(3e9)
    p[:, 192:224] = np.float32(0.5)  # one cell
    return p


def _cell_points(n_cells: int):
    """Warps whose 32 lanes lie in exactly ``n_cells`` unit cells at octave 0."""
    rng = np.random.default_rng(n_cells)
    warps = []
    for _ in range(64):
        corners = rng.integers(-50, 50, (n_cells, 3))
        which = np.concatenate([np.arange(n_cells), rng.integers(0, n_cells, 32 - n_cells)])
        rng.shuffle(which)
        warps.append(corners[which] + rng.uniform(0.0, 1.0, (32, 3)))
    return np.concatenate(warps).T.astype(np.float32)


def _points(case):
    if case == "random":
        return tuple(torch.from_numpy(c) for c in
                     np.random.default_rng(5).uniform(-20.0, 20.0, (3, R)).astype(np.float32))
    if case == "special":
        return tuple(map(torch.from_numpy, _special_points()))
    if case in ("4 cells", "5 cells"):
        return tuple(map(torch.from_numpy, _cell_points(int(case[0]))))
    return _perlin_hits(int(case.split()[-1]))[0]


@pytest.mark.parametrize("case", ["perlin iteration 20", "perlin iteration 21", "random",
                                  "special", "4 cells", "5 cells"])
@pytest.mark.parametrize("depth,masked", [(7, False), (2, False), (7, True)])
def test_shared_gradients_bit_equal_to_turb(case, depth, masked):
    p = _points(case)
    n = p[0].shape[0]
    mask = (torch.from_numpy(np.random.default_rng(depth).integers(0, 8, n).astype(np.int32))
            if masked else None)
    want = perlin.turb_p(*p, depth, mask)
    got = perlin.turb_shared_p(*p, depth, mask)
    assert _bits_differ(got, want) == 0
    forms, _ = perlin.noise_census(*p, depth)
    if case.endswith("cells"):  # every warp in the shared form at octave 0, or none
        assert forms[0].tolist() == ([0, n // 32, 0] if case[0] == "4" else [0, 0, n // 32])


@pytest.mark.parametrize("it", [20, 21])
def test_shared_gradients_on_marble_lanes(it):
    """K11's view: only the live marble hits need a value, the other lanes
    of the warp work for them."""
    p, need = _perlin_hits(it)
    assert need.any() and not need.all()
    got = perlin.turb_shared_p(*p, 7, need=need)
    want = perlin.turb_p(*p, 7)
    assert _bits_differ(got[need], want[need]) == 0
    assert (got[~need] == 0).all()


@pytest.mark.parametrize("depth", [7, 2])
def test_shared_gradients_match_art_tpu_pallas(depth):
    p = _perlin_hits(20)[0]
    got = perlin.turb_shared_p(*p, depth).numpy()
    want = np.asarray(turb_pallas(*(jnp.asarray(c.numpy()) for c in p), depth, None,
                                  interpret=True))
    near = (torch.stack(p).abs() < 2.0 ** 30).all(dim=0).numpy()
    assert near.sum() > R // 2
    np.testing.assert_allclose(got[near], want[near], rtol=0, atol=2e-6)


@pytest.mark.parametrize("name,it", [("quads", 20), ("perlin", 21)])
def test_combined_flush_matches_flush_plain(name, it):
    scene, scal, pool, q, hist = _render(name, it)
    pool = {k: v.clone() for k, v in pool.items()}
    P = scal.P
    scratch = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    died = sp_step_plain(pool, scene.camera, q.clone(), it % 2, hist.clone(), it, scal,
                         scene.tables, scene.background, *scratch, key=(7, 0, 0), ncols=10,
                         max_depth=50, gradient=scene.gradient_bg)
    pix, rad = pool["pix"].clone(), (pool["r0"], pool["r1"], pool["r2"])
    pix[:8] = torch.tensor([-1, P, P + 3, -9, 5, 5, 5, P])  # out-of-tile deaths count as lost
    died[:8] = True
    fb_w, lost_w = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    fb_p, lost_p = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    flush_warp_p(pix, died, rad, fb_w, lost_w)
    flush_plain(pix, died, rad, fb_p, lost_p)
    rel = float(((fb_w - fb_p).abs() / (fb_p.abs() + 1e-6)).max())
    n_died, n_pix = int(died.sum()), int((fb_p != 0).any(dim=1).sum())
    print(f"{name} iteration {it}: {n_died} deaths on {n_pix} pixels, max rel {rel:.3g}")
    assert int(lost_w) == int(lost_p) == 5
    assert rel <= 1e-6
    assert n_died > R // 2 and n_pix < n_died // 8  # a flush-heavy step of few pixels


def test_warps_share_few_cells_on_perlin():
    p, need = _perlin_hits(20)
    forms, points = perlin.noise_census(*p, 7, need=need)
    warps = forms[:, 1] + forms[:, 2]
    one, few = forms[:, 0] / warps, forms[:, 1] / warps
    print("perlin iteration 20, marble hits: warps shared in 1 cell", one.tolist(),
          "shared", few.tolist(), "distinct lattice points", points.tolist(),
          f"of {8 * int(need.sum())} corners an octave")
    assert int(need.sum()) > R * 0.9
    assert (few >= 0.95).all()
    assert (points < 8 * need.sum()).all()
