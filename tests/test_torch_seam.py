"""K12 (the seam flush) and the seam route against art_tpu on the CPU.

* K12's twin (``ops/refill_kernel.fused_refill_flush_plain``) against
  art_tpu's Pallas ``fused_refill_flush`` in interpret mode, in the cases of
  tests/test_refill_kernel.py:117-181 (a mixed pool, a window at a non-zero
  base row, an all-dead pool, an exhausted queue).  The dead slots'
  radiance and the framebuffer's values are multiples of 1/16 below 4:
  exact in bf16, the TPU's flush operand (art_tpu/ops/flush_kernel.py:26-28),
  and their sums exact in float32, so the framebuffer compares bit for bit
  after art_tpu's (n_hi, 384) window is mapped back to (P, 3) rows; pixels
  outside the window (the TPU drops them) are held to numpy's sum.  Pool
  planes, take count and queue head at tests/test_torch_refill.py's bars
  (integers exact, floats to 1e-6); every dead slot's radiance zero.
* The flush-only entry (``flush_dead``): every dead slot added and zeroed,
  a pix outside [0, P) counted into ``lost``.
* Seam renders (``ART_TPU_SEAM_FLUSH``): against the default route on the
  same injected uniforms at 32x32 @ 4 on bouncing_spheres and cornell_box
  (iterations and rays equal, the framebuffer within 1e-5 relative: only the
  order of the adds differs); and against art_tpu's render on art_tpu's own
  threefry uniforms at the bars tests/test_torch_render.py holds the default
  route to (art_tpu's own seam path needs the TPU's hardware PRNG and cannot
  run here; its rotation of the flush is exact, refill_kernel.py:398-411).
* The seam route takes no short path, even when forced, as in art_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.camera import make_camera as jax_make_camera
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops.refill_kernel import fused_refill_flush as jax_fused_refill_flush
from art_tpu.ops.refill_kernel import pack_camera as jax_pack_camera
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu.render.renderer import render_scene as jax_render_scene
from art_tpu_torch.core.camera import make_camera
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops import routes
from art_tpu_torch.render import integrator
from art_tpu_torch.render.integrator import n_uniform_cols, use_short_path
from art_tpu_torch.render.renderer import RenderConfig, plan_batches, render_scene
from test_torch_refill import CAM, R
from test_torch_render import _threefry

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

N_HI = 16  # art_tpu's window rows (128 pixels each)


def _sixteenths(rng, shape):
    """Values k / 16, k in [0, 64): exact in bf16, sums exact in float32."""
    return (rng.integers(0, 64, shape) / 16.0).astype(np.float32)


def _seam_state(seed, frac_active, P):
    rng = np.random.default_rng(seed)
    planes = {n: (rng.random(R, dtype=np.float32) * 7 - 3).astype(np.float32)
              for n in rk.POOL_F}
    for n in ("r0", "r1", "r2"):
        planes[n] = _sixteenths(rng, R)
    planes["bounce"] = rng.integers(0, 50, R).astype(np.int32)
    planes["pix"] = rng.integers(0, P, R).astype(np.int32)
    planes["act"] = (rng.random(R) < frac_active).astype(np.int32)
    return planes, rng.random((10, R), dtype=np.float32), _sixteenths(rng, (P, 3))


def _run_seam_case(seed, frac_active, next_q, base_row, spp=7, P=1000, pix_offset=64000,
                   total_pixels=64800, nx=360, ny=180):
    planes, block, fb0 = _seam_state(seed, frac_active, P)
    # art_tpu's window: rows base_row .. base_row + N_HI of the (n_hi, 384)
    # framebuffer, [hi, c * 128 + lo] for pixel (base_row + hi) * 128 + lo
    pix_w = (base_row + np.arange(N_HI))[:, None] * 128 + np.arange(128)[None, :]
    inside = pix_w < P
    window = np.zeros((N_HI, 384), np.float32)
    for c in range(3):
        window[:, c * 128:(c + 1) * 128][inside] = fb0[pix_w[inside], c]
    scal_j = jnp.asarray([next_q // spp, next_q % spp, spp, P, pix_offset, total_pixels,
                          nx, ny], jnp.int32)
    want, want_count, want_win = jax_fused_refill_flush(
        {n: jnp.asarray(v) for n, v in planes.items()},
        tuple(jnp.asarray(block[c]) for c in range(4, 9)),
        jax_pack_camera(jax_make_camera(**CAM)), scal_j, jnp.asarray(window),
        jnp.int32(base_row), interpret=True)
    want_win = np.asarray(want_win)

    pool = {n: torch.from_numpy(v.copy()) for n, v in planes.items()}
    pool["act"] = pool["act"] != 0
    fb = torch.from_numpy(fb0.copy())
    lost = torch.zeros(1, dtype=torch.int32)
    q = torch.tensor([next_q, -1], dtype=torch.int64)
    hist = torch.zeros(4, dtype=torch.int64)
    u_ball, u_choice, u_media = rk.fused_refill_flush(
        pool, make_camera(**CAM), q, 0, hist, 2,
        rk.RefillScal(spp, P, pix_offset, total_pixels, nx, ny), fb, lost,
        block=torch.from_numpy(block.copy()), ncols=10)

    assert int(q[1]) - next_q == int(want_count) and int(q[0]) == next_q
    assert int(hist[2]) == int(np.sum(np.asarray(want["act"])))
    np.testing.assert_array_equal(pool["act"].numpy(), np.asarray(want["act"]) != 0)
    for n in rk.POOL_I:
        np.testing.assert_array_equal(pool[n].numpy(), np.asarray(want[n]), err_msg=n)
    for n in rk.POOL_F:
        np.testing.assert_allclose(pool[n].numpy(), np.asarray(want[n]), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    dead = planes["act"] == 0
    for n in ("r0", "r1", "r2"):
        assert not pool[n].numpy()[dead].any()
    assert torch.equal(u_choice, torch.from_numpy(block[3])) and len(u_media) == 1
    # the framebuffer: the window's pixels bit for bit against art_tpu, the
    # others against numpy's sum (the TPU drops dead slots outside its window)
    got = fb.numpy()
    for c in range(3):
        np.testing.assert_array_equal(got[pix_w[inside], c],
                                      want_win[:, c * 128:(c + 1) * 128][inside])
    expect = fb0.copy()
    np.add.at(expect, planes["pix"][dead],
              np.stack([planes[n] for n in ("r0", "r1", "r2")], 1)[dead])
    np.testing.assert_array_equal(got, expect)
    assert int(lost) == 0
    return int((dead & ((planes["pix"] >> 7) >= base_row)).sum())


@pytest.mark.parametrize("seed,frac_active,next_q,base_row", [
    (10, 0.4, 123, 0),  # mixed pool
    (11, 0.3, 2000, 3),  # a window at base row 3: pixels below 384 outside it
    (12, 0.0, 0, 1),  # all dead
    (13, 0.5, 7 * 1000, 0),  # queue exhausted: dead slots flush, then zero
])
def test_k12_twin_matches_pallas_interpret(seed, frac_active, next_q, base_row):
    assert _run_seam_case(seed, frac_active, next_q, base_row) > R // 4


def test_flush_dead_adds_and_zeroes_the_dead_slots():
    planes, _, fb0 = _seam_state(3, 0.5, 1000)
    pool = {n: torch.from_numpy(v.copy()) for n, v in planes.items()}
    pool["act"] = pool["act"] != 0
    pool["pix"][:5] = 1000  # outside [0, P): counted, not added
    pool["act"][:5] = False
    fb = torch.from_numpy(fb0.copy())
    lost = torch.zeros(1, dtype=torch.int32)
    before = {n: pool[n].clone() for n in ("r0", "r1", "r2")}
    rk.flush_dead(pool, fb, lost)
    dead = ~pool["act"]
    assert int(lost) == 5
    expect = fb0.copy()
    idx = dead.clone()
    idx[:5] = False
    np.add.at(expect, pool["pix"][idx].numpy(),
              torch.stack([before[n] for n in ("r0", "r1", "r2")], 1)[idx].numpy())
    np.testing.assert_array_equal(fb.numpy(), expect)
    for n in ("r0", "r1", "r2"):
        assert not pool[n][dead].any() and torch.equal(pool[n][~dead], before[n][~dead])


def _injected(scene, nx, ny, spp, seed):
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp)
    R_ = plan_batches(nx * ny, spp, 4, cfg, "cpu")[2]
    ncols = n_uniform_cols(scene.tables)

    def uniforms(tile, chunk, it):
        return np.random.default_rng([seed, tile, chunk, it]).random((ncols, R_),
                                                                     dtype=np.float32)
    return cfg, uniforms


@pytest.mark.parametrize("name", ["bouncing_spheres", "cornell_box"])
def test_seam_render_equals_the_default_route(name, monkeypatch):
    """Same injected uniforms: the seam route's iterations, rays and
    framebuffer against the default route's; the seam route ran seam_step
    and flushed once after the loop."""
    scene = build_scene(name, 32, 32)
    cfg, uniforms = _injected(scene, 32, 32, 4, 5)
    fb, st = render_scene(scene, cfg, device="cpu", uniforms=uniforms)
    steps, flushes = [], []
    seam_step, flush = integrator.seam_step, rk.flush_dead_plain
    monkeypatch.setattr(integrator, "seam_step",
                        lambda *a, **k: steps.append(1) or seam_step(*a, **k))
    monkeypatch.setattr(rk, "flush_dead_plain",
                        lambda *a, **k: flushes.append(1) or flush(*a, **k))
    with routes.using(seam_flush=True):
        sfb, sst = render_scene(scene, cfg, device="cpu", uniforms=uniforms)
    assert len(steps) >= sst["iterations"] and len(flushes) == len(steps) + 1
    assert sst["iterations"] == st["iterations"] and sst["rays"] == st["rays"]
    np.testing.assert_allclose(sfb, fb, rtol=1e-5, atol=1e-6)
    assert sfb.max() > 0


@pytest.mark.parametrize("name,nx,ny,seed", [("bouncing_spheres", 32, 16, 7),
                                             ("cornell_box", 32, 32, 1984)])
def test_seam_render_matches_art_tpu(name, nx, ny, seed):
    """art_tpu's threefry uniforms, the bars of test_torch_render's
    test_render_matches_art_tpu (same seeds and sizes)."""
    jfb, jst = jax_render_scene(jax_build_scene(name, nx, ny),
                                JaxConfig(nx=nx, ny=ny, spp=4, seed=seed))
    with routes.using(seam_flush=True):
        fb, st = render_scene(build_scene(name, nx, ny),
                              RenderConfig(nx=nx, ny=ny, spp=4, seed=seed), device="cpu",
                              uniforms=_threefry(seed, jst["n_slots"]))
    assert st["iterations"] == jst["iterations"]
    rays_tol = 1e-2 if name == "cornell_box" else 1e-3
    assert abs(st["rays"] - jst["rays"]) <= rays_tol * jst["rays"]
    assert (np.abs(fb - jfb).max(axis=-1) <= 1e-3).mean() >= 0.98


def test_seam_route_takes_no_short_path():
    t = build_scene("quads", 16, 8).tables
    assert use_short_path(t) and use_short_path(t, True)
    with routes.using(seam_flush=True):
        assert not use_short_path(t) and not use_short_path(t, True)
        _, st = render_scene(build_scene("quads", 16, 8), RenderConfig(nx=16, ny=8, spp=2),
                             device="cpu")
    assert not st["short_path"] and st["rays"] > 0
