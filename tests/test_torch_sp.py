"""The short path (K11's plain twin, ops/sp_kernel.py) against art_tpu's
``sp_step`` in interpret mode, and against the port's own staged iteration,
on the same pool and the same uniforms from a numpy seed (R = 8192), as
tests/test_sp_kernel.py:115-191 holds art_tpu's kernel to its staged path.

Scenes: quads, checkered_spheres, perlin, simple_light_book, the light and
checker scene of tests/test_sp_kernel.py:41-58, and three_spheres (its
dielectric keeps it staged by default; ``short_path=True`` forces it).

Budgets, those of tests/test_sp_kernel.py: the take count, bounce and pix
exactly; at most 2 knife-edge rays — a flip of act or died (a Schlick coin
or a metal graze on a last-ulp difference: the TPU kernel takes its
in-ball radius as exp(log(u)/3), the port a true cube root) or a float
plane outside rtol 2e-4 / atol 2e-5 (seed 0 of three_spheres has one ray
whose hit point on the metal ball differs by 1e-5 from the reference's, and
whose reflected dy, 0.0066, then differs by 4e-5); every other ray within
those tolerances.  On the marble scenes the r = 1000 ground sphere turns a
last-ulp hit-point shift into ~1e-3 of turbulence, so those planes get
rtol 5e-3 / atol 5e-4 with 8 outliers per plane beside the 2 flips.  The twin's flush adds
in float32: against a float64 scatter of the reference's died radiance to
rtol 2e-4 / atol 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.camera import make_camera as jax_make_camera
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops.refill_kernel import pack_camera as jax_pack_camera
from art_tpu.ops.sp_kernel import sp_step as jax_sp_step
from art_tpu_torch.core.camera import make_camera
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain
from art_tpu_torch.render.integrator import staged_step, use_short_path
from test_torch_scene import light_checker_scenes

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
MAX_DEPTH = 50
FLOAT_NAMES = rk.POOL_F
CAM = dict(lookfrom=(0, 0, 2), lookat=(0, 0, -1), vup=(0, 1, 0), vfov_degrees=60.0,
           aspect=2.0, aperture=0.05, focus_dist=3.0, time0=0.0, time1=1.0)
NOISE = ("perlin", "simple_light_book")
SCENES = ["quads", "checkered_spheres", "perlin", "simple_light_book", "light_checker",
          "three_spheres"]
# the port's block columns from art_tpu's sp_step planes (jitter2, lens2,
# time, ball3, choice, media): ball, choice, jitter, lens, time, media
PORT_COLS = [5, 6, 7, 8, 0, 1, 2, 3, 4, 9]


def _scenes(name):
    if name == "light_checker":
        return light_checker_scenes()
    return jax_build_scene(name, 96, 48), build_scene(name, 96, 48)


def _random_state(seed, frac_active):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    planes = {n: (u(R) * 4 - 2) for n in ("ox", "oy", "oz")}
    planes.update({n: (u(R) * 2 - 1) for n in ("dx", "dy", "dz")})
    planes["tm"] = u(R)
    planes.update({n: u(R) for n in ("t0", "t1", "t2")})
    planes.update({n: u(R) * 0.2 for n in ("r0", "r1", "r2")})
    planes["bounce"] = rng.integers(0, MAX_DEPTH, R).astype(np.int32)
    planes["pix"] = rng.integers(0, 800, R).astype(np.int32)  # inside the P = 800 tile
    planes["act"] = (rng.random(R) < frac_active).astype(np.int32)
    return planes, u(10, R)


def _port_pool(planes):
    pool = {n: torch.from_numpy(v.copy()) for n, v in planes.items()}
    pool["act"] = pool["act"] != 0
    return pool


def _port_step(fn, scene, planes, uniforms, next_q, spp, P, nx, ny):
    """One port iteration on a copy of ``planes``: (pool, take, died, fb)."""
    pool = _port_pool(planes)
    q = torch.tensor([next_q, 0], dtype=torch.int64)
    hist = torch.zeros(2, dtype=torch.int64)
    fb = torch.zeros((P, 3))
    lost = torch.zeros(1, dtype=torch.int32)
    died = fn(pool, make_camera(**CAM), q, 0, hist, 1, rk.RefillScal(spp, P, 0, P, nx, ny),
              scene.tables, scene.background, fb, lost,
              block=torch.from_numpy(uniforms[PORT_COLS].copy()), ncols=10,
              max_depth=MAX_DEPTH, gradient=scene.gradient_bg)
    if died is None:  # the staged step returns nothing
        died = ~pool["act"]
    assert int(lost) == 0
    return pool, int(q[1]) - next_q, died.numpy(), fb.numpy()


def _compare(got, want, noise):
    rtol, atol, budget = (5e-3, 5e-4, 8) if noise else (2e-4, 2e-5, 0)
    g_pool, g_take, g_died = got[:3]
    w_pool, w_take, w_died = want[:3]
    assert g_take == w_take
    g_act, w_act = g_pool["act"], w_pool["act"]
    agree = (g_act == w_act) & (g_died == w_died)
    np.testing.assert_array_equal(g_pool["bounce"], w_pool["bounce"])
    np.testing.assert_array_equal(g_pool["pix"], w_pool["pix"])
    knife = ~agree
    for name in FLOAT_NAMES:
        bad = agree & ~np.isclose(g_pool[name], w_pool[name], rtol=rtol, atol=atol)
        assert int(bad.sum()) <= (budget or 2), (name, int(bad.sum()))
        if not budget:
            knife |= bad
    assert int(knife.sum()) <= 2, int(knife.sum())
    return agree


def _numpy_pool(pool):
    return {k: v.numpy() for k, v in pool.items()}


def _run_case(name, seed, frac_active=0.7, next_q=123, spp=7, P=800, nx=96, ny=48):
    jscene, scene = _scenes(name)
    planes, uniforms = _random_state(seed, frac_active)
    pool, take, died, fb = _port_step(sp_step_plain, scene, planes, uniforms, next_q,
                                      spp, P, nx, ny)
    scal = jnp.asarray([next_q // spp, next_q % spp, spp, P, 0, P, nx, ny], jnp.int32)
    want, want_take, want_died = jax_sp_step(
        {k: jnp.asarray(v) for k, v in planes.items()}, tuple(map(jnp.asarray, uniforms)),
        jax_pack_camera(jax_make_camera(**CAM)), scal,
        jnp.asarray(jscene.background, jnp.float32), consts=jscene.tables.sp_consts,
        n_media=1, max_depth=MAX_DEPTH, gradient=jscene.gradient_bg, interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    want["act"] = want["act"] != 0
    want_died = np.asarray(want_died)
    _compare((_numpy_pool(pool), take, died), (want, int(want_take), want_died),
             name in NOISE)
    assert died.any() and pool["act"].any()
    if np.array_equal(died, want_died):
        rad = np.stack([want[n] for n in ("r0", "r1", "r2")], 1).astype(np.float64)
        want_fb = np.zeros((P, 3))
        np.add.at(want_fb, want["pix"][want_died], rad[want_died])
        np.testing.assert_allclose(fb, want_fb, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("seed", [0, 7])
def test_sp_step_matches_art_tpu(name, seed):
    _run_case(name, seed)


def test_sp_step_queue_nearly_exhausted():
    _run_case("quads", 3, frac_active=0.3, next_q=7 * 800 - 500)


def test_sp_step_queue_exhausted():
    """No slot takes a queue element; dead slots stay as they were."""
    _run_case("perlin", 4, frac_active=0.5, next_q=7 * 800)


def test_sp_step_counts_out_of_tile_deaths():
    """A dying slot whose pix lies outside [0, P) adds nothing to the
    framebuffer and counts into ``lost``, as K3 does; in-tile deaths add."""
    scene = build_scene("quads", 96, 48)
    planes, uniforms = _random_state(5, 1.0)
    planes["bounce"][:] = MAX_DEPTH - 1  # every live slot dies this bounce
    planes["pix"][:4] = (-1, 800, 807, -1000)
    pool = _port_pool(planes)
    fb, lost = torch.zeros((800, 3)), torch.zeros(1, dtype=torch.int32)
    died = sp_step(pool, make_camera(**CAM), torch.tensor([123, 0]), 0,
                   torch.zeros(1, dtype=torch.int64), 0, rk.RefillScal(7, 800, 0, 800, 96, 48),
                   scene.tables, scene.background, fb, lost,
                   block=torch.from_numpy(uniforms[PORT_COLS].copy()), ncols=10,
                   max_depth=MAX_DEPTH, gradient=True)
    assert bool(died.all()) and int(lost) == 4 and not bool(pool["act"].any())
    rad = torch.stack([pool[n] for n in ("r0", "r1", "r2")], dim=1).double()
    want = torch.zeros((800, 3), dtype=torch.float64)
    want.index_add_(0, torch.from_numpy(planes["pix"][4:]).long(), rad[4:])
    torch.testing.assert_close(fb.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_sp_step_matches_the_staged_step(name):
    """The short path's twin against the port's own staged iteration (K1,
    K5/K2, noise leaf, baked K3 twins) from the same pool and uniforms."""
    _, scene = _scenes(name)
    planes, uniforms = _random_state(21, 0.7)
    args = (scene, planes, uniforms, 123, 7, 800, 96, 48)
    g_pool, g_take, _, g_fb = _port_step(sp_step_plain, scene, *args[1:])
    w_pool, w_take, _, w_fb = _port_step(
        lambda *a, **k: staged_step(*a, plain=True, **k), scene, *args[1:])
    # died of the staged step: live after its refill and not live now
    g, w = _numpy_pool(g_pool), _numpy_pool(w_pool)
    agree = _compare((g, g_take, ~g["act"]), (w, w_take, ~w["act"]), name in NOISE)
    assert agree.sum() >= R - 2
    if agree.all():
        np.testing.assert_allclose(g_fb, w_fb, rtol=2e-4, atol=2e-4)


def test_sp_step_feedback_loop():
    """30 chained iterations from an empty pool (three_spheres, forced onto
    the short path): the queue stays in step with art_tpu's and the
    radiance flushed agrees in aggregate, as tests/test_sp_kernel.py:194."""
    jscene, scene = _scenes("three_spheres")
    cam = dict(CAM, aperture=0.0)
    spp, P, nx, ny = 4, 512, 96, 48
    scal_p = rk.RefillScal(spp, P, 0, P, nx, ny)
    pool = rk.new_pool(R, "cpu")
    q = torch.zeros(2, dtype=torch.int64)
    hist = torch.zeros(30, dtype=torch.int64)
    fb, lost = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    z = jnp.zeros((R,), jnp.float32)
    want = dict(ox=z, oy=z, oz=z, dx=z, dy=z, dz=z + 1.0, tm=z, t0=z + 1, t1=z + 1,
                t2=z + 1, r0=z, r1=z, r2=z, bounce=jnp.zeros((R,), jnp.int32),
                pix=jnp.zeros((R,), jnp.int32), act=jnp.zeros((R,), jnp.int32))
    next_q_w = 0
    fb_w = np.zeros(P)
    for it in range(30):
        u = np.random.default_rng([1000, it]).random((10, R), dtype=np.float32)
        sp_step(pool, make_camera(**cam), q, it % 2, hist, it, scal_p, scene.tables,
                scene.background, fb, lost, block=torch.from_numpy(u[PORT_COLS].copy()),
                ncols=10, max_depth=MAX_DEPTH, gradient=True)
        scal = jnp.asarray([next_q_w // spp, next_q_w % spp, spp, P, 0, P, nx, ny],
                           jnp.int32)
        want, take_w, died_w = jax_sp_step(
            want, tuple(map(jnp.asarray, u)), jax_pack_camera(jax_make_camera(**cam)), scal,
            jnp.asarray(jscene.background, jnp.float32), consts=jscene.tables.sp_consts,
            n_media=1, max_depth=MAX_DEPTH, gradient=True, interpret=True)
        next_q_w += int(take_w)
        dw = np.asarray(died_w)
        np.add.at(fb_w, np.asarray(want["pix"])[dw], np.asarray(want["r0"])[dw])
        assert int(q[(it + 1) % 2]) == next_q_w, it
    assert int(lost) == 0 and next_q_w > P
    np.testing.assert_allclose(fb[:, 0].sum().item(), fb_w.sum(), rtol=1e-3)
    close = np.isclose(fb[:, 0].numpy(), fb_w, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.99, close.mean()


def test_short_path_gate():
    """art_tpu's rule: the gated scenes without a dielectric take the short
    path; three_spheres only when forced; cornell_box never, and forcing it
    raises."""
    for name in ("quads", "checkered_spheres", "perlin", "simple_light_book"):
        assert use_short_path(build_scene(name, 32, 16).tables)
    t = build_scene("three_spheres", 32, 16).tables
    assert not use_short_path(t) and use_short_path(t, True)
    assert not use_short_path(build_scene("quads", 32, 16).tables, False)
    t = build_scene("cornell_box", 32, 32).tables
    assert not use_short_path(t)
    with pytest.raises(ValueError, match="gate"):
        use_short_path(t, True)


def test_sp_step_needs_one_uniform_source():
    scene = build_scene("quads", 32, 16)
    pool = rk.new_pool(256, "cpu")
    with pytest.raises(ValueError):
        sp_step(pool, scene.camera, torch.zeros(2, dtype=torch.int64), 0,
                torch.zeros(1, dtype=torch.int64), 0, rk.RefillScal(1, 256, 0, 256, 16, 16),
                scene.tables, scene.background, torch.zeros((256, 3)),
                torch.zeros(1, dtype=torch.int32), ncols=10, max_depth=50, gradient=True)
