"""Whole renders: art_tpu_torch on the CPU against art_tpu on the CPU.

Slot level.  Both renders get art_tpu's own threefry stream — the port
through its injected uniform source, block ``uniform(fold(fold(PRNGKey(seed),
tile, chunk), it), (ncols, R))`` per pool iteration — with the same R, tiles
and chunks (the port's CPU ``plan_batches`` is art_tpu's).  They must agree
on the iteration count, on the traced ray count to 0.1% and on ≥ 98% of
pixels to 1e-3.  The renders differ only in the last ulp of XLA's and
PyTorch's transcendentals (sin/cos of the lens and ball angles, cube root,
and XLA's rewrite of 1/sqrt as an approximate rsqrt), and a ray that bounces
long enough amplifies a last-ulp difference into another path.  The
iteration count is the length of the single longest path, so it is the
most sensitive of the three: three_spheres agreed on it for every seed
tried (8 of 8); bouncing_spheres, whose glass and metal balls trap long
paths, for about half, so its free-running test uses seed 7, one that
agrees, and the lock-step tests below check every iteration of a render
slot by slot, which does not depend on the seed.

cornell_box is a closed room: nearly every path runs to max_depth, so its
iteration count is max_depth on both sides, but a path that leaves its twin
early runs on for dozens of segments, so its traced ray count is held to
1% (measured at 32x32 @ 4: 0.26%, 0.07% and 0.04% for seeds 1984, 7 and 3)
and its pixels to the same 98% within 1e-3.

perlin, earth and simple_light render staged (``short_path=False``:
art_tpu on the CPU always runs staged) with the same budgets; the
turbulence kernel's twin serves the noise and felt leaves, K4 and K8's twins
the compacted image fetch (art_tpu's CPU path gathers densely; both are
exact on the lanes that read a texel).  At 32x16 @ 4 earth and
simple_light agreed with art_tpu for each of seeds 1984, 7 and 5: equal
iterations and rays, every pixel within 1e-3.  The short path (K11's twin) is held to the staged path twice:
on the same injected uniforms, where both must agree as kernel and plain
renders do (equal iterations, ≥ 98% of pixels within 1e-3), and on
independent Philox seeds, statistically, with the image comparison of
tests/test_parity.py:_compare (16x8 luminance correlation ≥ 0.98,
channel-mean difference ≤ 0.02; measured at 64x32 @ 16: quads 0.9994 /
0.0006, perlin 0.9981 / 0.0019)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core import rng as artrng
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu.render.integrator import _bounce_step as jax_bounce_step
from art_tpu.render.integrator import trace as jax_trace
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu.render.renderer import plan_batches as jax_plan_batches
from art_tpu.render.renderer import render_scene as jax_render_scene
from art_tpu_torch import cli
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.ops.shade import shade_params_p
from art_tpu_torch.ops.shade_kernel import REC_BAKED, REC_F, STATE_F, shade_flush
from art_tpu_torch.render.integrator import render_wavefront, trace
from art_tpu_torch.render.renderer import RenderConfig, plan_batches, render_scene
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.utils.ppm import read_ppm

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

NX, NY, SPP = 32, 16, 4


def _threefry(seed, R, ncols=10):
    master = jax.random.PRNGKey(seed)

    def block(tile, chunk, it):
        key = artrng.fold(artrng.fold(master, tile, chunk), it)
        return np.asarray(artrng.uniform(key, (ncols, R)))

    return block


@pytest.mark.parametrize("name,seed", [("three_spheres", 1984), ("bouncing_spheres", 7),
                                       ("cornell_box", 1984), ("perlin", 1984),
                                       ("earth", 1984), ("simple_light", 1984)])
def test_render_matches_art_tpu(name, seed):
    """bouncing_spheres' seed 7 was picked: it is one of the seeds whose
    longest path stays in step, so the exact iteration count can be held.
    That is enough because this case guards the render-level plumbing
    (tiles, chunks, R, queue, stats, framebuffer) that every seed runs;
    whether the bounce math follows art_tpu's on this scene is gated,
    seed-free, by test_bouncing_render_lockstep.  cornell_box renders at
    32x32 @ 4 with its ray count held to 1% (module docstring)."""
    nx, ny = (32, 32) if name == "cornell_box" else (NX, NY)
    jfb, jst = jax_render_scene(jax_build_scene(name, nx, ny),
                                JaxConfig(nx=nx, ny=ny, spp=SPP, seed=seed))
    fb, st = render_scene(build_scene(name, nx, ny),
                          RenderConfig(nx=nx, ny=ny, spp=SPP, seed=seed), device="cpu",
                          uniforms=_threefry(seed, jst["n_slots"]), short_path=False)
    assert not st["short_path"]
    for k in ("tile_pixels", "spp_chunk", "n_slots", "spp"):
        assert st[k] == jst[k], k
    assert st["iterations"] == jst["iterations"]
    rays_tol = 1e-2 if name == "cornell_box" else 1e-3
    assert abs(st["rays"] - jst["rays"]) <= rays_tol * jst["rays"]
    close = np.abs(fb - jfb).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()
    assert set(jst) <= set(st)


@pytest.mark.parametrize("name,short_path", [
    ("quads", None), ("checkered_spheres", None), ("perlin", None),
    ("simple_light_book", None), ("three_spheres", True)])
def test_short_path_render_matches_staged_same_uniforms(name, short_path):
    """The short path's render (K11's twin) against the staged render on
    the same injected uniforms; three_spheres forced onto the short path,
    dielectric chain included."""
    scene = build_scene(name, NX, NY)
    cfg = RenderConfig(nx=NX, ny=NY, spp=SPP)
    R = plan_batches(NX * NY, SPP, 4, cfg, "cpu")[2]
    uniforms = _threefry(5, R)
    sfb, sst = render_scene(scene, cfg, device="cpu", uniforms=uniforms,
                            short_path=short_path)
    fb, st = render_scene(scene, cfg, device="cpu", uniforms=uniforms, short_path=False)
    assert sst["short_path"] and not st["short_path"]
    assert sst["iterations"] == st["iterations"]
    assert abs(sst["rays"] - st["rays"]) <= 1e-3 * st["rays"]
    assert (np.abs(sfb - fb).max(axis=-1) <= 1e-3).mean() >= 0.98
    assert np.isfinite(sfb).all() and (sfb >= 0).all() and sfb.max() > 0


@pytest.mark.parametrize("name", ["quads", "perlin"])
def test_short_path_render_matches_staged_statistically(name):
    """Independent Philox seeds through the two paths (module docstring)."""
    from test_parity import _down

    nx, ny, spp = 64, 32, 16
    scene = build_scene(name, nx, ny)
    a, sa = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp, seed=1), device="cpu")
    b, sb = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp, seed=2), device="cpu",
                         short_path=False)
    assert sa["short_path"] and not sb["short_path"]
    a, b = _down(np.clip(a[::-1], 0.0, 1.0)), _down(np.clip(b[::-1], 0.0, 1.0))
    corr = float(np.corrcoef(a.mean(-1).ravel(), b.mean(-1).ravel())[0, 1])
    mean_diff = float(np.abs(a.mean((0, 1)) - b.mean((0, 1))).max())
    assert corr >= 0.98 and mean_diff <= 0.02, (corr, mean_diff)


def test_bouncing_render_lockstep():
    """Every iteration of a bouncing_spheres render: the port's refill, hit
    records and K3 on the pool, against art_tpu's ``_bounce_step`` and death
    rule from the same state (≤ 2 knife-edge flips per iteration)."""
    _lockstep("bouncing_spheres")


def test_cornell_render_lockstep():
    """The same for cornell_box: K5, K6 and K2 merged, K3 in its baked mode
    (scene/builder.py _shade_consts), every iteration to max_depth."""
    _lockstep("cornell_box")


def _lockstep(name, seed=1984):
    jscene, scene = jax_build_scene(name, NX, NY), build_scene(name, NX, NY)
    t = scene.tables
    P = NX * NY
    R = plan_batches(P, SPP, max(t.n_spheres, t.n_quads, t.n_boxes), RenderConfig(),
                     "cpu")[2]
    uniforms = _threefry(seed, R)
    pool = rk.new_pool(R, "cpu")
    q, hist = torch.zeros(2, dtype=torch.int64), torch.zeros(64, dtype=torch.int64)
    fb, lost = torch.zeros((P, 3)), torch.zeros(1, dtype=torch.int32)
    scal = rk.RefillScal(SPP, P, 0, P, NX, NY)
    J = jnp.asarray
    for it in range(64):
        block = torch.from_numpy(uniforms(0, 0, it).copy())
        u_ball, u_choice, _ = rk.fused_refill(pool, scene.camera, q, it % 2, hist, it,
                                              scal, block=block, ncols=10)
        if not bool(pool["act"].any()):
            break
        before = {k: v.numpy().copy() for k, v in pool.items()}
        o = (pool["ox"], pool["oy"], pool["oz"])
        d = (pool["dx"], pool["dy"], pool["dz"])
        rec = closest_surface_p(t, o, d, pool["tm"], T_MIN)
        if t.shade_rows is None:
            params = shade_params_p(t, rec)
            planes = dict(zip(REC_F, (*rec.p, *rec.normal, *params[:3], *params[3],
                                      *params[4], *u_ball, u_choice)))
        else:
            planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u_ball, u_choice)))
        shade_flush(pool, rec.hit, planes, scene.background, fb, lost, max_depth=50,
                    gradient=False, consts=t.shade_rows)

        b = {k: J(v) for k, v in before.items()}
        o2, d2, thr2, rad2, surv = jax_bounce_step(
            jscene.tables, (b["ox"], b["oy"], b["oz"]), (b["dx"], b["dy"], b["dz"]),
            b["tm"], (b["t0"], b["t1"], b["t2"]), (b["r0"], b["r1"], b["r2"]),
            b["act"], tuple(J(u.numpy()) for u in u_ball), J(u_choice.numpy()),
            jnp.zeros((1, R)), J(np.zeros(3, np.float32)), False)
        still = np.asarray(surv) & (before["bounce"] + before["act"] < 50)
        agree = pool["act"].numpy() == still
        assert np.sum(~agree) <= 2, it
        want = dict(zip(STATE_F, map(np.asarray, (*o2, *d2, *thr2, *rad2))))
        for n in STATE_F:
            np.testing.assert_allclose(pool[n].numpy()[agree], want[n][agree],
                                       rtol=2e-4, atol=2e-5, err_msg=f"{n} it={it}")
    assert not bool(pool["act"].any()) and int(lost) == 0
    assert int(q[it % 2]) == P * SPP


def test_trace_matches_art_tpu():
    jscene, scene = jax_build_scene("three_spheres", 32, 16), build_scene("three_spheres", 32, 16)
    rng = np.random.default_rng(11)
    n = 1024
    origins = np.zeros((n, 3), np.float32)
    dirs = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.6, 0.6, n),
                     -np.ones(n)], 1).astype(np.float32)
    times = np.zeros(n, np.float32)
    key = jax.random.PRNGKey(5)
    J = jnp.asarray
    want, want_rays = jax_trace(jscene.tables, J(origins), J(dirs), J(times), key,
                                J(np.asarray(jscene.background, np.float32)), True, 50)

    def uniforms(bounce):
        return np.asarray(artrng.uniform(artrng.fold(key, 1000 + bounce), (10, n)))

    got, rays = trace(scene.tables, torch.from_numpy(origins), torch.from_numpy(dirs),
                      torch.from_numpy(times), uniforms, scene.background, True, 50)
    assert abs(rays - float(want_rays)) <= 2
    close = np.abs(got.numpy() - np.asarray(want)).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98


@pytest.mark.parametrize("n_pixels,spp,prims", [(512, 4, 488), (512, 4, 4),
                                                (960000, 64, 488), (90000, 500, 4)])
def test_plan_batches_cpu_matches_art_tpu(n_pixels, spp, prims):
    want = jax_plan_batches(n_pixels, spp, prims, JaxConfig())
    assert plan_batches(n_pixels, spp, prims, RenderConfig(), "cpu") == want


def test_plan_batches_cuda_pool():
    tile, chunk, slots = plan_batches(960000, 64, 488, RenderConfig(), "cuda")
    assert slots == 1 << 17 and tile == 64000 and chunk == 64
    assert plan_batches(512, 4, 488, RenderConfig(), "cuda")[2] == 2048
    assert plan_batches(100, 3, 4, RenderConfig(), "cuda")[2] % 256 == 0


def test_render_with_philox_on_cpu():
    fb, st = render_scene(build_scene("three_spheres", 24, 12),
                          RenderConfig(nx=24, ny=12, spp=4), device="cpu")
    assert fb.shape == (12, 24, 3)
    assert np.isfinite(fb).all() and (fb >= 0).all()
    assert st["rays"] >= 24 * 12 * 4 and st["device"] == "cpu"
    top = fb[-1].mean(axis=0)
    assert top[2] > top[0]  # sky: blue-ish top row


def test_cli_writes_a_ppm(tmp_path):
    out = tmp_path / "out.ppm"
    rc = cli.main(["--scene", "three_spheres", "--nx", "16", "--ny", "8", "--spp", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(out.read_text())
    assert img.shape == (8, 16, 3)
    assert (img >= 0).all()


def test_cli_writes_a_cornell_ppm(tmp_path):
    out = tmp_path / "cornell.ppm"
    rc = cli.main(["--scene", "cornell_box", "--nx", "16", "--ny", "16", "--spp", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(out.read_text())
    assert img.shape == (16, 16, 3)
    assert (img >= 0).all() and img.max() > 0


def _no_sphere_scene(b_mod, O, M):
    """Quads and boxes, no sphere: a floor, a light and two boxes at zero
    offset (so art_tpu's jnp box pass and the port's rows round alike)."""
    b = b_mod.SceneBuilder().add(
        O.Quad((-3, 0, -3), (6, 0, 0), (0, 0, 6), M.Lambertian((0.7, 0.7, 0.7))),
        O.Quad((-1, 3, -1), (2, 0, 0), (0, 0, 2), M.DiffuseLight((6.0, 6.0, 6.0))),
        O.Box((-1.5, 0, -1), (-0.5, 1, 0), M.Lambertian((0.8, 0.2, 0.2))),
        O.RotateY(O.Box((0.5, 0, -0.5), (1.3, 1.6, 0.3), M.Metal((0.8, 0.8, 0.9), 0.1)), 20.0),
    )
    b.set_camera(lookfrom=(0, 2, 7), lookat=(0, 0.8, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=2.0, time0=0.0, time1=1.0)
    b.set_background((0.1, 0.1, 0.1))
    return b.compile()


def test_render_without_spheres_matches_art_tpu():
    """render_wavefront takes its device from a table every scene has: a
    scene of quads and boxes alone renders, and as art_tpu renders it."""
    seed = 5
    jscene = _no_sphere_scene(jax_builder, JO, JM)
    scene = _no_sphere_scene(port_builder, PO, PM)
    assert scene.tables.n_spheres == 0 and scene.tables.sph_rows.shape == (0, 10)
    jfb, jst = jax_render_scene(jscene, JaxConfig(nx=NX, ny=NY, spp=SPP, seed=seed))
    fb, st = render_scene(scene, RenderConfig(nx=NX, ny=NY, spp=SPP, seed=seed),
                          device="cpu", uniforms=_threefry(seed, jst["n_slots"]))
    assert st["iterations"] == jst["iterations"]
    assert abs(st["rays"] - jst["rays"]) <= 1e-2 * jst["rays"]
    assert (np.abs(fb - jfb).max(axis=-1) <= 1e-3).mean() >= 0.98
    # and through render_wavefront directly, on the tables' own device
    batch, rays, _ = render_wavefront(
        scene.tables, scene.camera, 0, 2, scene.background, tile_pixels=64,
        total_pixels=NX * NY, nx=NX, ny=NY, max_depth=8, gradient_bg=False,
        n_slots=256, tile=0, chunk=0, seed=1)
    assert batch.device.type == "cpu" and rays >= 128


def test_cli_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--scene", "three_spheres", "--nx", "8", "--ny", "4", "--spp", "1"])


def test_cli_later_slice_options_raise(monkeypatch):
    """``--sharded`` is ported (multi-device rendering): on its default
    device, where no card is visible, it raises instead of rendering on the
    host (the card is hidden, so this holds on a machine with one too)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no visible CUDA device"):
        cli.main(["--sharded", "--nx", "8", "--ny", "4", "--spp", "1"])


def test_cli_lists_scenes(capsys):
    assert cli.main(["--list-scenes"]) == 0
    assert "bouncing_spheres" in capsys.readouterr().out


def test_cli_lists_every_scene(capsys):
    """All twelve scenes of the registry, the media scenes included."""
    assert cli.main(["--list-scenes"]) == 0
    listed = capsys.readouterr().out.split()
    assert len(listed) == 12
    assert {"cornell_smoke", "final_scene", "original_scene"} <= set(listed)


@pytest.mark.parametrize("name", ["cornell_smoke", "final_scene", "original_scene"])
def test_cli_writes_a_media_scene_ppm(tmp_path, name):
    out = tmp_path / f"{name}.ppm"
    rc = cli.main(["--scene", name, "--nx", "16", "--ny", "8", "--spp", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(out.read_text())
    assert img.shape == (8, 16, 3) and (img >= 0).all() and img.max() > 0


@pytest.mark.parametrize("name", ["perlin", "checkered_spheres", "simple_light_book",
                                  "earth", "simple_light"])
def test_cli_writes_a_texture_scene_ppm(tmp_path, name):
    out = tmp_path / f"{name}.ppm"
    rc = cli.main(["--scene", name, "--nx", "16", "--ny", "8", "--spp", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_ppm(out.read_text())
    assert img.shape == (8, 16, 3) and (img >= 0).all() and img.max() > 0


def test_render_config_defaults_match_art_tpu():
    port = dataclasses.asdict(RenderConfig())
    ref = dataclasses.asdict(JaxConfig())
    for k in ("nx", "ny", "spp", "max_depth", "gamma", "seed", "batch_budget",
              "max_slots", "max_tile_pixels", "queue_budget"):
        assert port[k] == ref[k], k
    assert port["cuda_slots"] == ref["tpu_slots"]
