"""The port's plain shade + integrate + flush (K3, ops/shade_kernel.py)
against art_tpu's staged jnp composition — ``integrator._bounce_step``, the
death rule and ``flush_kernel.flush_accumulate`` in interpret mode — on
random pools from a numpy seed (R = 8192), with the knife-edge budget and
tolerances of tests/test_shade_kernel.py:103-132.

Each side computes its own hit records from the same rays (the port's
``closest_surface_p`` + ``shade_params_p`` feed K3; test_torch_intersect.py
holds them to art_tpu's).  What can differ is the last ulp of
sin/cos/cbrt of the in-ball sample, so ≤ 2 rays may flip a discrete
decision (a metal graze); the float planes agree to
rtol 2e-4 / atol 2e-5 on the rest.  The framebuffer: K3 adds in float32,
so it must equal a float32 scatter of art_tpu's died radiance to 2e-4; the
TPU flush rounds every sample to bf16 first, so against it each pixel may
differ by the bf16 rounding of its samples (2^-8 relative each).

K3's baked mode (``consts=`` the scene's ``shade_rows``) on three_spheres,
cornell_box and a box scene with a checker of solids: its twin must equal
the plane-fed twin on the same inputs bit for bit (the table holds the
float32 values the fetch returns), and it is held to art_tpu's
``shade_flush(consts=..., interpret=True)`` — the Pallas kernel's baked
mode, which takes its in-ball radius as ``exp(log(u)/3)`` — with the
budget and tolerances above.  On the scenes with special leaves (the
marble of perlin and simple_light_book, earth's image, simple_light's felt
and uv-offset pool ball) the hit record carries the special leaf planes
``sp0..sp2`` from ``eval_special_p``; each package computes its own hit
points, and the r = 1000 ground sphere turns a last-ulp shift of one into
~1e-3 of turbulence, and a last-ulp (u, v) on a texel edge into the
neighbouring texel, so there the float planes get rtol 5e-3 / atol 5e-4
with 8 outliers per plane (tests/test_sp_kernel.py:175-186).  The baked
twin equals the plane-fed twin bit for bit on earth and simple_light too:
the plane-fed image leaf reaches the texel through the uv_offset redirect
of ``eval_texture_p``, the baked one through the folded offset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops.flush_kernel import flush_accumulate
from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu.ops.shade_kernel import shade_flush as jax_shade_flush
from art_tpu.ops.texture_eval import eval_special_p as jax_eval_special_p
from art_tpu.render.integrator import _bounce_step
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.ops.shade import shade_params_p
from art_tpu_torch.ops.shade_kernel import REC_BAKED, REC_F, REC_SP, STATE_F, shade_flush
from art_tpu_torch.ops.texture_eval import eval_special_p
from test_torch_scene import unrotated_scenes

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
MAX_DEPTH = 50
N_HI = 16  # art_tpu flush window rows; pix < N_HI * 128
P = N_HI * 128


def _random_inputs(seed, frac_active=0.8):
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    return dict(
        o=u(3, R) * 8 - 4, d=u(3, R) * 2 - 1, tm=u(R), thr=u(3, R), rad=u(3, R) * 0.2,
        bounce=rng.integers(0, MAX_DEPTH, R).astype(np.int32),
        pix=rng.integers(0, P, R).astype(np.int32),
        active=rng.random(R) < frac_active, u_ball=u(3, R), u_choice=u(R),
        fb0=u(P, 3),
    )


def _fb_window(fb):
    """(P, 3) -> art_tpu's (N_HI, 384) [hi, c*128 + lo] layout."""
    return fb.reshape(N_HI, 128, 3).transpose(0, 2, 1).reshape(N_HI, 384)


def _run_case(name, seed):
    x = _random_inputs(seed)
    jscene = jax_build_scene(name, 96, 48)
    scene = build_scene(name, 96, 48)

    # ---- port: plain K3 on the pool, in place ----
    pool = {n: torch.from_numpy(v.copy()) for n, v in zip(
        STATE_F, (*x["o"], *x["d"], *x["thr"], *x["rad"]))}
    pool.update(tm=torch.from_numpy(x["tm"].copy()),
                bounce=torch.from_numpy(x["bounce"].copy()),
                pix=torch.from_numpy(x["pix"].copy()),
                act=torch.from_numpy(x["active"].copy()))
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(scene.tables, o, d, pool["tm"], T_MIN)
    mtype, fuzz, refidx, malb, texv = shade_params_p(scene.tables, rec)
    u_ball = tuple(torch.from_numpy(x["u_ball"][c].copy()) for c in range(3))
    planes = dict(zip(REC_F, (*rec.p, *rec.normal, mtype, fuzz, refidx, *malb, *texv,
                              *u_ball, torch.from_numpy(x["u_choice"].copy()))))
    fb = torch.from_numpy(x["fb0"].copy())
    lost = torch.zeros(1, dtype=torch.int32)
    shade_flush(pool, rec.hit, planes, scene.background, fb, lost, max_depth=MAX_DEPTH,
                gradient=scene.gradient_bg)
    assert int(lost) == 0

    # ---- art_tpu: staged jnp bounce + death rule + flush ----
    J = jnp.asarray
    o2, d2, thr2, rad2, survived = _bounce_step(
        jscene.tables, tuple(map(J, x["o"])), tuple(map(J, x["d"])), J(x["tm"]),
        tuple(map(J, x["thr"])), tuple(map(J, x["rad"])), J(x["active"]),
        tuple(map(J, x["u_ball"])), J(x["u_choice"]), jnp.zeros((1, R), jnp.float32),
        J(np.asarray(jscene.background, np.float32)), jscene.gradient_bg)
    bounce2 = x["bounce"] + x["active"].astype(np.int32)
    still = np.asarray(survived) & (bounce2 < MAX_DEPTH)
    died = x["active"] & ~still
    rad2 = [np.asarray(r) for r in rad2]

    got_act = pool["act"].numpy()
    got_died = x["active"] & ~got_act
    assert np.sum(got_act != still) <= 2
    assert np.sum(got_died != died) <= 2
    agree = (got_act == still) & (got_died == died)
    np.testing.assert_array_equal(pool["bounce"].numpy(), bounce2)
    np.testing.assert_array_equal(pool["pix"].numpy(), x["pix"])
    want = dict(zip(STATE_F, (*map(np.asarray, o2), *map(np.asarray, d2),
                              *map(np.asarray, thr2), *rad2)))
    for n in STATE_F:
        np.testing.assert_allclose(pool[n].numpy()[agree], want[n][agree],
                                   rtol=2e-4, atol=2e-5, err_msg=n)

    if np.array_equal(got_died, died):
        # float32 scatter of art_tpu's died radiance
        want_fb = x["fb0"].astype(np.float64)
        np.add.at(want_fb, x["pix"][died], np.stack(rad2, 1)[died].astype(np.float64))
        np.testing.assert_allclose(fb.numpy(), want_fb, rtol=2e-4, atol=2e-4)
        # art_tpu's bf16 one-hot flush: within the bf16 rounding of the samples
        tpu = np.asarray(flush_accumulate(
            J(x["pix"]), J(died), tuple(map(J, rad2)), J(_fb_window(x["fb0"])),
            base=jnp.int32(0), interpret=True))
        bound = np.zeros((P, 3))
        np.add.at(bound, x["pix"][died], np.abs(np.stack(rad2, 1)[died]) * 2.0 ** -8)
        assert np.all(np.abs(_fb_window(fb.numpy()) - tpu)
                      <= _fb_window(bound) + 1e-5)


@pytest.mark.parametrize("name", ["three_spheres", "bouncing_spheres"])
@pytest.mark.parametrize("seed", [0, 7])
def test_shade_flush_matches_staged(name, seed):
    _run_case(name, seed)


def test_dead_slots_are_untouched():
    scene = build_scene("three_spheres", 32, 16)
    x = _random_inputs(3, frac_active=0.0)
    pool = {n: torch.from_numpy(v.copy()) for n, v in zip(
        STATE_F, (*x["o"], *x["d"], *x["thr"], *x["rad"]))}
    pool.update(bounce=torch.from_numpy(x["bounce"].copy()),
                pix=torch.from_numpy(x["pix"].copy()),
                act=torch.zeros(R, dtype=torch.bool))
    before = {k: v.clone() for k, v in pool.items()}
    hit = torch.ones(R, dtype=torch.bool)
    planes = {k: torch.full((R,), 0.5) for k in REC_F}
    fb = torch.from_numpy(x["fb0"].copy())
    lost = torch.zeros(1, dtype=torch.int32)
    shade_flush(pool, hit, planes, scene.background, fb, lost, max_depth=MAX_DEPTH,
                gradient=True)
    for k in pool:
        assert torch.equal(pool[k], before[k]), k
    assert torch.equal(fb, torch.from_numpy(x["fb0"])) and int(lost) == 0


def test_out_of_range_pixels_are_counted_not_added():
    """A dying slot whose pix lies outside [0, P) adds nothing to the
    framebuffer and counts into ``lost`` (the kernel does the same; the
    integrator raises on a nonzero count); in-range deaths still add."""
    scene = build_scene("three_spheres", 32, 16)
    x = _random_inputs(5, frac_active=1.0)
    pool = {n: torch.from_numpy(v.copy()) for n, v in zip(
        STATE_F, (*x["o"], *x["d"], *x["thr"], *x["rad"]))}
    pix = x["pix"].copy()
    pix[:4] = (-1, P, P + 7, -1000)
    pool.update(bounce=torch.full((R,), MAX_DEPTH - 1, dtype=torch.int32),
                pix=torch.from_numpy(pix), act=torch.ones(R, dtype=torch.bool))
    hit = torch.zeros(R, dtype=torch.bool)  # every ray misses and dies at max_depth
    planes = {k: torch.full((R,), 0.5) for k in REC_F}
    fb = torch.zeros((P, 3))
    lost = torch.zeros(1, dtype=torch.int32)
    shade_flush(pool, hit, planes, scene.background, fb, lost, max_depth=MAX_DEPTH,
                gradient=True)
    assert int(lost) == 4 and not bool(pool["act"].any())
    rad = torch.stack([pool[n] for n in ("r0", "r1", "r2")], dim=1).double()
    want = torch.zeros((P, 3), dtype=torch.float64)
    want.index_add_(0, torch.from_numpy(pix[4:]).long(), rad[4:])
    torch.testing.assert_close(fb.double(), want, rtol=1e-6, atol=1e-6)


def _baked_case(name, seed):
    """Random pool + both packages' hit records for a baked scene; origins
    spread over the scene (cornell_box's room is [0, 555]^3)."""
    x = _random_inputs(seed, frac_active=0.9)
    if name == "unrotated_boxes":
        jscene, scene = unrotated_scenes()
    else:
        jscene, scene = jax_build_scene(name, 96, 48), build_scene(name, 96, 48)
    if name == "cornell_box":
        x["o"] = (x["o"] * 69.0 + 277.5).astype(np.float32)
    pool = {n: torch.from_numpy(v.copy()) for n, v in zip(
        STATE_F, (*x["o"], *x["d"], *x["thr"], *x["rad"]))}
    pool.update(tm=torch.from_numpy(x["tm"].copy()),
                bounce=torch.from_numpy(x["bounce"].copy()),
                pix=torch.from_numpy(x["pix"].copy()),
                act=torch.from_numpy(x["active"].copy()))
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(scene.tables, o, d, pool["tm"], T_MIN)
    u = tuple(torch.from_numpy(x["u_ball"][c].copy()) for c in range(3)) + (
        torch.from_numpy(x["u_choice"].copy()),)
    return x, jscene, scene, pool, rec, u


def _shade(scene, pool, rec, u, fb0, baked):
    pool = {k: v.clone() for k, v in pool.items()}
    if baked:
        planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u)))
        specials = scene.tables.shade_consts[1]
        if specials:
            planes.update(zip(REC_SP, eval_special_p(
                scene.tables, specials, rec.mat, rec.u, rec.v, rec.p,
                valid=rec.hit & pool["act"])))
    else:
        mtype, fuzz, refidx, malb, texv = shade_params_p(scene.tables, rec)
        planes = dict(zip(REC_F, (*rec.p, *rec.normal, mtype, fuzz, refidx, *malb,
                                  *texv, *u)))
    fb = torch.from_numpy(fb0.copy())
    lost = torch.zeros(1, dtype=torch.int32)
    shade_flush(pool, rec.hit, planes, scene.background, fb, lost, max_depth=MAX_DEPTH,
                gradient=scene.gradient_bg,
                consts=scene.tables.shade_rows if baked else None)
    assert int(lost) == 0
    return pool, fb


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "unrotated_boxes",
                                  "perlin", "earth", "simple_light"])
def test_baked_twin_equals_plane_fed(name):
    x, _, scene, pool, rec, u = _baked_case(name, 3)
    assert scene.tables.shade_rows is not None
    a, fa = _shade(scene, pool, rec, u, x["fb0"], baked=False)
    b, fb = _shade(scene, pool, rec, u, x["fb0"], baked=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(fa, fb)
    assert int((pool["act"] & ~b["act"]).sum()) > 0  # some slots died and flushed


@pytest.mark.parametrize("name", ["three_spheres", "cornell_box", "unrotated_boxes",
                                  "perlin", "simple_light_book", "earth", "simple_light"])
def test_baked_matches_art_tpu_consts_kernel(name):
    x, jscene, scene, pool, rec, u = _baked_case(name, 8)
    got, fb = _shade(scene, pool, rec, u, x["fb0"], baked=True)
    noise = bool(scene.tables.shade_consts[1])

    J = jnp.asarray
    jt = jscene.tables
    o, d = tuple(map(J, x["o"])), tuple(map(J, x["d"]))
    jrec = jax_closest(jt, o, d, J(x["tm"]), T_MIN)
    state = dict(zip(STATE_F, (*o, *d, *map(J, x["thr"]), *map(J, x["rad"]))))
    state.update(bounce=J(x["bounce"]), pix=J(x["pix"]), act=J(x["active"].astype(np.int32)))
    rec_b = dict(px=jrec.p[0], py=jrec.p[1], pz=jrec.p[2], nx=jrec.normal[0],
                 ny=jrec.normal[1], nz=jrec.normal[2], mat=jrec.mat.astype(jnp.float32),
                 ub0=J(x["u_ball"][0]), ub1=J(x["u_ball"][1]), ub2=J(x["u_ball"][2]),
                 uch=J(x["u_choice"]))
    if noise:
        sp = jax_eval_special_p(jt, jt.shade_consts[1], jrec.mat, jrec.u, jrec.v, jrec.p,
                                valid=jrec.hit & J(x["active"]))
        rec_b.update(zip(REC_SP, sp))
    new, died, fb_k = jax_shade_flush(
        state, jrec.hit, rec_b, J(np.asarray(scene.background, np.float32)),
        J(_fb_window(x["fb0"])), jnp.int32(0), max_depth=MAX_DEPTH,
        gradient=scene.gradient_bg, consts=jt.shade_consts, interpret=True)

    still = np.asarray(new["act"]) != 0
    got_act = got["act"].numpy()
    assert np.sum(got_act != still) <= 2
    agree = got_act == still
    np.testing.assert_array_equal(got["bounce"].numpy(), np.asarray(new["bounce"]))
    for n in STATE_F:
        if noise:
            bad = ~np.isclose(got[n].numpy()[agree], np.asarray(new[n])[agree],
                              rtol=5e-3, atol=5e-4)
            assert int(bad.sum()) <= 8, (n, int(bad.sum()))
        else:
            np.testing.assert_allclose(got[n].numpy()[agree], np.asarray(new[n])[agree],
                                       rtol=2e-4, atol=2e-5, err_msg=n)
    if noise:  # some rays hit the marble and survived with its texture value
        hit_noise = (rec.mat == 0) & rec.hit & pool["act"]
        assert bool((got["t0"] != pool["t0"])[hit_noise].any())
    if agree.all() and not noise:
        # the TPU flush rounds each sample to bf16: within that rounding
        died = np.asarray(died)
        rad = np.stack([got[n].numpy() for n in ("r0", "r1", "r2")], 1)
        bound = np.zeros((P, 3))
        np.add.at(bound, x["pix"][died], np.abs(rad[died]) * 2.0 ** -8)
        assert np.all(np.abs(_fb_window(fb.numpy()) - np.asarray(fb_k))
                      <= _fb_window(bound) + 1e-5)
