"""The arithmetic of the H100 designs of K5 (``csrc/quad_hit.cu``: the
closest quad with its winner's attributes) and of the refill core shared by
K1, K11 and K12 (``csrc/refill.cuh``: one launch, a look-back scan), held on
the CPU on numpy-seeded inputs, bit for bit unless stated.

* (a) K5's twin ``quad_hit_attrs_plain`` equals the composition
  ``closest_surface_p`` made before (``quad_candidates_p``, then
  ``quad_attributes_p`` on the clamped index, then the miss masking), and a
  float32 model of the kernel's own operation order (``_kernel_order``),
  in all seven outputs, signed zeros included, on the tables of
  cornell_box, final_scene, simple_light and cornell_smoke, on rays that
  hit a quad, point away from one, run in a quad's plane (n.d = 0) and
  start on a quad, at t_min = T_MIN and 0.25.  On the same rays the twin
  meets art_tpu's quad block (the interpret-mode Pallas kernel and the jnp
  candidate pass, then its ``quad_attributes_p``), and ``closest_surface_p``
  meets art_tpu's (its jnp route, and at T_MIN its Pallas route in
  interpret mode, on the scenes without a sphere tail), at the tolerances of
  tests/test_torch_intersect.py: at most 2 hit flips in all, the material
  and a miss's normal exactly, and on the lanes a quad wins (the block that
  changed) p to 1e-5, normals to 1e-4 and (u, v) to 2e-6.  The lanes the
  other kinds win keep the tolerances of their own tests
  (tests/test_torch_intersect.py, test_torch_box_grid.py): these rays start
  on surfaces, where a sphere's near root or the grid's t rounds apart from
  art_tpu's by more than those bars allow for p.
* (b) ``fused_refill_plain`` gives the same planes, uniform rows, queue
  head and live count when columns 4..8 (jitter, lens, time) of every slot
  that takes nothing hold garbage, so the kernels' skipped Philox call
  (columns 4..7) is dead work; likewise ``sp_step_plain`` (K11's twin), with
  columns 0..3 of the slots dead after the refill garbage too.
* (c) ``refill_kernel.lookback_scan_p``, the model of the look-back scan,
  fed the blocks' dead counts in shuffled and adversarial step orders over
  a scratch left by an earlier call, yields the ranks and the queue head of
  ``fused_refill_plain``, for R not a multiple of 256, more than 32
  blocks (several look-back windows) and R = 0; ``scan_scratch`` keeps one
  zeroed scratch per pool and never hands out epoch 0 or the same epoch
  twice running.
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
from art_tpu_torch.core.camera import make_camera
from art_tpu_torch.core.vecmath import BIG, T_MIN, p_where
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.intersect import closest_surface_p, quad_attributes_p, quad_candidates_p
from art_tpu_torch.ops.sp_kernel import sp_step_plain

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = pk.RAY_BLOCK  # 8192: art_tpu's Pallas route takes whole ray blocks
QUAD_SCENES = ("cornell_box", "final_scene", "simple_light", "cornell_smoke")
# art_tpu's interpret-mode Pallas route of closest_surface_p; final_scene's
# (its 1000-row sphere tail and box grid) takes minutes to interpret
PALLAS_SCENES = ("cornell_box", "simple_light", "cornell_smoke")


@functools.lru_cache(maxsize=None)
def _scenes(name):
    return jax_build_scene(name, 32, 32), build_scene(name, 32, 32)


def _quad_rays(tables, seed):
    """R rays, a quarter of each kind: aimed at a random interior point of
    a random quad (hits), pointed away from it (mostly misses), in a quad's
    plane along its u edge (n.d = 0: the scenes' quads are axis-aligned),
    and from a point on a quad.  Returns (o, d, tm) as float32 numpy."""
    rng = np.random.default_rng(seed)
    q, u, v, n = (getattr(tables, f"quad_{k}").numpy().astype(np.float32)
                  for k in ("q", "u", "v", "n"))
    span = float(np.abs(q).max() + np.abs(u).max() + np.abs(v).max())
    k = rng.integers(0, q.shape[0], R)
    a, b = (rng.uniform(0.05, 0.95, (R, 1)).astype(np.float32) for _ in range(2))
    on = q[k] + a * u[k] + b * v[k]  # a point on quad k
    away = rng.normal(size=(R, 3)).astype(np.float32)
    away *= (span * rng.uniform(0.05, 0.8, (R, 1)) / np.linalg.norm(away, axis=1,
                                                                     keepdims=True))
    o, d = on + away, -away  # hits
    m = R // 4
    d[m:2 * m] = away[m:2 * m]  # away from the quad
    h = rng.uniform(-0.3, 0.3, (R, 1)).astype(np.float32) * span
    h[2 * m:2 * m + 64] = 0.0  # in the plane itself
    o[2 * m:3 * m] = (on + h * n[k])[2 * m:3 * m]  # in the quad's plane, along u
    d[2 * m:3 * m] = u[k][2 * m:3 * m] * rng.choice([-1.0, 1.0], (m, 1)).astype(np.float32)
    o[3 * m:] = on[3 * m:]  # from a point on the quad, anywhere
    d[3 * m:] = rng.normal(size=(R - 3 * m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)  # unit: p's error is t's
    tm = rng.uniform(0.0, 1.0, R).astype(np.float32)
    return (tuple(np.ascontiguousarray(o[:, c]) for c in range(3)),
            tuple(np.ascontiguousarray(d[:, c]) for c in range(3)), tm)


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def _jax(o, d, tm):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)


def _flat(res):
    """(t, normal, alpha, beta, mat) -> seven numpy arrays."""
    return [np.asarray(x) for x in (res[0], *res[1], res[2], res[3], res[4])]


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def _old_composition(tables, o, d, t_min):
    """The quad block of ``closest_surface_p`` before K5 wrote the winner's
    attributes: K5's (t, idx), then the glue."""
    t, idx = quad_candidates_p(tables, o, d, t_min)
    normal, alpha, beta, mat = quad_attributes_p(tables, o, d, t, idx.clamp_min(0))
    hit = t < BIG
    zero = torch.zeros_like(t)
    return (t, p_where(hit, normal, (torch.ones_like(t), zero, zero)),
            torch.where(hit, alpha, zero), torch.where(hit, beta, zero),
            torch.where(hit, mat, torch.zeros_like(mat)))


def _kernel_order(tables, o, d, t_min):
    """csrc/quad_hit.cu's winner attributes, operation by operation in
    float32 numpy (each product and sum rounded, sums left to right), on the
    candidate pass's (t, idx)."""
    t, idx = (x.numpy() for x in quad_candidates_p(tables, *_port(o, d, o[0])[:2], t_min))
    hit = idx >= 0
    a = tables.quad_attr_packed.numpy()[np.maximum(idx, 0)]
    with np.errstate(all="ignore"):
        plx = (o[0] + t * d[0]) - a[:, 0]
        ply = (o[1] + t * d[1]) - a[:, 1]
        plz = (o[2] + t * d[2]) - a[:, 2]
        u0, u1, u2, v0, v1, v2, w0, w1, w2, n0, n1, n2 = (a[:, c] for c in range(3, 15))
        c0, c1, c2 = ply * v2 - plz * v1, plz * v0 - plx * v2, plx * v1 - ply * v0
        e0, e1, e2 = u1 * plz - u2 * ply, u2 * plx - u0 * plz, u0 * ply - u1 * plx
        al = w0 * c0 + w1 * c1 + w2 * c2
        be = w0 * e0 + w1 * e1 + w2 * e2
        flip = n0 * d[0] + n1 * d[1] + n2 * d[2] > 0.0
    normal = [np.where(hit, np.where(flip, -n, n), np.float32(dflt))
              for n, dflt in ((n0, 1.0), (n1, 0.0), (n2, 0.0))]
    zero = np.float32(0.0)
    return [t, *normal, np.where(hit, al, zero), np.where(hit, be, zero),
            np.where(hit, a[:, 15].astype(np.int32), np.int32(0))]


def _assert_bits_equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (what, k)
        bad = int((_bits(g) != _bits(w)).sum())
        assert bad == 0, f"{what}: output {k}: {bad} values differ in bits"


@pytest.mark.parametrize("t_min", [T_MIN, 0.25])
@pytest.mark.parametrize("name", QUAD_SCENES)
def test_k5_twin_equals_the_old_composition_and_the_kernel_order(name, t_min):
    _, pscene = _scenes(name)
    tables = pscene.tables
    o, d, tm = _quad_rays(tables, 11)
    po, pd, _ = _port(o, d, tm)
    got = _flat(K.quad_hit_attrs_plain(tables, po, pd, t_min))
    _assert_bits_equal(got, _flat(_old_composition(tables, po, pd, t_min)), "composition")
    _assert_bits_equal(got, _kernel_order(tables, o, d, t_min), "kernel order")
    # the CPU wrapper is the twin
    _assert_bits_equal(_flat(K.quad_hit_attrs(tables, po, pd, t_min)), got, "wrapper")
    # every kind of ray took place: hits, misses, n.d == 0 exactly, origins
    # on a quad, and the normal's flip both ways
    hit = got[0] < BIG
    nd = (tables.quad_n.numpy()[None] * np.stack(d, 1)[:, None]).sum(-1)
    m = R // 4
    assert hit[:m].mean() > 0.5 and (~hit).sum() > R // 10
    assert (nd[2 * m:3 * m] == 0.0).any(axis=1).all()
    # (a scene of one quad: a ray from it meets no other)
    assert (tables.n_quads == 1 or hit[3 * m:].any()) and (got[0][hit] > t_min).all()
    idx = quad_candidates_p(tables, po, pd, t_min)[1].numpy()
    n_win = tables.quad_attr_packed.numpy()[idx[hit], 12:15]
    flipped = (np.stack(got[1:4], 1)[hit].view(np.int32) == (-n_win).view(np.int32)).all(1)
    assert flipped.any() and (~flipped).any()
    if t_min == 0.25:  # origins on a quad: no hit at t <= 0.25
        assert not (got[0][3 * m:] <= 0.25).any()


@pytest.mark.parametrize("name", QUAD_SCENES)
def test_k5_twin_meets_art_tpu_quad_block(name):
    """At T_MIN (the Pallas kernel bakes it): t and the hit set bit-equal to
    the interpret-mode Pallas kernel and to the jnp candidate pass; the
    winner's attributes from art_tpu's ``quad_attributes_p`` at the
    tolerances of tests/test_torch_intersect.py."""
    jscene, pscene = _scenes(name)
    jt = jscene.tables
    o, d, tm = _quad_rays(pscene.tables, 12)
    got = _flat(K.quad_hit_attrs_plain(pscene.tables, *_port(o, d, tm)[:2]))
    hit = got[0] < BIG
    jo, jd, _ = _jax(o, d, tm)
    kt, kidx = pk.quad_closest_hit_planar(jt.quad_packed, jo, jd, n_quads=jt.n_quads,
                                          interpret=True)
    ct, cidx = jax_intersect.quad_candidates_p(jt, jo, jd, T_MIN)
    for label, (rt, ridx) in (("pallas", (kt, kidx)), ("jnp", (ct, cidx))):
        np.testing.assert_array_equal(got[0], np.asarray(rt), err_msg=label)
        rn, ra, rb, rm = jax_intersect.quad_attributes_p(jt, jo, jd, rt,
                                                         jnp.maximum(ridx, 0))
        np.testing.assert_array_equal(got[6][hit], np.asarray(rm)[hit], err_msg=label)
        for c in range(3):
            np.testing.assert_allclose(got[1 + c][hit], np.asarray(rn[c])[hit], atol=1e-4,
                                       err_msg=label)
        np.testing.assert_allclose(got[4][hit], np.asarray(ra)[hit], atol=2e-6, err_msg=label)
        np.testing.assert_allclose(got[5][hit], np.asarray(rb)[hit], atol=2e-6, err_msg=label)


def _closest_meets(got, want, quad_t):
    """``quad_t``: the quad block's t; a lane whose closest t is it is a
    quad's (quads merge first, the other kinds only with a strict ``<``)."""
    agree = np.asarray(want.hit) == got.hit.numpy()
    assert np.sum(~agree) <= 2
    hit = agree & np.asarray(want.hit)
    np.testing.assert_array_equal(got.mat.numpy()[hit], np.asarray(want.mat)[hit])
    mask = hit & (got.t.numpy() == quad_t.numpy())
    assert mask.sum() > R // 10  # the rays really hit quads
    miss = agree & ~np.asarray(want.hit)
    for c in range(3):
        np.testing.assert_allclose(got.p[c].numpy()[mask], np.asarray(want.p[c])[mask],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.normal[c].numpy()[mask],
                                   np.asarray(want.normal[c])[mask], atol=1e-4)
        np.testing.assert_array_equal(got.normal[c].numpy()[miss],
                                      np.asarray(want.normal[c])[miss])
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy()[mask],
                                   np.asarray(getattr(want, k))[mask], atol=2e-6)


@pytest.mark.parametrize("t_min", [T_MIN, 0.25])
@pytest.mark.parametrize("name", QUAD_SCENES)
def test_closest_surface_meets_art_tpu_jnp(name, t_min):
    jscene, pscene = _scenes(name)
    o, d, tm = _quad_rays(pscene.tables, 13)
    got = closest_surface_p(pscene.tables, *_port(o, d, tm), t_min)
    quad_t = K.quad_hit_attrs_plain(pscene.tables, *_port(o, d, tm)[:2], t_min)[0]
    _closest_meets(got, jax_intersect.closest_surface_p(jscene.tables, *_jax(o, d, tm), t_min),
                   quad_t)


@pytest.mark.parametrize("name", PALLAS_SCENES)
def test_closest_surface_meets_art_tpu_pallas(name, monkeypatch):
    """art_tpu's Pallas route (every backend gate answering TPU, every
    pallas_call in interpret mode, as tests/test_differential.py runs it)."""
    jscene, pscene = _scenes(name)
    o, d, tm = _quad_rays(pscene.tables, 14)
    monkeypatch.setenv("ART_TPU_FORCE_PALLAS", "1")
    orig = pl_module.pallas_call

    def interpret(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl_module, "pallas_call", interpret)
    assert jax_intersect._use_pallas(R)
    want = jax_intersect.closest_surface_p(jscene.tables, *_jax(o, d, tm), T_MIN)
    quad_t = K.quad_hit_attrs_plain(pscene.tables, *_port(o, d, tm)[:2])[0]
    _closest_meets(closest_surface_p(pscene.tables, *_port(o, d, tm), T_MIN), want, quad_t)


# ---- (b) the camera's columns of a slot that takes nothing are dead ----

CAM = dict(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0), vfov_degrees=30.0,
           aspect=2.0, aperture=0.1, focus_dist=10.0, time0=0.0, time1=1.0)
RP = 4096  # pool slots of the refill cases


def _random_pool(rng, n, frac_active):
    pool = {k: torch.from_numpy((rng.random(n, dtype=np.float32) * 7 - 3).astype(np.float32))
            for k in rk.POOL_F}
    for k in ("t0", "t1", "t2", "r0", "r1", "r2"):
        pool[k].abs_()
    pool["bounce"] = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
    pool["pix"] = torch.from_numpy(rng.integers(0, 999, n).astype(np.int32))
    pool["act"] = torch.from_numpy(rng.random(n) < frac_active)
    return pool


def _garbage(rng, shape):
    g = rng.normal(scale=1e6, size=shape).astype(np.float32)
    g.flat[::7] = np.nan
    g.flat[3::11] = np.inf
    return torch.from_numpy(g)


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _refill(pool, block, next_q, scal):
    q = torch.tensor([next_q, -1], dtype=torch.int64)
    hist = torch.zeros(4, dtype=torch.int64)
    u = rk.fused_refill_plain(pool, make_camera(**CAM), q, 0, hist, 2, scal, block=block,
                              ncols=block.shape[0])
    return q, hist, u


def _pools_bit_equal(a, b):
    for k in rk.POOL_F:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k
    for k in rk.POOL_I + ("act",):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("frac_active,next_q,ncols", [
    (0.4, 0, 10), (0.4, 7 * 1000 - 900, 10), (0.0, 5, 12), (1.0, 0, 10), (0.7, 7000, 10)])
def test_refill_twin_ignores_camera_columns_of_untaken_slots(frac_active, next_q, ncols):
    rng = np.random.default_rng(21)
    base = _random_pool(rng, RP, frac_active)
    block = torch.from_numpy(rng.random((ncols, RP), dtype=np.float32))
    scal = rk.RefillScal(7, 1000, 64000, 64800, 360, 180)
    want_pool = _clone(base)
    want = _refill(want_pool, block, next_q, scal)
    taken = want_pool["act"] & ~base["act"]
    bad = block.clone()
    bad[4:9, ~taken] = _garbage(rng, (5, int((~taken).sum())))
    got_pool = _clone(base)
    got = _refill(got_pool, bad, next_q, scal)
    _pools_bit_equal(got_pool, want_pool)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    (wb, wc, wm), (gb, gc, gm) = want[2], got[2]
    for g, w in zip((*gb, gc, *gm), (*wb, wc, *wm)):
        assert torch.equal(g, w)
    if frac_active < 1.0 and next_q < 7000:
        assert 0 < int(taken.sum())
    if frac_active > 0.0:
        assert int((~taken).sum()) > 0


@pytest.mark.parametrize("name", ["quads", "perlin"])
def test_short_path_twin_ignores_unread_columns(name):
    """K11's twin: columns 4..8 of the slots that take nothing and columns
    0..3 of the slots dead after the refill hold garbage; the pool, queue
    head, live count, died, framebuffer and lost stay bit-equal."""
    rng = np.random.default_rng(22)
    scene = build_scene(name, 64, 32)
    base = _random_pool(rng, RP, 0.5)
    base["pix"].remainder_(64 * 32)
    block = torch.from_numpy(rng.random((10, RP), dtype=np.float32))
    scal = rk.RefillScal(4, 64 * 32, 0, 64 * 32, 64, 32)
    next_q = 4 * 64 * 32 - 1000  # the queue runs out: some dead slots stay dead

    def run(blk):
        pool = _clone(base)
        q = torch.tensor([next_q, -1], dtype=torch.int64)
        hist = torch.zeros(4, dtype=torch.int64)
        fb = torch.zeros((64 * 32, 3))
        lost = torch.zeros(1, dtype=torch.int32)
        died = sp_step_plain(pool, scene.camera, q, 0, hist, 2, scal, scene.tables,
                             scene.background, fb, lost, block=blk, ncols=10, max_depth=50,
                             gradient=scene.gradient_bg)
        return pool, q, hist, fb, lost, died

    want = run(block)
    refilled = _clone(base)
    _refill(refilled, block, next_q, scal)
    taken = refilled["act"] & ~base["act"]
    dead = ~refilled["act"]
    bad = block.clone()
    bad[4:9, ~taken] = _garbage(rng, (5, int((~taken).sum())))
    bad[0:4, dead] = _garbage(rng, (4, int(dead.sum())))
    got = run(bad)
    _pools_bit_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert int(taken.sum()) > 0 and int(dead.sum()) > 0


# ---- (c) the look-back scan ----

def _block_counts(dead, nb):
    pad = np.zeros(nb * 256, bool)
    pad[:dead.shape[0]] = dead
    return pad.reshape(nb, 256).sum(axis=1)


def _schedules(rng, nb):
    """Step orders: a shuffle, the reverse of ticket order (every block but
    the first spins until its predecessors publish), and random repeats."""
    return {"shuffled": rng.permutation(nb), "reversed": np.arange(nb)[::-1],
            "repeats": np.concatenate([rng.integers(0, max(nb, 1), 3 * nb),
                                       rng.permutation(nb)])}


@pytest.mark.parametrize("n", [0, 1, 255, 256, 1000, 5 * 256 + 17, 70 * 256 + 3])
def test_lookback_scan_model_gives_the_refill_ranks(n):
    rng = np.random.default_rng(n + 5)
    nb = -(-n // 256)
    act = rng.random(n) < 0.45
    if nb > 3:  # a block with every slot dead and one with none
        act[256:512] = False
        act[512:768] = True
    dead = ~act
    counts = _block_counts(dead, nb)
    # an earlier call's words (another epoch, other counts) in the scratch
    stale = rk.lookback_scan_p(rng.integers(0, 257, nb), rng.permutation(nb), epoch=6)[2]
    # the twin's ranks: with spp = 1, a pixel row a queue element, each
    # taken slot's pix is q0 + its rank; the queue runs out for the last slots
    for room in (n, int(dead.sum()) // 2):
        pool = _random_pool(rng, n, 0.0)
        pool["act"] = torch.from_numpy(act.copy())
        scal = rk.RefillScal(1, room, 0, max(room, 1), max(room, 1), 1)
        q, _, _ = _refill(pool, torch.from_numpy(rng.random((10, n), dtype=np.float32)), 0,
                          scal)
        rank = np.cumsum(dead) - dead
        taken = pool["act"].numpy() & dead
        np.testing.assert_array_equal(pool["pix"].numpy()[taken], rank[taken])
        np.testing.assert_array_equal(taken, dead & (rank < room))
        for label, order in _schedules(rng, nb).items():
            before, total, flags = rk.lookback_scan_p(counts, order, flags=stale, epoch=7)
            if n == 0:
                assert before == [] and total is None
                continue
            blk = np.arange(n) // 256
            in_block = np.cumsum(dead) - dead - np.repeat(
                np.concatenate([[0], np.cumsum(counts)[:-1]]), 256)[:n]
            model_rank = np.asarray(before)[blk] + in_block
            np.testing.assert_array_equal(model_rank[dead], rank[dead], err_msg=label)
            assert int(q[1]) == min(total, room), label
            # every word is this call's inclusive prefix
            assert all(int(w) >> 32 == 7 and int(w) & (3 << 30) == rk.PREFIX for w in flags)
            np.testing.assert_array_equal(np.asarray(flags) & rk.VALUE, np.cumsum(counts))


def test_scan_scratch_lives_with_the_pool():
    a, b = _random_pool(np.random.default_rng(3), 1000, 0.5), _random_pool(
        np.random.default_rng(4), 257, 0.5)
    sa, ea = rk.scan_scratch(a)
    assert sa.shape == (5,) and sa.dtype == torch.int64 and int(sa.abs().sum()) == 0
    sa[0] = 123  # a word the kernel left: kept, not cleared
    sa2, ea2 = rk.scan_scratch(a)
    assert sa2 is sa and int(sa2[0]) == 123
    sb, eb = rk.scan_scratch(b)
    assert sb is not sa and sb.shape == (3,)
    epochs = [ea, ea2, eb] + [rk.scan_scratch(a)[1] for _ in range(100)]
    assert all(0 < e < 1 << 32 for e in epochs)
    assert all(x != y for x, y in zip(epochs, epochs[1:]))
