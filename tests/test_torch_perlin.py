"""The port's Perlin noise (ops/perlin.py) and turbulence (K7's twin,
ops/perlin_kernel.py) against art_tpu's jnp ``perlin`` module and its
Pallas ``turb_pallas`` in interpret mode, plus the noise texture leaves of
``texture_eval`` and its felt special leaf (R = 8192, inputs from a numpy
seed).

Tolerances: the uint32 hashes (wanghash, mix3 with negative lattice
coordinates, u2m11) bit for bit.  Noise and turbulence to 2e-6 absolute
(|turb| < 2): both sides round the same float32 operations, but XLA may
rewrite 1/sqrt as an approximate rsqrt (ROADMAP §3), and the Pallas
kernel's interpret mode rounds one step differently (measured: 1 ulp).
The marble texture, which adds a sin, to 1e-5.  Lanes with |p| >= 2^30 are
compared with the port's own definition only: there the float-to-int cast
of floor(p) is undefined in C++, and the port saturates it explicitly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import perlin as JP
from art_tpu.ops import texture_eval as jax_texture_eval
from art_tpu.ops.perlin_kernel import turb_pallas
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import _build, perlin, texture_eval
from art_tpu_torch.ops.perlin_kernel import turb

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
ATOL = 2e-6


def _points(seed, lo=-20.0, hi=20.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (3, R)).astype(np.float32)


def test_wanghash_bit_equal():
    x = np.random.default_rng(0).integers(0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JP.wanghash(jnp.asarray(x))).astype(np.int64)
    got = perlin.wanghash(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_mix3_bit_equal_with_negative_coordinates():
    xyz = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, (3, R)).astype(np.int32)
    assert (xyz < 0).any()
    want = np.asarray(JP.mix3(*map(jnp.asarray, xyz))).astype(np.int64)
    got = perlin.mix3(*map(torch.from_numpy, xyz)).numpy()
    np.testing.assert_array_equal(got, want)


def test_u2m11_bit_equal():
    h = np.random.default_rng(2).integers(0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JP.u2m11(jnp.asarray(h)))
    got = perlin.u2m11(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_grad_is_unit_and_matches_art_tpu():
    ijk = np.random.default_rng(3).integers(-1000, 1000, (3, R)).astype(np.int32)
    want = np.stack([np.asarray(g) for g in JP.grad_p(*map(jnp.asarray, ijk))])
    got = np.stack([g.numpy() for g in perlin.grad_p(*map(torch.from_numpy, ijk))])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed,lo,hi", [(4, -20.0, 20.0), (5, -1e5, 1e5)])
def test_noise_matches_art_tpu(seed, lo, hi):
    p = _points(seed, lo, hi)
    want = np.asarray(JP.noise_p(*map(jnp.asarray, p)))
    got = perlin.noise_p(*map(torch.from_numpy, p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("depth,masked", [(7, False), (2, False), (7, True), (2, True)])
def test_turb_matches_art_tpu_and_pallas(depth, masked):
    p = _points(6 + depth)
    mask = np.random.default_rng(depth).integers(0, 8, R).astype(np.int32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(JP.turb_p(*map(jnp.asarray, p), depth, depth_mask=jmask))
    pallas = np.asarray(turb_pallas(*map(jnp.asarray, p), depth, jmask, interpret=True))
    got = perlin.turb_p(*map(torch.from_numpy, p), depth,
                        depth_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    assert (got >= 0).all() and got.max() > 0.1
    if masked:  # a lane with mask 0 has no octave
        assert (got[mask == 0] == 0).all()


def test_lattice_saturates_far_and_nan_points():
    """A miss's point (|p| ~ 1e30), NaN and |p| past 2^31 take the
    saturated lattice coordinate on every device; ordinary points keep
    art_tpu's."""
    f = torch.tensor([1e30, -1e30, float("nan"), 3e9, -3e9, 2147483520.0, -2147483648.0,
                      5.0, -5.0])
    got = perlin._lattice(f).tolist()
    assert got == [2 ** 31 - 1, -2 ** 31, -2 ** 31, 2 ** 31 - 1, -2 ** 31, 2147483520,
                   -2 ** 31, 5, -5]
    p = torch.full((3, 4), 1e30)
    assert torch.isfinite(perlin.turb_p(*p, 7)).all()


def test_turb_wrapper_takes_the_twin_on_cpu():
    p = [torch.from_numpy(c) for c in _points(9)]
    mask = torch.from_numpy(np.random.default_rng(9).integers(0, 8, R).astype(np.int32))
    before = dict(_build.launches)
    assert torch.equal(turb(*p, 7), perlin.turb_p(*p, 7))
    assert torch.equal(turb(*p, 7, mask), perlin.turb_p(*p, 7, depth_mask=mask))
    assert dict(_build.launches) == before  # no kernel launch on the CPU


def _hits_on_perlin(seed):
    """Points on and near perlin's spheres (the marble texture's domain)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-6.0, 6.0, (3, R)).astype(np.float32)
    p[1] = np.abs(p[1])
    mat = np.zeros(R, np.int32)
    return p, mat


def test_eval_texture_noise_leaf_matches_art_tpu():
    """The plane-fed noise leaf of eval_texture_p on perlin's tables."""
    jt, t = jax_build_scene("perlin", 96, 48).tables, build_scene("perlin", 96, 48).tables
    p, _ = _hits_on_perlin(10)
    tex_id = np.zeros(R, np.int32)
    z = np.zeros(R, np.float32)
    want = jax_texture_eval.eval_texture_p(jt, jnp.asarray(tex_id), jnp.asarray(z),
                                           jnp.asarray(z), tuple(map(jnp.asarray, p)))
    got = texture_eval.eval_texture_p(t, torch.from_numpy(tex_id), torch.from_numpy(z),
                                      torch.from_numpy(z), tuple(map(torch.from_numpy, p)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert 0.0 <= float(got[0].min()) and float(got[0].max()) <= 1.0


@pytest.mark.parametrize("name", ["perlin", "simple_light_book"])
def test_eval_special_noise_matches_art_tpu(name):
    """eval_special_p's noise leaf: the marble value on the noise material,
    0 on every other material (simple_light_book's lights)."""
    jscene, scene = jax_build_scene(name, 96, 48), build_scene(name, 96, 48)
    specials = scene.tables.shade_consts[1]
    p, _ = _hits_on_perlin(11)
    mat = np.random.default_rng(11).integers(0, scene.tables.mat_type.shape[0], R).astype(
        np.int32)
    z = np.zeros(R, np.float32)
    want = jax_texture_eval.eval_special_p(jscene.tables, specials, jnp.asarray(mat),
                                           jnp.asarray(z), jnp.asarray(z),
                                           tuple(map(jnp.asarray, p)))
    got = texture_eval.eval_special_p(scene.tables, specials, torch.from_numpy(mat),
                                      torch.from_numpy(z), torch.from_numpy(z),
                                      tuple(map(torch.from_numpy, p)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    noise_ids = [s[0] for s in specials]
    assert (got[0].numpy()[~np.isin(mat, noise_ids)] == 0).all()
    assert (got[0].numpy()[np.isin(mat, noise_ids)] > 0).any()


def test_special_leaves_of_later_slices_raise():
    """The felt leaf that raised before its slice (M10) now evaluates on
    perlin's hit points: art_tpu's value within 1e-5 on the felt material,
    its gain clamped to [0.7, 1.2], and 0 on every other material."""
    jt, t = jax_build_scene("perlin", 32, 16).tables, build_scene("perlin", 32, 16).tables
    felt = ((1, "felt", 16.0, 0.5, 4.0, 0.5, (0.2, 0.4, 0.6)),)
    p, _ = _hits_on_perlin(12)
    mat = np.random.default_rng(12).integers(0, 2, R).astype(np.int32)
    z = np.zeros(R, np.float32)
    want = jax_texture_eval.eval_special_p(jt, felt, jnp.asarray(mat), jnp.asarray(z),
                                           jnp.asarray(z), tuple(map(jnp.asarray, p)))
    got = texture_eval.eval_special_p(t, felt, torch.from_numpy(mat), torch.from_numpy(z),
                                      torch.from_numpy(z), tuple(map(torch.from_numpy, p)))
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
        on = g.numpy()[mat == 1]
        base = felt[0][6][c]
        assert (on >= 0.7 * base - 1e-6).all() and (on <= 1.2 * base + 1e-6).all()
        assert not g.numpy()[mat != 1].any()
