"""The port's plain refill (K1, ops/refill_kernel.py) against art_tpu's
Pallas ``fused_refill`` in interpret mode, in the cases of
tests/test_refill_kernel.py (mixed pool, queue nearly exhausted, exhausted,
cold start, queue ids past the float32-exact range), plus the Philox
uniform source both K1 forms share.

Tolerances: integer planes, the take count and the queue head exactly;
float planes to 1e-6 (the two camera paths differ only in the last ulp of
sin/cos of the lens angle, scaled by the 0.05 lens radius)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.core.camera import make_camera as jax_make_camera
from art_tpu.ops.refill_kernel import fused_refill as jax_fused_refill
from art_tpu.ops.refill_kernel import pack_camera as jax_pack_camera
from art_tpu_torch.core.camera import make_camera, pack_camera
from art_tpu_torch.core.rng import philox4x32, philox_block
from art_tpu_torch.ops import refill_kernel as rk

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 16384
CAM = dict(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0), vfov_degrees=30.0,
           aspect=2.0, aperture=0.1, focus_dist=10.0, time0=0.0, time1=1.0)


def _random_state(seed, frac_active):
    rng = np.random.default_rng(seed)
    planes = {n: (rng.random(R, dtype=np.float32) * 7 - 3).astype(np.float32)
              for n in rk.POOL_F}
    planes["bounce"] = rng.integers(0, 50, R).astype(np.int32)
    planes["pix"] = rng.integers(0, 999, R).astype(np.int32)
    planes["act"] = (rng.random(R) < frac_active).astype(np.int32)
    block = rng.random((10, R), dtype=np.float32)
    return planes, block


def _run_case(seed, frac_active, next_q, spp=7, P=1000, pix_offset=64000,
              total_pixels=64800, nx=360, ny=180):
    planes, block = _random_state(seed, frac_active)
    cam_j = jax_make_camera(**CAM)
    cam = make_camera(**CAM)
    np.testing.assert_allclose(pack_camera(cam), np.asarray(jax_pack_camera(cam_j)),
                               rtol=1e-6, atol=1e-6)
    scal_j = jnp.asarray([next_q // spp, next_q % spp, spp, P, pix_offset,
                          total_pixels, nx, ny], jnp.int32)
    want, want_count = jax_fused_refill(
        {n: jnp.asarray(v) for n, v in planes.items()},
        tuple(jnp.asarray(block[c]) for c in range(4, 9)),
        jax_pack_camera(cam_j), scal_j, interpret=True)

    pool = {n: torch.from_numpy(v.copy()) for n, v in planes.items()}
    pool["act"] = pool["act"] != 0
    q = torch.tensor([next_q, -1], dtype=torch.int64)
    hist = torch.zeros(4, dtype=torch.int64)
    u_ball, u_choice, u_media = rk.fused_refill(
        pool, cam, q, 0, hist, 2, rk.RefillScal(spp, P, pix_offset, total_pixels, nx, ny),
        block=torch.from_numpy(block.copy()), ncols=10)

    assert int(q[1]) - next_q == int(want_count)
    assert int(q[0]) == next_q
    assert int(hist[2]) == int(np.sum(np.asarray(want["act"])))
    assert hist[[0, 1, 3]].eq(0).all()
    np.testing.assert_array_equal(pool["act"].numpy(), np.asarray(want["act"]) != 0)
    for n in rk.POOL_I:
        np.testing.assert_array_equal(pool[n].numpy(), np.asarray(want[n]), err_msg=n)
    for n in rk.POOL_F:
        np.testing.assert_allclose(pool[n].numpy(), np.asarray(want[n]), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    # the shade stage's uniforms are the injected block's rows
    for c in range(3):
        assert torch.equal(u_ball[c], torch.from_numpy(block[c]))
    assert torch.equal(u_choice, torch.from_numpy(block[3]))
    assert len(u_media) == 1 and torch.equal(u_media[0], torch.from_numpy(block[9]))


def test_refill_mixed_pool():
    _run_case(0, frac_active=0.4, next_q=123)


def test_refill_queue_nearly_exhausted():
    _run_case(1, frac_active=0.3, next_q=7 * 1000 - 500)


def test_refill_queue_exhausted():
    _run_case(2, frac_active=0.5, next_q=7 * 1000)


def test_refill_all_dead_cold_start():
    _run_case(3, frac_active=0.0, next_q=0)


def test_refill_large_queue_ids():
    _run_case(4, frac_active=0.4, next_q=411 * 65536 + 65000, spp=500, P=65536,
              pix_offset=0, total_pixels=960000, nx=1200, ny=800)


# Random123's known-answer vectors for Philox4x32-10 (kat_vectors)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(g) for g in got) == want


def test_philox_block_statistics():
    u = philox_block(1984, 3, 1, 7, 10, 1 << 17, "cpu")
    assert u.shape == (10, 1 << 17) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    mean, var = u.mean(dim=1), u.var(dim=1)
    assert torch.all((mean - 0.5).abs() < 0.005), mean
    assert torch.all((var - 1.0 / 12.0).abs() < 0.003), var
    # a new iteration, tile or chunk gives new numbers
    for other in (philox_block(1984, 3, 1, 8, 10, 1 << 17, "cpu"),
                  philox_block(1984, 4, 1, 7, 10, 1 << 17, "cpu"),
                  philox_block(1984, 3, 2, 7, 10, 1 << 17, "cpu")):
        assert float((other == u).float().mean()) < 1e-3


def test_philox_refill_draws_the_same_block():
    """The Philox form of K1 consumes and returns exactly philox_block's
    columns (the CUDA kernel derives the same bits in-kernel)."""
    planes, _ = _random_state(6, 0.5)
    cam = make_camera(**CAM)
    scal = rk.RefillScal(7, 1000, 0, 64800, 360, 180)

    def run(**src):
        pool = {n: torch.from_numpy(v.copy()) for n, v in planes.items()}
        pool["act"] = pool["act"] != 0
        q = torch.tensor([10, 0], dtype=torch.int64)
        out = rk.fused_refill(pool, cam, q, 0, torch.zeros(8, dtype=torch.int64), 5,
                              scal, ncols=10, **src)
        return pool, out

    pool_a, (ball_a, ch_a, med_a) = run(key=(1984, 2, 3))
    pool_b, (ball_b, ch_b, med_b) = run(block=philox_block(1984, 2, 3, 5, 10, R, "cpu"))
    for n in pool_a:
        assert torch.equal(pool_a[n], pool_b[n]), n
    assert all(torch.equal(a, b) for a, b in zip(ball_a + (ch_a,) + med_a,
                                                 ball_b + (ch_b,) + med_b))


def test_refill_needs_one_uniform_source():
    pool = rk.new_pool(256, "cpu")
    with pytest.raises(ValueError):
        rk.fused_refill(pool, make_camera(**CAM), torch.zeros(2, dtype=torch.int64), 0,
                        torch.zeros(1, dtype=torch.int64), 0,
                        rk.RefillScal(1, 256, 0, 256, 16, 16), ncols=10)
