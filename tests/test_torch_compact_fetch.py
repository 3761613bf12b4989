"""The compacted image fetch and its two kernels' plain twins against art_tpu.

* K4's twin (``flush_kernel.flush_accumulate_plain``) against art_tpu's
  ``flush_accumulate`` in interpret mode: exact for a compaction payload
  (art_tpu's byte-split channels, each slot one add); on a colliding flush
  with values pre-rounded to bf16 (so the TPU's bf16 operands are exact)
  within 1e-6 relative, since the two sum each pixel in another order; lanes
  outside the window ``[base, base + n_hi)`` add nothing.
* K8's twin (``table_gather_u24_plain``) against ``table_gather_u24`` in
  interpret mode: exact, out-of-range indices included.
* ``compact_gather`` and ``compact_ray_ids`` against art_tpu's, exactly, at
  needy counts that take each of art_tpu's three tiers (``k=128`` and a
  patched ``WFETCH_K``, as tests/test_compact_fetch.py:207-255), 0 and every
  lane included.

Inputs come from a numpy seed at R = 8192 (one TPU flush block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import art_tpu.ops.compact_fetch as jcf
from art_tpu.ops.flush_kernel import flush_accumulate as jax_flush
from art_tpu.ops.flush_kernel import table_gather_u24 as jax_table_gather
from art_tpu_torch.ops import compact_fetch as cf
from art_tpu_torch.ops import flush_kernel as fk

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
T = 1 << 19  # an atlas span that uses all three bytes of an index


def _t(x):
    return torch.from_numpy(np.array(x))


def _needy(rng, count):
    needy = np.zeros(R, bool)
    needy[rng.choice(R, count, replace=False)] = True
    return needy


def test_flush_twin_exact_on_a_compaction_payload():
    """art_tpu's wide-tier compaction: pix = rank, died = needy, the three
    byte channels of the flat texel index; every slot takes one add, so both
    are exact."""
    rng = np.random.default_rng(0)
    needy = _needy(rng, 3000)
    rank = (np.cumsum(needy) - needy).astype(np.int32)
    flat = rng.integers(0, T, R).astype(np.int32)
    chans = [((flat >> s) & 0xFF).astype(np.float32) for s in (0, 8, 16)]
    fb0 = np.zeros((R // 128, 3 * 128), np.float32)
    want = np.asarray(jax_flush(jnp.asarray(rank), jnp.asarray(needy),
                                tuple(map(jnp.asarray, chans)), jnp.asarray(fb0),
                                interpret=True))
    got = fk.flush_accumulate(_t(rank), _t(needy), tuple(map(_t, chans)), _t(fb0.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flush_twin_colliding_window():
    """A colliding 3-channel flush into a window at base row 5: values
    rounded to bf16 first, positive (no cancelling sums); lanes whose row
    lies outside the window, or that did not die, add nothing."""
    rng = np.random.default_rng(1)
    n_hi, base = 12, 5
    pix = rng.integers(0, (n_hi + 10) * 128, R).astype(np.int32)  # rows 0..21
    pix[:16] = rng.integers(-(1 << 20), 0, 16)  # negative: far outside (logical shift)
    died = rng.random(R) < 0.7
    vals = [np.asarray(jnp.asarray(rng.random(R, dtype=np.float32) * 3.0)
                       .astype(jnp.bfloat16).astype(jnp.float32)) for _ in range(3)]
    fb0 = rng.random((n_hi, 384), dtype=np.float32)
    want = np.asarray(jax_flush(jnp.asarray(pix), jnp.asarray(died),
                                tuple(map(jnp.asarray, vals)), jnp.asarray(fb0),
                                base=jnp.int32(base), interpret=True))
    got = fk.flush_accumulate(_t(pix), _t(died), tuple(map(_t, vals)), _t(fb0.copy()),
                              base=torch.tensor([base], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the same sum in float64 over the lanes inside the window only
    hi = (pix.astype(np.int64) & 0xFFFFFFFF) >> 7
    ok = died & (hi >= base) & (hi < base + n_hi)
    ref = fb0.astype(np.float64)
    for c in range(3):
        np.add.at(ref, (hi[ok] - base, c * 128 + (pix[ok] & 127)), vals[c][ok])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert ok.sum() < died.sum()  # some dying lanes fell outside


@pytest.mark.parametrize("n_chan", [1, 6])
def test_flush_accumulate_on_cpu_is_the_twin(n_chan):
    rng = np.random.default_rng(2)
    pix = _t(rng.integers(0, 4 * 128, 1000).astype(np.int32))
    died = _t(rng.random(1000) < 0.5)
    vals = tuple(_t(rng.random(1000, dtype=np.float32)) for _ in range(n_chan))
    a = fk.flush_accumulate(pix, died, vals, torch.zeros(4, n_chan * 128))
    b = fk.flush_accumulate_plain(pix, died, vals, torch.zeros(4, n_chan * 128))
    assert torch.equal(a, b) and float(a.sum()) > 0
    with pytest.raises(ValueError, match="channels"):
        fk.flush_accumulate(pix, died, vals * 7, torch.zeros(4, 7 * n_chan * 128))


def test_table_gather_twin_matches_art_tpu():
    rng = np.random.default_rng(3)
    n = 4096
    table = rng.integers(0, 1 << 24, n).astype(np.int32)
    idx = rng.integers(0, n, R).astype(np.int32)
    idx[:64] = rng.integers(-(1 << 30), 0, 64)
    idx[64:128] = rng.integers(n, 1 << 30, 64)
    idx[128:136] = (n, n + 1, n + 127, n + 128, -1, -128, 0, n - 1)
    want = np.asarray(jax_table_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = fk.table_gather_u24(_t(table), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and not got[:128].any() and got[134] == table[0]


def test_table_gather_empty_table():
    assert not fk.table_gather_u24(torch.zeros(0, dtype=torch.int32),
                                   torch.arange(5, dtype=torch.int32)).any()


# needy counts: 0, the compact tier (<= k = 128), the wide tier (<= the
# patched WFETCH_K = 1024), the dense tier, and every lane
COUNTS = [0, 128, 129, 1024, 1025, R]


@jax.jit
def _jax_compact_gather(data, flat, needy):
    """art_tpu's compact_gather at k = 128, traced once (with WFETCH_K
    patched to 1024 by the first caller) for every count."""
    return jcf.compact_gather(data, flat, needy, k=128, max_value_bits=24, interpret=True)


@pytest.mark.parametrize("count", COUNTS)
def test_compact_gather_matches_art_tpu(monkeypatch, count):
    monkeypatch.setattr(jcf, "WFETCH_K", 1024)
    rng = np.random.default_rng(count)
    needy = _needy(rng, count)
    flat = rng.integers(0, T, R).astype(np.int32)
    flat[~needy] = rng.integers(-(1 << 30), 1 << 30, int((~needy).sum()))  # any value
    data = (np.arange(T, dtype=np.uint32) * np.uint32(2654435761)) & np.uint32(0xFFFFFF)
    want = np.asarray(_jax_compact_gather(jnp.asarray(data), jnp.asarray(flat),
                                          jnp.asarray(needy)))
    got = cf.compact_gather(_t(data.astype(np.int32)), _t(flat), _t(needy)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    np.testing.assert_array_equal(got[needy], data[flat[needy]].astype(np.int32))
    assert not got[~needy].any()


@jax.jit
def _jax_ray_ids(needy):
    return jcf.compact_ray_ids(needy, 1024, interpret=True)


@pytest.mark.parametrize("count", [0, 500, 1024, 2000, R])
def test_compact_ray_ids_match_art_tpu(count):
    """art_tpu's (k,) slots at k = 1024 are the port's first k (past its
    capacity art_tpu drops the lanes of rank >= k; the port has no such
    lanes); the port's slots past the needy count hold 0."""
    k = 1024
    rng = np.random.default_rng(10 + count)
    needy = _needy(rng, count)
    want = np.asarray(_jax_ray_ids(jnp.asarray(needy)))
    got = cf.compact_ray_ids(_t(needy)).numpy()
    assert got.shape == (R,)
    n = min(count, k)
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:count], np.flatnonzero(needy))
    assert not got[count:].any()


def test_compact_gather_odd_pool_size():
    """Any R works: capacity rounds up to a multiple of 128."""
    rng = np.random.default_rng(4)
    n = 1000
    needy = rng.random(n) < 0.4
    flat = rng.integers(0, 5000, n).astype(np.int32)
    data = rng.integers(0, 1 << 24, 5000).astype(np.int32)
    got = cf.compact_gather(_t(data), _t(flat), _t(needy)).numpy()
    np.testing.assert_array_equal(got, np.where(needy, data[flat], 0))
    assert cf.compact_ray_ids(_t(needy)).shape == (1024,)
