"""K4's compaction form (``csrc/compact.cu``, ``compact_fetch.compact``),
held on the CPU on numpy-seeded inputs.

* (a) ``compact(..., plain=True)`` equals ``art_tpu``'s ``compact_ray_ids``
  (Pallas K4 in interpret mode, every slot: its capacity set to R = 8192)
  and the pipeline the compaction form replaced (the cumsum rank, K4's
  flush-form twin scattering the ray ids, ``needy.sum``, one
  ``index_select`` of the stacked planes) in ids, count, rank and payload,
  at needy shares 0, one lane, only the last lane, 1.6%, 30% and 100%.
* (b) A numpy model of the one-launch scheme (blocks of 256 taking their
  lanes in ticket order, warp ballots, the block prefix from
  ``refill_kernel.lookback_scan_p`` on a shuffled schedule, needy ids and
  payload to slot ``rank``, a zero from the m-th lane that is not needy to
  slot S - 1 - m, the last ticket's pad [cnt, cnt + S - R)) writes every
  slot exactly once and equals the twin, at R in {1, 129, 1000, 8192,
  131072}; a mutant without the pad fails at R = 1000.
* (c) ``sphere_hit_attrs_split(plain=True)`` on a small final_scene pool
  gives the same (t, normal, mat), bit for bit, when the compacted ray
  planes past the needy count are NaN (the kernel leaves them unspecified):
  with K2's tail, the occlusion gate and K16's tail-only call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import art_tpu.ops.compact_fetch as jcf
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import compact_fetch as cf
from art_tpu_torch.ops import compact_sphere as cs
from art_tpu_torch.ops import flush_kernel as fk
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops.refill_kernel import lookback_scan_p

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
BLOCK = 256
WARP = 32


def _needy(share: str, n: int = R, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    needy = np.zeros(n, bool)
    if share == "one lane":
        needy[rng.integers(n)] = True
    elif share == "last lane":
        needy[-1] = True
    elif share != "0":
        needy[rng.random(n) < float(share.rstrip("%")) / 100] = True
    return needy


def _planes(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=n).astype(np.float32)) for _ in range(6))


def _parent(needy: torch.Tensor, planes):
    """The pipeline the compaction form replaced, as the split ran it."""
    needy_i = needy.to(torch.int32)
    rank = torch.cumsum(needy_i, 0, dtype=torch.int32) - needy_i
    n = needy.shape[0]
    slots = torch.zeros((-(-n // 128), 128), dtype=torch.float32)
    ids = fk.flush_accumulate_plain(rank, needy, (torch.arange(n, dtype=torch.float32),),
                                    slots).view(-1).to(torch.int32)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    return ids, cnt, torch.stack(planes).index_select(1, ids), rank


@jax.jit
def _jax_ray_ids(needy):
    return jcf.compact_ray_ids(needy, R, interpret=True)


SHARES = ["0", "one lane", "last lane", "1.6%", "30%", "100%"]


@pytest.mark.parametrize("share", SHARES)
def test_twin_matches_art_tpu_and_the_parent_pipeline(share):
    needy = _needy(share)
    planes = _planes(R)
    t = torch.from_numpy(needy)
    ids, cnt, planes_k, rank = cf.compact(t, planes, want_rank=True, plain=True)
    n = int(needy.sum())
    assert ids.dtype == torch.int32 and ids.shape == (R,) and cnt.shape == (1,)
    assert int(cnt) == n and len(planes_k) == 6
    want = np.asarray(_jax_ray_ids(jnp.asarray(needy)))
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(ids.numpy()[:n], np.flatnonzero(needy))
    assert not ids.numpy()[n:].any()
    np.testing.assert_array_equal(rank.numpy(), np.cumsum(needy) - needy)
    p_ids, p_cnt, p_planes, p_rank = _parent(t, planes)
    assert torch.equal(ids, p_ids) and torch.equal(cnt, p_cnt) and torch.equal(rank, p_rank)
    for got, want_c in zip(planes_k, p_planes):
        assert torch.equal(got[:n], want_c[:n])
    # the CPU wrapper is the twin; the ids alone are compact_ray_ids
    a = cf.compact(t, planes)
    assert torch.equal(a[0], ids) and torch.equal(a[1], cnt) and a[3] is None
    assert torch.equal(cf.compact_ray_ids(t), ids)


def test_limits():
    with pytest.raises(ValueError, match="at most 6"):
        cf.compact(torch.ones(8, dtype=torch.bool), _planes(8) + _planes(8)[:1])
    ids, cnt, planes_k, rank = cf.compact(torch.zeros(0, dtype=torch.bool))
    assert ids.shape == (0,) and int(cnt) == 0 and planes_k == () and rank is None


# ---- (b) the one-launch scheme -----------------------------------------------

def compact_model(needy: np.ndarray, planes, *, pad: bool = True, seed: int = 0):
    """The kernel's writes in numpy: (ids, cnt, rank, payload, writes a
    slot).  Blocks take tickets in a shuffled start order; each takes the
    lanes ticket * 256 + thread, counts its needy lanes by warp ballots and
    finds its exclusive prefix by the look-back model; then every lane
    writes its slot, and the block with the last ticket the pad."""
    n = needy.shape[0]
    S = -(-n // 128) * 128
    nb = -(-n // BLOCK)
    ids = np.full(S, -7, np.int64)  # a sentinel no write leaves
    out = np.full((len(planes), S), np.nan, np.float32)
    rank = np.full(n, -7, np.int64)
    writes = np.zeros(S, np.int64)
    counts, in_block = [], []
    for blk in range(nb):
        lanes = needy[blk * BLOCK:(blk + 1) * BLOCK]
        flag = np.zeros(BLOCK, bool)
        flag[:lanes.shape[0]] = lanes
        ballots = flag.reshape(-1, WARP)  # a warp's ballot
        warp_cnt = ballots.sum(axis=1)
        below = np.concatenate([[0], np.cumsum(warp_cnt)[:-1]])  # the warps before
        lane_rank = np.concatenate([np.cumsum(b) - b for b in ballots])  # popc below
        in_block.append(np.repeat(below, WARP) + lane_rank)
        counts.append(int(warp_cnt.sum()))
    schedule = np.random.default_rng(seed).permutation(nb)
    before, total, _ = lookback_scan_p(counts, schedule)
    for blk in schedule:  # the order blocks run in
        i = np.arange(blk * BLOCK, min((blk + 1) * BLOCK, n))
        k = before[blk] + in_block[blk][:i.shape[0]]
        rank[i] = k
        nd = needy[i]
        ids[k[nd]] = i[nd]
        np.add.at(writes, k[nd], 1)
        for c, p in enumerate(planes):
            out[c, k[nd]] = p[i[nd]]
        m = i[~nd] - k[~nd]  # the m-th lane that is not needy
        ids[S - 1 - m] = 0
        np.add.at(writes, S - 1 - m, 1)
        if blk == nb - 1 and pad:  # the last ticket knows the count
            ids[total:total + S - n] = 0
            np.add.at(writes, np.arange(total, total + S - n), 1)
    return ids, total, rank, out, writes


@pytest.mark.parametrize("n", [1, 129, 1000, 8192, 131072])
def test_model_writes_every_slot_once_and_equals_the_twin(n):
    needy = np.random.default_rng(n).random(n) < 0.3
    needy[0] = n % 2 == 0
    planes = [p.numpy() for p in _planes(n, seed=n)]
    ids, cnt, rank, out, writes = compact_model(needy, planes, seed=n)
    assert (writes == 1).all()
    t_ids, t_cnt, t_planes, t_rank = cf.compact(torch.from_numpy(needy),
                                                tuple(map(torch.from_numpy, planes)),
                                                want_rank=True, plain=True)
    np.testing.assert_array_equal(ids, t_ids.numpy())
    assert cnt == int(t_cnt) and cnt == int(needy.sum())
    np.testing.assert_array_equal(rank, t_rank.numpy())
    for got, want in zip(out, t_planes):
        np.testing.assert_array_equal(got[:cnt], want.numpy()[:cnt])


def test_model_without_the_pad_leaves_slots_unwritten():
    needy = np.random.default_rng(5).random(1000) < 0.3
    ids, cnt, _, _, writes = compact_model(needy, [], pad=False)
    assert (writes[cnt:cnt + 24] == 0).all() and (ids[cnt:cnt + 24] == -7).all()
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(ids, cf.compact(torch.from_numpy(needy))[0].numpy())


# ---- (c) the split ignores the payload past the count --------------------------

def _pool(t, n: int = 2048, seed: int = 40):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-500.0, 900.0, (3, n)).astype(np.float32)
    box = np.asarray(t.sph_tail_box, np.float32)
    target = (box[:3, None] + box[3:, None]) / 2 + rng.uniform(-0.4, 0.4, (3, n)) * (
        box[3:, None] - box[:3, None])
    d = np.where(rng.random(n) < 0.3, target - o, rng.normal(size=(3, n))).astype(np.float32)
    tm = rng.random(n, dtype=np.float32)
    return (tuple(torch.from_numpy(x) for x in o), tuple(torch.from_numpy(x) for x in d),
            torch.from_numpy(tm))


@pytest.fixture(scope="module")
def final_scene():
    return build_scene("final_scene", 16, 16).tables


@pytest.mark.parametrize("variant", ["K2 tail", "occlusion gate", "K16 tail-only"])
def test_split_ignores_the_payload_past_the_count(final_scene, monkeypatch, variant):
    t = final_scene
    o, d, tm = _pool(t)
    kw = dict(plain=True)
    if variant == "occlusion gate":
        kw["occ_t"] = torch.from_numpy(
            np.random.default_rng(3).uniform(0, 2000, tm.shape[0]).astype(np.float32))
    if variant == "K16 tail-only":
        kw["skip_tail"] = True
    want = cs.sphere_hit_attrs_split(t, o, d, tm, **kw)
    compact, seen = cf.compact, []

    def nan_past_count(needy, planes=(), **k):
        ids, cnt, planes_k, rank = compact(needy, planes, **k)
        n = int(cnt)
        seen.append(n)
        return ids, cnt, tuple(torch.cat([p[:n], torch.full_like(p[n:], float("nan"))])
                               for p in planes_k), rank

    monkeypatch.setattr(cf, "compact", nan_past_count)
    got = cs.sphere_hit_attrs_split(t, o, d, tm, **kw)
    assert len(seen) == 1 and 50 < seen[0] < 2048
    for a, b in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert torch.equal(a, b)
    full = K.sphere_hit_attrs_plain(t, o, d, tm, T_MIN)
    if variant == "K2 tail":  # the split is K2 over every row here (no exact ties)
        for a, b in zip([got[0], *got[1], got[2]], [full[0], *full[1], full[2]]):
            assert torch.equal(a, b)
