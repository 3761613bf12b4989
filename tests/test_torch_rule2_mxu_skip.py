"""The arithmetic of the H100 designs of K14 (``csrc/sphere_mxu.cu``: two
rays a thread, roots only where disc > 0, two parts merged by first index)
and K16 (``csrc/sphere.cuh`` spread_hit: a ray tile's bins split across
the grid, merged by a (t, row) key), held on the CPU on numpy-seeded inputs
against the plain twins, bit for bit.

* (a) ``intersect_kernels.spread_scan_p``, the model of K16's order, takes
  the (tile, segment) blocks in the list's, reversed and shuffled orders
  and equals ``culled_plain`` (K16's twin) in t, normal and material, signed
  zeros included, on final_scene's skip table (the port's builder; R =
  4096), with ``n_live``, with ``head=False`` and at t_min = 0.25; and on a
  synthetic table where one sphere sits in the head and in two bins under
  three materials, so that exact ties between segments occur and the
  earlier row wins.  Every live tile reaches its ticket sum exactly once.
* (b) ``order_key`` orders as float32 ``<`` (then by row) on random finite
  floats of both signs, subnormals, +-0, BIG and +-inf, and ``key_t``
  round-trips every value but -0, which decodes as +0; ``MISS_KEY``
  decodes to exactly BIG with the row 0xffffffff.
* (c) A model of K14 that computes the root only where disc > 0 and merges
  its two parts by (t, index) equals ``sphere_mxu_hit_attrs_plain`` on
  bouncing_spheres' features and on final_scene's recentered MXU tail,
  with rays through the origin aimed at the pad rows, and with NaN and
  infinite planes.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN, sqrt
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 4096
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    return {n: build_scene(n, 16, 16).tables for n in ("final_scene", "bouncing_spheres")}


def _port(o, d, tm):
    return (tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in o),
            tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in d),
            torch.from_numpy(np.ascontiguousarray(tm)))


def _aimed(seed, box, share, span, n=R):
    """``n`` rays from origins uniform in ``span``: a ``share`` of them
    aimed within 0.4 of ``box``'s extent of its centre, the rest in normal
    directions (tests/test_torch_cull.py's rays)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(*span, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    lo, hi = np.asarray(box[:3])[:, None], np.asarray(box[3:])[:, None]
    target = (lo + hi) / 2 + rng.uniform(-0.4, 0.4, (3, n)) * (hi - lo)
    d = np.where(rng.random(n) < share, target - o, d).astype(np.float32)
    return o, d, rng.random(n, dtype=np.float32)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want):
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        assert torch.equal(_bits(a), _bits(b))


def _orders(n_blocks, seed):
    rng = np.random.default_rng(seed)
    return {"list": None, "reversed": list(range(n_blocks))[::-1],
            "shuffled": list(rng.permutation(n_blocks))}


def _n_blocks(meta, n, bins):
    return -(-n // 256) * (1 + -(-len(meta[1]) // bins))


# ---- (a) K16's order ---------------------------------------------------------

CASES = {"head": dict(), "n_live": dict(n_live=1500), "no head": dict(head=False),
         "t_min 0.25": dict(t_min=0.25), "n_live, the pool's bins": dict(n_live=1500, bins=4),
         "a bin a block": dict(bins=1), "every bin in one block": dict(bins=16)}


@pytest.mark.parametrize("case", list(CASES))
def test_spread_order_equals_culled_twin(tables, case):
    t = tables["final_scene"]
    kw = dict(CASES[case])
    t_min = kw.pop("t_min", T_MIN)
    n = kw.get("n_live", R)
    bins = kw.get("bins", K.SKIP_BINS if "n_live" not in kw else K.SKIP_BINS_LIVE)
    if "n_live" in kw:
        kw["n_live"] = torch.tensor([n], dtype=torch.int32)
    rays = _port(*_aimed(11, t.sph_skip_bins[2], 0.5, (-500.0, 900.0)))
    want = K.culled_plain(t.sph_skip_rows, t.sph_skip_bins, *rays, t_min, occlusion=False,
                          head=kw.get("head", True), n_live=kw.get("n_live"))
    assert int((want[0] < BIG).sum()) > n // 4  # the cluster and the head are hit
    for label, order in _orders(_n_blocks(t.sph_skip_bins, n, bins), 12).items():
        got, last = K.spread_scan_p(t.sph_skip_rows, t.sph_skip_bins, *rays, t_min,
                                    order=order, **kw)
        _assert_same(got, want)
        assert sorted(last) == list(range(-(-n // 256))), label


def _tie_table():
    """chip_smoke.py's tie table: sphere A in the head and in two bins under
    materials 1, 2, 3, the bins' boxes as pack_skip's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._tie_table()


@pytest.mark.parametrize("head", [True, False])
def test_spread_ties_go_to_the_earlier_row(head):
    rows, meta = _tie_table()
    rng = np.random.default_rng(21)
    n = 1024
    o = rng.uniform(-20.0, 20.0, (3, n)).astype(np.float32)
    d = (rng.uniform(-0.5, 0.5, (3, n)) - o).astype(np.float32)  # at A
    rays = _port(o, d, rng.random(n, dtype=np.float32))
    want = K.culled_plain(rows, meta, *rays, T_MIN, occlusion=False, head=head)
    on_a = want[0] < BIG
    # exact ties: A's copies give the same t, and the earliest copy's
    # material is the twin's
    t_all = K.sphere_row_t_p(rows, *rays, T_MIN)
    copies = [1, 3, 5] if head else [3, 5]
    tie = (t_all[:, copies] == t_all[:, copies[:1]]).all(dim=1) & (t_all[:, copies[0]] < BIG)
    assert int(tie.sum()) > n // 2
    first = 1 if head else 2
    assert (want[2][tie & (want[0] == t_all[:, copies[0]])] == first).all()
    for label, order in _orders(_n_blocks(meta, n, K.SKIP_BINS), 22).items():
        got, last = K.spread_scan_p(rows, meta, *rays, T_MIN, head=head, order=order)
        _assert_same(got, want)
        assert sorted(last) == list(range(n // 256)), label
    assert bool(on_a.any())


# ---- (b) the key map ---------------------------------------------------------

def _floats(seed, n=20000):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = x[np.isfinite(x)]
    special = np.array([0.0, -0.0, BIG, -BIG, np.inf, -np.inf, 1e-45, -1e-45, 1e-38,
                        T_MIN, 2 * T_MIN, 1.0, -1.0], np.float32)
    return np.concatenate([x, special, rng.normal(0, 10, 2000).astype(np.float32)])


def test_order_key_orders_as_float_less():
    x = _floats(31)
    rng = np.random.default_rng(32)
    i, j = rng.integers(0, len(x), (2, 200000))
    a, b = x[i], x[j]
    ra, rb = rng.integers(0, 1 << 32, (2, len(i)), dtype=np.uint64)
    ka, kb = K.order_key(a, ra), K.order_key(b, rb)
    assert np.array_equal(ka < kb, (a < b) | ((a == b) & (ra < rb)))
    assert np.array_equal(K.order_bits(a) < K.order_bits(b), a < b)
    assert np.array_equal(K.order_bits(a) == K.order_bits(b), a == b)
    s = np.sort(x)
    assert (np.diff(K.order_bits(s).astype(np.int64)) >= 0).all()


def test_order_key_round_trips():
    x = _floats(33)
    rows = np.arange(len(x), dtype=np.uint64) * np.uint64(2654435761) % np.uint64(1 << 32)
    k = K.order_key(x, rows)
    back = K.key_t(k)
    plus = np.where(x == 0.0, np.float32(0.0), x)  # -0 decodes as +0
    assert np.array_equal(back.view(np.uint32), plus.view(np.uint32))
    assert np.array_equal(k & np.uint64(0xFFFFFFFF), rows)
    assert K.key_t(np.uint64(K.MISS_KEY)) == np.float32(BIG)
    assert K.MISS_KEY & 0xFFFFFFFF == 0xFFFFFFFF
    # every candidate the twins take (t < BIG) keys below the miss
    assert (K.order_key(x[x < BIG], rows[x < BIG]) < np.uint64(K.MISS_KEY)).all()


# ---- (c) K14: roots only where disc > 0, two parts ------------------------------

def _mxu_model(F, attr, o, d, tm):
    """K14's order: the discriminants of every (ray, feature row), a root
    only where disc > 0 (the other lanes keep no candidate), the rows cut as
    the kernel's parts cut them (tiles of 512, groups of 8, part p taking
    the groups [G p / 2, G (p + 1) / 2) of each tile), each part's first
    index among equal t, part 0 taking part 1's winner where it is closer or
    as close and earlier; then the twin's winner epilogue."""
    s_pad = attr.shape[1]
    b, disc, ta2, neg_inv_a = K.mxu_discriminants(F, s_pad, o, d, tm, T_MIN)
    cand = torch.full_like(b, BIG)
    pos = disc > 0.0
    rr, ss = pos.nonzero(as_tuple=True)
    bp, dp = b[rr, ss], disc[rr, ss]
    sq = sqrt(dp)
    root = (bp + torch.where(bp + sq < ta2[rr, 0], sq, -sq)) * neg_inv_a[rr, 0]
    cand[rr, ss] = torch.where(root > 2.0 * T_MIN, root, BIG)
    part = torch.zeros(s_pad, dtype=torch.bool)
    for base in range(0, s_pad, 512):
        m = min(512, s_pad - base)
        g = m // 8
        part[base + (g // 2) * 8:base + m] = True  # part 1
    # a part with no candidate keeps (BIG, 0), as torch.min over all-BIG
    best0, i0 = torch.min(torch.where(part, BIG, cand), dim=1)
    best1, i1 = torch.min(torch.where(part, cand, BIG), dim=1)
    take = (best1 < best0) | ((best1 == best0) & (best1 < BIG) & (i1 < i0))
    return K.mxu_winner(attr, o, d, tm, torch.where(take, best1, best0),
                        torch.where(take, i1, i0))


def _through_origin(seed, n, scale):
    """Rays whose line passes (to float32's rounding) through the origin,
    where every pad row's all-zero features sit: o = -s d."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    o = (-rng.uniform(0.5, scale, n) * d).astype(np.float32)
    return o, d, rng.random(n, dtype=np.float32)


def _nonfinite(o, d, tm, seed):
    """The same rays with NaN and +-inf written into some lanes' planes."""
    rng = np.random.default_rng(seed)
    o, d, tm = o.copy(), d.copy(), tm.copy()
    n = tm.shape[0]
    for plane in (*o, *d, tm):
        lanes = rng.choice(n, n // 64, replace=False)
        plane[lanes] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), len(lanes))
    return o, d, tm


def _mxu_cases(tables):
    bt, ft = tables["bouncing_spheres"], tables["final_scene"]
    rng = np.random.default_rng(41)
    ob = ((rng.random((3, R)) - 0.5) * 60.0 + np.array([0.0, 3.0, 0.0])[:, None]).astype(
        np.float32)
    bounce = (ob, rng.normal(size=(3, R)).astype(np.float32), rng.random(R, dtype=np.float32))
    ctr = np.array(ft.sph_tail_centroid, np.float32)
    o = (ctr + rng.normal(0, 400, (R, 3))).astype(np.float32)
    d = (ctr + rng.normal(0, 120, (R, 3)) - o).astype(np.float32)
    og = (o - ctr).T.astype(np.float32)  # the recentered origins
    tail = (og, d.T.astype(np.float32), np.zeros(R, np.float32))
    feats = {"bouncing_spheres": (bt.sph_mxu_feat, bt.sph_mxu_attr),
             "final_scene tail": (ft.sph_mxu_tail_feat, ft.sph_mxu_tail_attr)}
    return {"bouncing_spheres": (feats["bouncing_spheres"], bounce),
            "bouncing_spheres through the origin": (feats["bouncing_spheres"],
                                                    _through_origin(42, R, 30.0)),
            "bouncing_spheres NaN and inf": (feats["bouncing_spheres"], _nonfinite(*bounce, 43)),
            "final_scene tail": (feats["final_scene tail"], tail),
            "final_scene tail through the origin": (feats["final_scene tail"],
                                                    _through_origin(44, R, 300.0)),
            "final_scene tail NaN and inf": (feats["final_scene tail"], _nonfinite(*tail, 45))}


MXU_CASES = ("bouncing_spheres", "bouncing_spheres through the origin",
             "bouncing_spheres NaN and inf", "final_scene tail",
             "final_scene tail through the origin", "final_scene tail NaN and inf")


@pytest.mark.parametrize("case", MXU_CASES)
def test_mxu_roots_where_disc_positive(tables, case):
    (F, attr), rays = _mxu_cases(tables)[case]
    rays = _port(*rays)
    want = K.sphere_mxu_hit_attrs_plain(F, attr, *rays)
    got = _mxu_model(F, attr, *rays)
    _assert_same(got, want)
    hits = int((want[0] < BIG).sum())
    assert hits > 0
    if "origin" in case:
        # the pad rows' disc rounds above 0 on some of these rays
        s_pad = attr.shape[1]
        pad = (F[:s_pad] == 0).all(dim=1) & (F[s_pad:] == 0).all(dim=1)
        _, disc, _, _ = K.mxu_discriminants(F, s_pad, *rays, T_MIN)
        assert bool(pad.any()) and int((disc[:, pad] > 0.0).sum()) > 0
