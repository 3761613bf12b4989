"""The arithmetic and order of the H100 designs of K13
(``csrc/sphere_static.cu``: K2's group loop over the scene's cells
compiled in as ``__device__`` tables, two rays a thread, two parts merged
by (t, row)) and K17 (``csrc/sphere_cellbin.cu``: the twin's order lane by
lane, the table staged in shared memory, each crossed cell scanned with
K2's groups, ``csrc/sphere_group.cuh``), held on the CPU on numpy-seeded
inputs against the plain twins, bit for bit.

* (a) K13's header (``_build.static_header``) parsed back: every cell of
  bouncing_spheres, final_scene and cornell_box, in (moving, main, tail)
  order, bit for bit as the twin's tables (``_static_rows``) hold it, the
  velocity mask its moving rows' components; and the kernel's winner index
  (a tail winner's is past every main row) maps through the parsed table,
  with the kernel's operations, to the centre, radius and material the
  twin takes.
* (b) A model of K13's scan (the parsed table, the kernel's candidate
  forms, its groups, parts, warp votes and (t, row) carry with the parts'
  merge, the tail in the same carry) equals
  ``sphere_static_hit_attrs_plain`` in both forms on the three scenes and
  on a hand table with exact ties (two equal main spheres, a tail sphere
  equal to a main one, a centre coordinate of -0.0); in the direct form its
  t equals the full-table K2's twin on every lane.
* (c) A model of K17's order (tiles, the head, the union box's gate, each
  cell opened with the lane's running best, K2's groups with a group on c
  where no row of it moves, the warp as the skip unit) equals
  ``sphere_cellbin_hit_attrs_plain`` on both lattices (bouncing_spheres'
  whole-set 4x4, final_scene's 3x3x3 tail lattice), at t_min 1e-3 and 0.25,
  on rays with zero direction components, with a 64-row tile (cells across
  tiles), and on a synthetic table whose sphere A sits in the head and in
  two cells; the tests its warps make are counted; with a stale bound
  (the head's best, never lowered) it admits a superset of the twin's
  (ray, row) tests and gives the same result.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN, sqrt
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops.intersect import slab_interval
from art_tpu_torch.scene import cull

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 4096
SCENES = ("bouncing_spheres", "final_scene", "cornell_box")


@pytest.fixture(scope="module")
def tables():
    return {n: build_scene(n, 16, 16).tables for n in SCENES}


def _port(o, d, tm):
    return (tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in o),
            tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in d),
            torch.from_numpy(np.ascontiguousarray(tm)))


def _rays(seed, rows, n=R, zero_dirs=False):
    """``n`` rays from origins around the spheres' bounds, 3/4 of them
    aimed at a sphere's centre (so hits and exact ties occur), the rest in
    normal directions; with ``zero_dirs`` a quarter of them with one
    direction component exactly 0 and a few with two."""
    rng = np.random.default_rng(seed)
    c = np.asarray(rows, np.float64)[:, 0:3]
    lo, hi = c.min(axis=0) - 5.0, c.max(axis=0) + 5.0
    o = rng.uniform(lo[:, None], hi[:, None], (3, n))
    target = c[rng.integers(0, len(c), n)].T + rng.normal(scale=0.3, size=(3, n))
    d = np.where(rng.random(n) < 0.75, target - o, rng.normal(size=(3, n)))
    if zero_dirs:
        axis = rng.integers(0, 3, n)
        pick = rng.random(n) < 0.25
        d[axis[pick], np.nonzero(pick)[0]] = 0.0
        two = rng.random(n) < 0.05
        d[(axis[two] + 1) % 3, np.nonzero(two)[0]] = 0.0
    return _port(o.astype(np.float32), d.astype(np.float32), rng.random(n, dtype=np.float32))


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want):
    for a, b in zip((got[0], *got[1], got[2]), (want[0], *want[1], want[2])):
        assert torch.equal(_bits(a), _bits(b))


# ---- (a) K13's header --------------------------------------------------------

def _parse_header(text):
    """The tables and counts of a K13 header, as float32 numpy arrays."""
    def literal(s):
        s = s.strip().rstrip("f")
        return float.fromhex(s) if "0x" in s else float(s)

    out = {name: int(v) for name, v in re.findall(r"#define ART_STATIC_(\w+) (\d+)u?", text)}
    arrays = re.findall(r"__device__ const (float4|float2|float) art_static_(\w+)\[\d+\] = "
                        r"\{(.*?)\n\};", text, re.S)
    for ctype, name, body in arrays:
        width = {"float4": 4, "float2": 2, "float": 1}[ctype]
        vals = [literal(v) for v in re.findall(r"[-+0-9a-fx.p]+f", body)]
        out[name] = np.asarray(vals, np.float32).reshape(-1, width)
    return out


def _header_table(cells, tail_r, tail_mat):
    h = _parse_header(_build.static_header(cells, tail_r, tail_mat))
    n, m = h["N_ROWS"], h["N_MOVING"]
    return dict(c=h["c"][:n], k=h["k"][:n, 0], v=h["v"][:m], rm=h["rm"][:n], n_moving=m,
                vel_mask=h["VEL_MASK"])


def _u32(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("scene", SCENES)
def test_k13_header_round_trips(tables, scene):
    t = tables[scene]
    tab = _header_table(t.sph_static_cells, t.sph_tail_r, t.sph_tail_mat)
    mm, n_moving, tail = (x.numpy() if torch.is_tensor(x) else x
                          for x in K._static_rows(t, torch.device("cpu")))
    rows = np.concatenate([mm, tail])  # [c v r mat r2 K], (moving, main, tail)
    assert tab["n_moving"] == n_moving == len(t.sph_static_cells[0])
    assert len(tab["c"]) == len(rows) == sum(len(x) for x in t.sph_static_cells)
    assert (_u32(tab["c"][:, :3]) == _u32(rows[:, :3])).all()
    assert (_u32(tab["c"][:, 3]) == _u32(rows[:, 8])).all()  # r2
    assert (_u32(tab["k"][n_moving:]) == _u32(rows[n_moving:, 9])).all()  # K
    assert (_u32(tab["v"][:, :3]) == _u32(rows[:n_moving, 3:6])).all()
    assert (_u32(tab["rm"]) == _u32(rows[:, 6:8])).all()  # r, mat (the tail's on a tail row)
    moving_axes = (rows[:n_moving, 3:6] != 0.0).any(axis=0)
    assert tab["vel_mask"] == sum(1 << k for k in range(3) if moving_axes[k])


def _winner_attrs(tab, j, tm):
    """The kernel's reading of winner ``j`` (sphere_static.cu, after the
    scan): the centre at tm (the twin's where(v == 0, c0, c0 + tm v) on a
    moving row), r and material."""
    c = torch.from_numpy(tab["c"])[j]
    rm = torch.from_numpy(tab["rm"])[j]
    cen = [c[:, k] for k in range(3)]
    m = tab["n_moving"]
    if m:
        v = torch.from_numpy(tab["v"])[j.clamp(max=m - 1)]
        moving = j < m
        cen = [torch.where(moving & (v[:, k] != 0.0), c[:, k] + tm * v[:, k], c[:, k])
               for k in range(3)]
    return cen, rm[:, 0], rm[:, 1]


@pytest.mark.parametrize("scene", SCENES)
def test_k13_winner_maps_to_the_twins_attributes(tables, scene):
    t = tables[scene]
    tab = _header_table(t.sph_static_cells, t.sph_tail_r, t.sph_tail_mat)
    o, d, tm = _rays(31, tab["c"])
    mm, n_moving, tail = K._static_rows(t, torch.device("cpu"))
    t_m, cx, cy, cz, i_m = K._static_scan(mm, n_moving, o, d, tm, False)
    t_t, tx, ty, tz, i_t = K._static_scan(tail, 0, o, d, tm, False)
    better = t_t < t_m
    j = torch.where(better, i_t + mm.shape[0], i_m)  # the kernel's one carry's index
    hit = torch.minimum(t_m, t_t) < BIG
    assert int(hit.sum()) > R // 4
    (kx, ky, kz), r, mat = _winner_attrs(tab, j, tm)
    for got, want in ((kx, torch.where(better, tx, cx)), (ky, torch.where(better, ty, cy)),
                      (kz, torch.where(better, tz, cz))):
        assert torch.equal(_bits(got[hit]), _bits(want[hit]))
    r_twin = torch.where(better, torch.tensor(t.sph_tail_r, dtype=torch.float32),
                         mm[:, 6][i_m] if mm.shape[0] else r)
    m_twin = torch.where(better, torch.tensor(t.sph_tail_mat, dtype=torch.float32),
                         mm[:, 7][i_m] if mm.shape[0] else mat)
    assert torch.equal(_bits(r[hit]), _bits(r_twin[hit]))
    assert torch.equal(_bits(mat[hit]), _bits(m_twin[hit]))


# ---- (b) K13's order ---------------------------------------------------------

def _k13_candidates(tab, o, d, tm, expand):
    """(disc, t) (R, N) of the kernel's candidate forms (sphere_group.cuh
    row_disc, take_root): a moving row's centre c + tm v over the
    components of the velocity mask, c elsewhere; a static row direct on
    (c, r2) or, with ``expand``, expanded on (c, K)."""
    c = torch.from_numpy(tab["c"])
    m = tab["n_moving"]
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    tcol = tm[:, None]
    a = dx * dx + dy * dy + dz * dz
    cen = [c[None, :, k].expand(o[0].shape[0], -1) for k in range(3)]
    if m:
        v = torch.from_numpy(tab["v"])
        cen = [torch.cat([c[None, :m, k] + tcol * v[None, :, k] if tab["vel_mask"] >> k & 1
                          else cen[k][:, :m], cen[k][:, m:]], dim=1) for k in range(3)]
    ocx, ocy, ocz = ox - cen[0], oy - cen[1], oz - cen[2]
    bq = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - c[None, :, 3]
    if expand:
        k_row = torch.from_numpy(tab["k"])
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        bq_e = od - (c[None, :, 0] * dx + c[None, :, 1] * dy + c[None, :, 2] * dz)
        cc_e = (oo + k_row[None, :]) - (c[None, :, 0] * (2.0 * ox) + c[None, :, 1] * (2.0 * oy)
                                        + c[None, :, 2] * (2.0 * oz))
        bq = torch.cat([bq[:, :m], bq_e[:, m:]], dim=1)
        cc = torch.cat([cc[:, :m], cc_e[:, m:]], dim=1)
    disc = bq * bq - a * cc
    sq = sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-bq - sq) * inv_a
    t2 = (-bq + sq) * inv_a
    t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, torch.full_like(t1, BIG)))
    return disc, torch.where(disc > 0.0, t, torch.full_like(t, BIG))


def _k13_model(tab, o, d, tm, expand):
    """K13's scan as the kernel runs it (sphere_static.cu): threads of 128
    lanes a part, two rays a thread and two parts a block (one and one
    under two groups of rows); each section (moving, static) staged by
    1024-row tiles whose full groups the parts share and whose last rows the
    last part takes; a row's roots only where its warp's vote passes; each
    part's (t, row) carry in row order with a strict `<`; part 0 taking a
    later part's winner where closer, or as close and earlier; the winner's
    attributes from the table."""
    n, m = len(tab["c"]), tab["n_moving"]
    few = n < 16
    rays, split, threads = (1, 1, 128) if few else (2, 2, 128)
    disc, t = _k13_candidates(tab, o, d, tm, expand)
    lanes = o[0].shape[0]
    # warp of a lane: its block, its thread's warp within the part (the
    # parts' warps test the same rays against other groups)
    lane = torch.arange(lanes)
    warp = (lane // (threads * rays)) * (threads // 32) + (lane % threads) // 32
    n_warps = int(warp.max()) + 1
    pos = (disc > 0.0).float()
    vote = torch.zeros(n_warps, n).index_add_(0, warp, pos) > 0  # a row's vote in a warp
    t = torch.where(vote[warp], t, torch.full_like(t, BIG))
    part_rows = [[] for _ in range(split)]
    for r0, r1 in ((0, m), (m, n)):
        for base in range(r0, r1, 1024):
            rows = min(1024, r1 - base)
            groups = rows // 8
            for p in range(split):
                g0, g1 = groups * p // split, groups * (p + 1) // split
                part_rows[p] += range(base + 8 * g0, base + 8 * g1)
            part_rows[split - 1] += range(base + 8 * groups, base + rows)
    best = torch.full((lanes,), BIG)
    idx = torch.full((lanes,), -1, dtype=torch.int64)
    for p, rows in enumerate(part_rows):
        if not rows:
            continue
        rows = torch.tensor(sorted(rows))
        tp, ip = torch.min(t[:, rows], dim=1)  # the part's first closest in row order
        ip = torch.where(tp < BIG, rows[ip], -1)
        if p == 0:
            best, idx = tp, ip
        else:
            take = (tp < best) | ((tp == best) & (tp < BIG) & (ip < idx))
            best, idx = torch.where(take, tp, best), torch.where(take, ip, idx)
    hit = best < BIG
    (cx, cy, cz), r, mat = _winner_attrs(tab, idx.clamp(min=0), tm)
    inv_r = 1.0 / r
    normal = tuple(torch.where(hit, (oc + best * dc - c) * inv_r, torch.full_like(best, fill))
                   for oc, dc, c, fill in zip(o, d, (cx, cy, cz), (1.0, 0.0, 0.0)))
    return best, normal, torch.where(hit, mat.to(torch.int32), 0)


def _hand_tables():
    """A K13 scene by hand: a moving sphere, two equal main spheres A under
    materials 1 and 2, a sphere B with a -0.0 centre coordinate, and a tail
    of A (material 3) and two others; K and r2 in float32 as the builder
    rounds them."""
    f = np.float32

    def static(c, r, mat):
        c = np.asarray(c, f)
        r2 = f(r) * f(r)
        return (*map(float, c), float(f(r)), float(mat), float(r2),
                float(np.sum(c * c, dtype=f) - r2))

    A, rA = (0.5, 0.25, -0.75), 1.5
    moving = ((3.0, 0.0, 1.0, 0.0, 0.5, 0.0, 0.8, 4.0, float(f(0.8) * f(0.8))),)
    main = (static(A, rA, 1), static(A, rA, 2), static((-0.0, 2.5, 0.0), 0.7, 5))
    tail = tuple((s[0], s[1], s[2], s[5], s[6]) for s in
                 (static(A, rA, 3), static((-3.0, 0.0, 1.0), rA, 3),
                  static((0.0, -2.5, 2.0), rA, 3)))
    return SimpleNamespace(sph_static_cells=(moving, main, tail), sph_tail_r=rA,
                           sph_tail_mat=3.0)


K13_CASES = [(s, ex) for s in SCENES + ("hand",) for ex in (False, True)]


@pytest.mark.parametrize("scene, expand", K13_CASES)
def test_k13_model_equals_twin(tables, scene, expand):
    t = _hand_tables() if scene == "hand" else tables[scene]
    tab = _header_table(t.sph_static_cells, t.sph_tail_r, t.sph_tail_mat)
    o, d, tm = _rays(41, tab["c"])
    want = K.sphere_static_hit_attrs_plain(t, o, d, tm, expand=expand)
    got = _k13_model(tab, o, d, tm, expand)
    assert int((want[0] < BIG).sum()) > R // 4
    _assert_same(got, want)
    if scene == "hand":
        # exact ties: A's main copies and its tail copy give one t, and the
        # first main copy's material is the twin's
        disc, t_all = _k13_candidates(tab, o, d, tm, expand)
        m = tab["n_moving"]
        a_rows = [m, m + 1, m + 3]
        tie = (t_all[:, a_rows] == t_all[:, a_rows[:1]]).all(dim=1) & (t_all[:, m] < BIG)
        won = tie & (want[0] == t_all[:, m])
        assert int(won.sum()) > R // 20
        assert (want[2][won] == 1).all()
    elif not expand:
        full = K.sphere_hit_attrs_plain(t, o, d, tm)
        assert torch.equal(_bits(got[0]), _bits(full[0]))


# ---- (c) K17's order ---------------------------------------------------------

def _k17_model(rows, meta, o, d, tm, t_min, stage=1024, stale=False):
    """K17's scan as the kernel runs it (sphere_cellbin.cu), on CPU tensors:
    per tile of ``stage`` rows, the head rows for every lane, the union
    box's gate when the head is done, then each cell that starts in the
    tile opened with the lane's running best (with ``stale``, the head's
    best, never lowered) and scanned, across tiles if it spans them, by
    the warps with a crossing lane: full groups of eight from the range's
    start, on c + tm v where a row of the group moves and on c where none
    does, then the rows past them by their own flag; a (t, row) carry with a
    strict `<`.  Returns ((t, normal, mat), the (ray, row) pairs admitted
    per lane (R, N) bool, the tests the warps make)."""
    n_head, segs, box = meta
    lanes, n_rows = o[0].shape[0], rows.shape[0]
    moving = (rows[:, 3:6] != 0.0).any(dim=1)
    static = rows.clone()
    static[:, 3:6] = 0.0  # c, exactly: a static group's centre
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a

    def row_t(r0, r1, on_c):
        rr = rows[r0:r1]
        cen = [rr[None, :, k] if on_c else rr[None, :, k] + tm[:, None] * rr[None, :, 3 + k]
               for k in range(3)]
        ocx, ocy, ocz = ox - cen[0], oy - cen[1], oz - cen[2]
        bq = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rr[None, :, 8]
        disc = bq * bq - a * cc
        sq = sqrt(torch.clamp_min(disc, 0.0))
        t1 = (-bq - sq) * inv_a
        t2 = (-bq + sq) * inv_a
        t = torch.where(t1 > t_min, t1, torch.where(t2 > t_min, t2, torch.full_like(t1, BIG)))
        return torch.where(disc > 0.0, t, torch.full_like(t, BIG))

    def forms(lo, hi):
        """(r0, r1, on c) runs of the range's groups and single rows."""
        out, r = [], lo
        while r + 8 <= hi:
            out.append((r, r + 8, not bool(moving[r:r + 8].any())))
            r += 8
        out += [(s, s + 1, not bool(moving[s])) for s in range(r, hi)]
        return out

    warp = torch.arange(lanes) // 32
    best = torch.full((lanes,), BIG)
    idx = torch.full((lanes,), -1, dtype=torch.int64)
    admitted = torch.zeros(lanes, n_rows, dtype=torch.bool)
    made = 0

    def scan(lo, hi, on):
        nonlocal best, idx, made
        if not bool(on.any()) or hi <= lo:
            return
        warps = torch.zeros(int(warp.max()) + 1, dtype=torch.bool).index_put_(
            (warp[on],), torch.tensor(True))
        made += int(warps.sum()) * 32 * (hi - lo)
        admitted[on, lo:hi] = True
        for r0, r1, on_c in forms(lo, hi):
            tt, ii = torch.min(row_t(r0, r1, on_c), dim=1)
            better = on & (tt < best)
            best, idx = torch.where(better, tt, best), torch.where(better, ii + r0, idx)

    live = torch.ones(lanes, dtype=torch.bool)
    needy, opened, k = torch.zeros_like(live), False, 0
    bound = None
    cross = torch.zeros_like(live)
    for base in range(0, n_rows, stage):
        m = min(stage, n_rows - base)
        h1 = min(n_head, base + m)
        if base < h1:
            scan(base, h1, live)
        if not opened and n_head <= base + m:
            opened = True
            ok, t_near = slab_interval(box, o, d, t_min)
            needy = live & ok & (t_near <= best)
            bound = best.clone()
        while k < len(segs):
            r0, r1, seg_box = segs[k]
            if r0 >= base + m:
                break
            if r0 >= base:
                ok, t_near = slab_interval(seg_box, o, d, t_min)
                cross = needy & ok & (t_near <= (bound if stale else best))
            scan(max(r0, base), min(r1, base + m), cross)
            if r1 > base + m:
                break
            k += 1
    hit = best < BIG
    j = idx.clamp(min=0)
    row = rows[j]
    cen = [row[:, k] + tm * row[:, 3 + k] for k in range(3)]
    inv_r = 1.0 / row[:, 6]
    normal = tuple(torch.where(hit, (oc + best * dc - c) * inv_r, torch.full_like(best, fill))
                   for oc, dc, c, fill in zip(o, d, cen, (1.0, 0.0, 0.0)))
    return (best, normal, torch.where(hit, row[:, 7].to(torch.int32), 0)), admitted, made


def _twin_admitted(rows, meta, o, d, tm, t_min):
    """The (ray, row) pairs ``culled_plain`` (occlusion) tests per lane."""
    n_head, segs, box = meta
    t = K.sphere_hit_attrs_plain(None, o, d, tm, t_min, rows=rows[:n_head])[0]
    adm = torch.zeros(o[0].shape[0], rows.shape[0], dtype=torch.bool)
    adm[:, :n_head] = True
    ok, t_near = slab_interval(box, o, d, t_min)
    needy = ok & (t_near <= t)
    for r0, r1, seg_box in segs:
        ok, t_near = slab_interval(seg_box, o, d, t_min)
        cross = needy & ok & (t_near <= t)
        adm[cross, r0:r1] = True
        t_s = K.sphere_hit_attrs_plain(None, o, d, tm, t_min, rows=rows[r0:r1])[0]
        t = torch.where(cross & (t_s < t), t_s, t)
    return adm


def _a_table():
    """K17's table with sphere A (radius 1.5 at the origin, material 1) in
    the head and in two cells (materials 2, 3) between other spheres, one
    of them moving and one with a -0.0 centre coordinate; the cells' boxes
    as cull._layout makes them."""
    def row(c, r, mat, v=(0.0, 0.0, 0.0)):
        return [*c, *v, r, mat, r * r, 0.0]

    A = (0.0, 0.0, 0.0)
    head = [row((0.0, -100.0, 0.0), 90.0, 0), row(A, 1.5, 1)]
    cells = [[row((3.0, 0.5, 0.0), 1.0, 4, (0.0, 0.5, 0.0)), row(A, 1.5, 2),
              row((-3.0, 0.0, 1.0), 0.8, 5)] + [row((4.0 + k, 1.0, -2.0), 0.4, 7)
                                                for k in range(9)],
             [row(A, 1.5, 3), row((-0.0, 3.0, -2.0), 1.0, 6)]]
    rows = np.asarray(head + cells[0] + cells[1], np.float32)
    groups = [np.asarray(c, np.float32) for c in cells]
    table, segs = cull._layout(rows[:len(head)], groups,
                               lambda k: cull._bounds(groups[k], swept=True))
    union = cull._box(*cull._bounds(rows[len(head):], swept=True))
    return torch.from_numpy(table), (len(head), segs, union)


def _k17_case(tables, case):
    if case.startswith("A table"):
        rows, meta = _a_table()
        rng = np.random.default_rng(51)
        o = rng.uniform(-20.0, 20.0, (3, R)).astype(np.float32)
        d = (rng.uniform(-0.5, 0.5, (3, R)) - o).astype(np.float32)  # at A
        return rows, meta, _port(o, d, rng.random(R, dtype=np.float32))
    scene = case.split()[0]
    t = tables[scene]
    rows, meta = t.sph_cellbin_rows, t.sph_cellbin_meta
    return rows, meta, _rays(61, rows, zero_dirs="zero" in case)


K17_CASES = {"bouncing_spheres": {}, "final_scene": {},
             "bouncing_spheres t_min 0.25": dict(t_min=0.25),
             "final_scene t_min 0.25": dict(t_min=0.25),
             "bouncing_spheres zero directions": {}, "final_scene zero directions": {},
             "final_scene 64-row tiles": dict(stage=64),
             "bouncing_spheres 64-row tiles": dict(stage=64),
             "A table": {}, "A table 8-row tiles": dict(stage=8)}


@pytest.mark.parametrize("case", list(K17_CASES))
def test_k17_model_equals_twin(tables, case):
    rows, meta, (o, d, tm) = _k17_case(tables, case)
    kw = dict(K17_CASES[case])
    t_min = kw.pop("t_min", T_MIN)
    want = K.culled_plain(rows, meta, o, d, tm, t_min, occlusion=True)
    got, admitted, made = _k17_model(rows, meta, o, d, tm, t_min, **kw)
    _assert_same(got, want)
    assert int((want[0] < BIG).sum()) > R // 4
    twin = _twin_admitted(rows, meta, o, d, tm, t_min)
    assert torch.equal(admitted, twin)  # the twin's order, lane by lane
    assert int(twin.sum()) <= made <= R * rows.shape[0]  # the warps' tests cover the lanes'
    if case.startswith("A table"):
        # exact ties: A's copies in the head and both cells give one t, and
        # the head's copy (material 1) is the twin's
        t_all = K.sphere_row_t_p(rows, o, d, tm, t_min)
        copies = [1, 3, int(meta[1][1][0])]  # the head's, the first cell's, the second's
        tie = (t_all[:, copies] == t_all[:, copies[:1]]).all(dim=1) & (t_all[:, 1] < BIG)
        won = tie & (want[0] == t_all[:, 1])
        assert int(won.sum()) > R // 4
        assert (want[2][won] == 1).all()


@pytest.mark.parametrize("case", ["bouncing_spheres", "final_scene", "A table"])
def test_k17_stale_bound_admits_a_superset(tables, case):
    rows, meta, (o, d, tm) = _k17_case(tables, case)
    want = K.culled_plain(rows, meta, o, d, tm, T_MIN, occlusion=True)
    got, admitted, _ = _k17_model(rows, meta, o, d, tm, T_MIN, stale=True)
    twin = _twin_admitted(rows, meta, o, d, tm, T_MIN)
    assert bool((admitted | ~twin).all())  # every pair the twin tests
    assert int(admitted.sum()) > int(twin.sum())  # and more: the bound is stale
    _assert_same(got, want)
