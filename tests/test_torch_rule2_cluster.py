"""The order of the H100 designs of K15's two kernels, held on the CPU on
numpy-seeded rays against their unchanged plain twins, bit for bit.

* (a) K15's spheres run K17's kernel (``csrc/sphere_cellbin.cu``) with no
  head: the model of K17's order
  (``test_torch_rule2_static_cellbin._k17_model``: tiles, the union box's
  gate, each cell opened with the lane's running best, K2's groups, the warp
  as the skip unit) with ``n_head`` 0 equals
  ``sphere_cluster_hit_attrs_plain`` on bouncing_spheres' and final_scene's
  cluster tables, at t_min 1e-3 and 0.25 and with zero direction
  components, and ``culled_plain`` on a table of more than 64 clusters (over
  4096 spheres: past the cells whose boxes a block stages), in the kernel's
  1024-row tiles and in 100-row tiles (clusters across tiles); the (ray,
  row) pairs it admits are the twin's.
* (b) A model of K15b's order (``csrc/box_cluster.cu``: the rows staged in
  512-row tiles, each cluster opened with the lane's running best through
  the cluster test on the hoisted guarded inverses, in the folded form its
  rows by groups of eight, a group taken where a lane passes the same test
  of the group's box, K6's candidate on those inverses (in the rotated form
  the y one only), a strict ``<`` into a (t, row) carry, the warp as the
  skip unit) equals
  ``box_cluster_hit_attrs_plain`` on final_scene's box field, a 40x40 field
  (1600 boxes, 25 clusters: more rows than one tile) and 64 rotated boxes
  (``tests/test_torch_cluster.py``'s), at t_min 1e-3 and 0.25 and with zero
  direction components.
* (c) The tests each model's warps make: for K15's spheres the same as the
  earlier kernel's scan made (a warp scanning a cluster where a lane of it
  crosses, ``chip_smoke._culled_tests``), for its boxes
  ``chip_smoke._box_cluster_tests``' count (in the folded form fewer pairs
  than the twin tests: the groups' votes pass over rows); the model's
  groups in tiles of 100 and 40 rows (groups cut by a tile's end) too."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN, safe_dir
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops.intersect import _box_frame, cluster_slab
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_cluster import _rotated_boxes  # noqa: E402
from test_torch_rule2_static_cellbin import (  # noqa: E402
    _assert_same, _k17_model, _port, _rays, _twin_admitted)

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
R = 4096
K15B_TILE = 512  # rows a tile of csrc/box_cluster.cu (kTile)
K15B_GROUP = 8  # rows a group of its folded form's vote (kGroup)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(scope="module")
def tables():
    out = {n: build_scene(n, 16, 16).tables for n in ("bouncing_spheres", "final_scene")}
    out["box field"] = SMOKE._box_field(16, 16).tables
    out["rotated boxes"] = _rotated_boxes(port_builder, PO, PM).tables
    return out


# ---- (a) K15's spheres through K17's kernel ----------------------------------

def _many():
    """chip_smoke's table of more than 64 clusters (4500 spheres, 71 clusters)."""
    return SMOKE._many_clusters()


def _sphere_case(tables, case):
    if case.startswith("many"):
        rows, meta = _many()
        return rows, meta, _rays(71, rows)
    scene = case.split()[0]
    t = tables[scene]
    return t.sph_cl_rows, t.sph_cl_meta, _rays(73, t.sph_cl_rows, zero_dirs="zero" in case)


K15S_CASES = {"bouncing_spheres": {}, "final_scene": {},
              "bouncing_spheres t_min 0.25": dict(t_min=0.25),
              "final_scene t_min 0.25": dict(t_min=0.25),
              "bouncing_spheres zero directions": {}, "final_scene zero directions": {},
              "final_scene 100-row tiles": dict(stage=100),
              "many clusters": {}, "many clusters 100-row tiles": dict(stage=100)}


@pytest.mark.parametrize("case", list(K15S_CASES))
def test_k15s_runs_k17_with_no_head(tables, case):
    rows, meta, (o, d, tm) = _sphere_case(tables, case)
    kw = dict(K15S_CASES[case])
    t_min = kw.pop("t_min", T_MIN)
    assert meta[0] == 0  # no head
    if case.startswith("many"):
        assert len(meta[1]) > 64 and rows.shape[0] > 4096
        want = K.culled_plain(rows, meta, o, d, tm, t_min, occlusion=True, head=False)
    else:
        assert rows is tables[case.split()[0]].sph_cl_rows
        want = K.sphere_cluster_hit_attrs_plain(tables[case.split()[0]], o, d, tm, t_min)
    got, admitted, made = _k17_model(rows, meta, o, d, tm, t_min, **kw)
    _assert_same(got, want)
    assert int((want[0] < BIG).sum()) > R // 4
    twin = _twin_admitted(rows, meta, o, d, tm, t_min)
    assert torch.equal(admitted, twin)  # the twin's order, lane by lane
    assert int(twin.sum()) <= made


@pytest.mark.parametrize("case", ["bouncing_spheres", "final_scene", "many clusters"])
def test_k15s_warps_make_the_earlier_scans_tests(tables, case):
    rows, meta, (o, d, tm) = _sphere_case(tables, case)
    _, admitted, made = _k17_model(rows, meta, o, d, tm, T_MIN)
    need, earlier = SMOKE._culled_tests(rows, meta, o, d, tm, True, head=False)
    assert made == earlier  # the same warps scan the same clusters
    assert need == int(admitted.sum()) <= made


# ---- (b) K15's boxes -----------------------------------------------------------

def _candidates(rows, rotated, o, d, inv, t_min):
    """(R, n) K6's candidate t of ``rows`` as csrc/box_cluster.cu forms it:
    the folded form on the ray's hoisted inverses ``inv``; the rotated one
    in each box's frame, x and z divided a pair, y on the hoisted
    inverse (the frame keeps dy)."""
    lo, ld = _box_frame(rows, o, d, rotated)
    if rotated:
        iv = (1.0 / safe_dir(ld[0]), inv[1][:, None], 1.0 / safe_dir(ld[2]))
    else:
        iv = tuple(c[:, None] for c in inv)
    t0s, t1s = [], []
    for k in range(3):
        ta = (rows[None, :, k] - lo[k]) * iv[k]
        tb = (rows[None, :, 3 + k] - lo[k]) * iv[k]
        t0s.append(torch.minimum(ta, tb))
        t1s.append(torch.maximum(ta, tb))
    t0 = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t1 = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    through = t0 < t1
    return torch.where(through & (t0 > t_min), t0,
                       torch.where(through & (t1 > t_min), t1, torch.full_like(t0, BIG)))


def _warps(lanes: int) -> torch.Tensor:
    """The warp of each lane: 32 consecutive lanes (one ray a thread)."""
    return torch.arange(lanes) // 32


def _group_box(rows):
    """A group's box: the min and max of its rows' bounds (float32, as the
    kernel's fminf / fmaxf)."""
    return tuple(rows[:, k].min() for k in range(3)) + tuple(rows[:, k].max()
                                                            for k in range(3, 6))


def _k15b_model(tables, o, d, t_min, tile=K15B_TILE, group=K15B_GROUP):
    """K15b's scan as the kernel runs it (module note), on CPU tensors:
    the guarded inverses once a ray; the union box's test with t = BIG;
    per tile of ``tile`` rows, each cluster that starts in it opened with
    the cluster test against the lane's running best and scanned (across
    tiles if it spans them) by the warps with a crossing lane: the rotated
    form row by row, the folded one by the aligned groups of ``group`` rows
    that overlap its range, a group's rows only in the warps where a
    crossing lane passes the cluster test of the group's box (its rows in
    the tile) against its running best; a crossing lane of a scanning warp
    takes a row's t where strictly below its carry; the winner's attributes
    from its row.  Returns ((t, normal, u, v, mat), the (ray, row) pairs
    taken (R, N) bool, the tests the warps make)."""
    rows, (_, segs, union) = tables.box_cl_rows, tables.box_cl_meta
    rotated = tables.has_rotated_boxes
    lanes, n_rows = o[0].shape[0], rows.shape[0]
    inv = tuple(1.0 / safe_dir(c) for c in d)
    warp = _warps(lanes)
    best = torch.full((lanes,), BIG)
    idx = torch.full((lanes,), -1, dtype=torch.int64)
    admitted = torch.zeros(lanes, n_rows, dtype=torch.bool)
    made = 0

    def scan(lo, hi, on):
        """rows [lo, hi) for the lanes ``on`` of the warps with one."""
        nonlocal best, idx, made
        warps = torch.zeros(int(warp.max()) + 1, dtype=torch.bool)
        warps[warp[on]] = True
        takes = on & warps[warp]
        if not bool(takes.any()):
            return
        made += int(warps.sum()) * 32 * (hi - lo)
        admitted[takes, lo:hi] = True
        tt, ii = torch.min(_candidates(rows[lo:hi], rotated, o, d, inv, t_min), dim=1)
        better = takes & (tt < best)
        best, idx = torch.where(better, tt, best), torch.where(better, ii + lo, idx)

    needy = cluster_slab(union, o, inv, t_min, best)
    cross = torch.zeros_like(needy)
    k = 0
    for base in range(0, n_rows, tile):
        m = min(tile, n_rows - base)
        while k < len(segs):
            r0, r1, box = segs[k]
            if r0 >= base + m:
                break
            if r0 >= base:
                cross = needy & cluster_slab(box, o, inv, t_min, best)
            lo, hi = max(r0, base), min(r1, base + m)
            if bool(cross.any()) and rotated:
                scan(lo, hi, cross)
            elif bool(cross.any()):
                for g in range(lo - (lo - base) % group, hi, group):  # from the tile's start
                    gbox = _group_box(rows[g:min(g + group, base + m)])
                    passed = cross & cluster_slab(gbox, o, inv, t_min, best)
                    warps = torch.zeros(int(warp.max()) + 1, dtype=torch.bool)
                    warps[warp[passed]] = True
                    scan(max(g, lo), min(g + group, hi), cross & warps[warp])
            if r1 > base + m:
                break
            k += 1
    hit = best < BIG
    normal, u, v, mat = K.box_attributes_rows(K.take_rows(rows, idx.clamp_min(0)), o, d, best)
    normal, (u, v, mat) = K.miss_defaults(hit, normal, (u, v, mat))
    return (best, normal, u, v, mat), admitted, made


def _box_rays(seed, tables, n=R, zero_dirs=False):
    """``n`` rays from origins around the clusters' union box, 3/4 of them
    aimed at a uniform point of a random cluster's box (so hits and
    shared faces occur), the rest in normal directions; with ``zero_dirs``
    a quarter of them with one direction component exactly 0 and a few
    with two."""
    rng = np.random.default_rng(seed)
    _, segs, union = tables.box_cl_meta
    lo, hi = np.asarray(union[:3]), np.asarray(union[3:])
    pad = 0.25 * (hi - lo) + 2.0
    o = rng.uniform((lo - pad)[:, None], (hi + pad)[:, None], (3, n))
    boxes = np.asarray([b for _, _, b in segs])[rng.integers(0, len(segs), n)]
    target = (boxes[:, :3] + rng.random((n, 3)) * (boxes[:, 3:] - boxes[:, :3])).T
    d = np.where(rng.random(n) < 0.75, target - o, rng.normal(size=(3, n)))
    if zero_dirs:
        axis = rng.integers(0, 3, n)
        pick = rng.random(n) < 0.25
        d[axis[pick], np.nonzero(pick)[0]] = 0.0
        two = rng.random(n) < 0.05
        d[(axis[two] + 1) % 3, np.nonzero(two)[0]] = 0.0
    o, d = _port(o.astype(np.float32), d.astype(np.float32), np.zeros(n, np.float32))[:2]
    return o, d


def _assert_box_same(got, want):
    for a, b in zip((got[0], *got[1], *got[2:]), (want[0], *want[1], *want[2:])):
        a = a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
        b = b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b
        assert torch.equal(a, b)


K15B_CASES = {"final_scene": {}, "box field": {}, "rotated boxes": {},
              "final_scene t_min 0.25": dict(t_min=0.25),
              "box field t_min 0.25": dict(t_min=0.25),
              "rotated boxes t_min 0.25": dict(t_min=0.25),
              "final_scene zero directions": {}, "box field zero directions": {},
              "rotated boxes zero directions": {},
              "final_scene 100-row tiles": dict(tile=100),
              "rotated boxes 40-row tiles": dict(tile=40)}


def _scene_of(case):
    return next(n for n in ("final_scene", "box field", "rotated boxes") if case.startswith(n))


@pytest.mark.parametrize("case", list(K15B_CASES))
def test_k15b_model_equals_twin(tables, case):
    t = tables[_scene_of(case)]
    kw = dict(K15B_CASES[case])
    t_min = kw.pop("t_min", T_MIN)
    o, d = _box_rays(81, t, zero_dirs="zero" in case)
    want = K.box_cluster_hit_attrs_plain(t, o, d, t_min)
    got, admitted, made = _k15b_model(t, o, d, t_min, **kw)
    _assert_box_same(got, want)
    assert int((want[0] < BIG).sum()) > R // 8
    assert int(admitted.sum()) <= made <= R * t.box_cl_rows.shape[0]
    if t_min == T_MIN:
        need = SMOKE._box_cluster_tests(t, o, d)[0]  # the twin's: whole clusters
        assert int(admitted.sum()) <= need


def test_k15b_tables_span_tiles(tables):
    """The box field's 1600 rows take four tiles; the rotated form is
    exercised (64 rotated boxes, one cluster)."""
    field, rot = tables["box field"], tables["rotated boxes"]
    assert field.box_cl_rows.shape[0] == 1600 and len(field.box_cl_meta[1]) == 25
    assert field.box_cl_rows.shape[0] > K15B_TILE and not field.has_rotated_boxes
    assert rot.has_rotated_boxes and rot.box_cl_rows.shape[0] == 64


# ---- (c) the tests the warps make ----------------------------------------------

@pytest.mark.parametrize("scene", ["final_scene", "box field", "rotated boxes"])
def test_k15b_warps_tests(tables, scene):
    t = tables[scene]
    o, d = _box_rays(83, t)
    _, admitted, made = _k15b_model(t, o, d, T_MIN)
    need, warp_tests = SMOKE._box_cluster_tests(t, o, d)
    assert made == warp_tests  # chip_smoke's count is the kernel's
    assert int(admitted.sum()) <= made
    if t.has_rotated_boxes:  # whole clusters: the lanes take what the twin tests
        assert need == int(admitted.sum()) <= made
    else:  # the groups' votes pass over rows the twin tests
        assert int(admitted.sum()) < need
