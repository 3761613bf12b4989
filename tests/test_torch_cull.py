"""The culling sphere kernels K16 (skip bins) and K17 (cell bins), their
tables, the split pass's opt-in variants and the sphere routes, against
art_tpu on the CPU.

* Tables (``scene/cull.py``): the skip bins and the tail lattice of
  final_scene and original_scene and the whole-set lattice of
  bouncing_spheres hold art_tpu's rows (``pack_skip_spheres``,
  ``pack_tail2d_spheres``, ``pack_cellbin_spheres``) segment for segment,
  once art_tpu's inert padding rows are dropped and each segment's moving
  rows are put first (art_tpu's order; the port keeps scene order in the
  head and the cells), with art_tpu's boxes exactly; ``tables_from_numpy``
  builds the same tables; three_spheres (3 < ``CELLBIN_MIN``) gets none.
* The twins, on R = 8192 rays from a numpy seed aimed at the cluster (the
  tail box or the lattice's union box) in shares of 0, 1/2 and 1, as
  art_tpu's ``test_sphere_skip.py`` and ``test_sphere_cellbin.py`` aim
  theirs: against art_tpu's Pallas K16 and K17 in interpret mode (each
  compiled once under ``jax.jit``; ``expand=False``, ``pos_r`` as the
  tables say) at K2's tolerances (``test_torch_intersect.py``: the same hit
  and material, t to rtol 1e-5 and atol 5e-5, normals to 1e-4) wherever
  art_tpu's own Pallas and jnp K2 meet them, the twin bit-equal to the jnp
  K2 and the Pallas K16 and K17 bit-equal to the Pallas K2 everywhere
  (``test_twins_match_pallas_interpret``); against the port's full-table K2
  twin: t bit-equal on every lane, and a winner may differ only on an exact
  tie between segments (counted: none occurs).
* The split pass's variants at a pool above ``SPH_K``: the occlusion gate,
  K16's tail-only call and the forced dense branch with each fallback, as
  records of ``closest_surface_p`` equal to the default route's.
* Routes: one case per switch of ``ops/routes.py``, the kernels each
  calls, and the repaired pool bound (an 8192-slot final_scene pool takes
  the full-table K2 under ``ART_TPU_COMPACT_SPH``).
* A lock-step final_scene render (16x16 @ 2) under ``ART_TPU_SPH_CELLBIN``
  and under ``ART_TPU_SPH_SKIP``: every pool plane equal to the default
  route's after every iteration, on art_tpu's injected uniforms."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.ops.intersect import sphere_attributes_p as jax_attrs
from art_tpu.ops.intersect import sphere_candidates_p as jax_candidates
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import compact_sphere as cs
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops import routes
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.render.integrator import n_uniform_cols, staged_step
from art_tpu_torch.render.renderer import RenderConfig, plan_batches
from art_tpu_torch.scene import cull
from art_tpu_torch.scene.builder import tables_from_numpy
from test_torch_big_scenes import _carried
from test_torch_render import _threefry
from test_torch_scene import _jax_arrays

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
R = 8192
SHARES = (0.0, 0.5, 1.0)
CULL_FIELDS = ("sph_skip_rows", "sph_skip_bins", "sph_skip_seg", "sph_cellbin_rows",
               "sph_cellbin_meta", "sph_cellbin_seg")


@pytest.fixture(scope="module")
def scenes():
    """(art_tpu tables, port tables) by name, built once."""
    return {n: (jax_build_scene(n, 16, 16).tables, build_scene(n, 16, 16).tables)
            for n in ("final_scene", "original_scene", "bouncing_spheres")}


def _moving_first(rows):
    moving = (rows[:, 3:6] != 0).any(axis=1)
    return np.concatenate([rows[moving], rows[~moving]])


def _live(rows):
    """art_tpu's rows without its inert padding (r2 = -1)."""
    return rows[rows[:, 8] > 0.0]


def _assert_segments(port_rows, port_meta, j_head, j_segs, j_box):
    """port (rows, (n_head, segs, box)) against art_tpu's head rows, [(rows,
    box)] segments and box: cols 0..8 (art_tpu's col 9 is its expanded
    quadratic's constant) and boxes exactly."""
    n_head, segs, box = port_meta
    rows = port_rows.numpy()
    np.testing.assert_array_equal(_moving_first(rows[:n_head])[:, :9], j_head[:, :9])
    assert len(segs) == len(j_segs) and box == tuple(j_box)
    assert segs[0][0] == n_head and segs[-1][1] == rows.shape[0]
    for (r0, r1, b), (j_rows, j_b) in zip(segs, j_segs):
        np.testing.assert_array_equal(_moving_first(rows[r0:r1])[:, :9], j_rows[:, :9])
        assert b == tuple(j_b)


@pytest.mark.parametrize("name", ["final_scene", "original_scene"])
def test_tail_tables_match_art_tpu(scenes, name):
    jt, t = scenes[name]
    tab = np.asarray(jt.sph_skip_packed)
    n_mov, n_main, bins = jt.sph_skip_bins
    assert len(bins) == 16
    _assert_segments(t.sph_skip_rows, t.sph_skip_bins, _live(tab[:n_mov + n_main]),
                     [(_live(tab[a:b]), box) for a, b, box in bins], jt.sph_tail_box)
    tab = np.asarray(jt.sph_cellbin_packed)
    head_m, head_s, cells, union = jt.sph_cellbin_meta
    assert all(m0 == m1 for m0, m1, *_ in cells)  # the tail is static
    _assert_segments(t.sph_cellbin_rows, t.sph_cellbin_meta, _live(tab[:head_m + head_s]),
                     [(_live(tab[s0:s1]), box) for _, _, s0, s1, box in cells], union)
    np.testing.assert_array_equal(t.sph_skip_seg.numpy(), cull.seg_table(t.sph_skip_bins))


def test_whole_set_lattice_matches_art_tpu(scenes):
    jt, t = scenes["bouncing_spheres"]
    assert jt.sph_skip_bins is None and t.sph_skip_bins is None
    tab = np.asarray(jt.sph_cellbin_packed)
    head_m, head_s, cells, union = jt.sph_cellbin_meta
    segs = [(_live(np.concatenate([tab[m0:m1], tab[s0:s1]])), box)
            for m0, m1, s0, s1, box in cells]
    _assert_segments(t.sph_cellbin_rows, t.sph_cellbin_meta, _live(tab[:head_m + head_s]),
                     segs, union)
    assert len(cells) == 16 and t.sph_cellbin_meta[0] >= 1  # the ground sphere
    assert t.sph_cellbin_rows.shape[0] == t.n_spheres
    np.testing.assert_array_equal(t.sph_cellbin_seg.numpy(),
                                  cull.seg_table(t.sph_cellbin_meta))


def test_no_cull_tables_below_the_gates():
    jt = jax_build_scene("three_spheres", 16, 16).tables
    t = build_scene("three_spheres", 16, 16).tables
    assert jt.sph_cellbin_meta is None and jt.sph_skip_bins is None
    assert all(getattr(t, k) is None for k in CULL_FIELDS)


@pytest.mark.parametrize("name", ["final_scene", "bouncing_spheres"])
def test_tables_from_numpy_builds_the_cull_tables(name):
    carried = tables_from_numpy(*_jax_arrays(jax_build_scene(name, 16, 16)))[0]
    built = build_scene(name, 16, 16).tables
    for k in CULL_FIELDS:
        a, b = getattr(carried, k), getattr(built, k)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        else:
            assert a == b, k


def test_bin_count_switch(scenes):
    """``ART_TPU_SPH_BINS`` sets K16's bin count where ``scene/cull.py`` is
    imported; ``cull_tables`` takes the count as its argument."""
    _, t = scenes["final_scene"]
    c = cull.cull_tables(t.sph_head_rows, t.sph_tail_rows, t.sph_rows, t.sph_tail_box, 4)
    assert len(c["sph_skip_bins"][1]) == 4 and c["sph_skip_seg"].shape == (5, 8)
    assert cull.SPH_BINS == 16 and len(t.sph_skip_bins[1]) == 16
    code = ("from art_tpu_torch.models import build_scene; "
            "print(len(build_scene('final_scene', 16, 16).tables.sph_skip_bins[1]))")
    env = dict(os.environ, ART_TPU_SPH_BINS="4")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.split() == ["4"]


def _rays(seed, box, share, span):
    """R rays from origins uniform in ``span``: a ``share`` of them aimed at
    a point within 0.4 of ``box``'s extent of its centre, the rest in normal
    directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(*span, (3, R)).astype(np.float32)
    d = rng.normal(size=(3, R)).astype(np.float32)
    lo, hi = np.asarray(box[:3])[:, None], np.asarray(box[3:])[:, None]
    target = (lo + hi) / 2 + rng.uniform(-0.4, 0.4, (3, R)) * (hi - lo)
    aim = rng.random(R) < share
    d = np.where(aim, target - o, d).astype(np.float32)
    tm = rng.random(R, dtype=np.float32)
    return o, d, tm


_SPAN = {"final_scene": (-500.0, 900.0), "bouncing_spheres": (-30.0, 30.0)}


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


_PALLAS: dict = {}


def _pallas(kind, name, jt):
    """art_tpu's Pallas K16, K17 or K2 (``planar``, the full table) in
    interpret mode, compiled once under jit."""
    if (kind, name) not in _PALLAS:
        if kind == "skip":
            def fn(o, d, tm):
                return pk.sphere_skip_hit_attrs(
                    jt.sph_skip_packed, o, d, tm, meta=jt.sph_skip_bins,
                    tail_box=jt.sph_tail_box, tail_r=jt.sph_tail_r, tail_mat=jt.sph_tail_mat,
                    pos_r=jt.sph_pos_r, expand=False, needs_uv=False, interpret=True)
        elif kind == "planar":
            def fn(o, d, tm):
                return pk.sphere_hit_attrs_planar(
                    jt.sph_packed, o, d, tm, n_moving=jt.sph_n_moving_pad,
                    n_static=jt.sph_n_static, needs_uv=False, n_tail=jt.sph_n_tail,
                    tail_r=jt.sph_tail_r, tail_mat=jt.sph_tail_mat, pos_r=jt.sph_pos_r,
                    expand=False, interpret=True)
        else:
            def fn(o, d, tm):
                return pk.sphere_cellbin_hit_attrs(
                    jt.sph_cellbin_packed, o, d, tm, meta=jt.sph_cellbin_meta,
                    pos_r=jt.sph_pos_r, expand=False, needs_uv=False, interpret=True)
        _PALLAS[kind, name] = jax.jit(fn)
    return _PALLAS[kind, name]


CASES = [("skip", "final_scene"), ("cellbin tail", "final_scene"),
         ("cellbin", "bouncing_spheres")]


def _twin(kind, t, *rays):
    fn = K.sphere_skip_hit_attrs_plain if kind == "skip" else K.sphere_cellbin_hit_attrs_plain
    return fn(t, *rays)


def _box(kind, t):
    return t.sph_tail_box if kind == "skip" else t.sph_cellbin_meta[2]


def _np(t, n, m):
    return np.asarray(t), tuple(np.asarray(c) for c in n), np.asarray(m)


def _within(got, want):
    """(R,) bool: K2's tolerances (``test_torch_intersect.py``) per lane:
    the same hit and material, t to rtol 1e-5 and atol 5e-5, normals to
    1e-4."""
    t, n, m = got
    wt, wn, wm = want
    hit = t < BIG
    ok = (hit == (wt < BIG)) & (~hit | (m == wm))
    ok &= ~hit | np.isclose(t, wt, rtol=1e-5, atol=5e-5)
    for c in range(3):
        ok &= ~hit | (np.abs(n[c] - wn[c]) <= 1e-4)
    return ok


def _assert_equal(got, want):
    """t equal bit for bit; normal and material too where t is a hit (a
    miss's attributes are defaults in the port and the kernels, but the
    winner row's in art_tpu's jnp pass)."""
    np.testing.assert_array_equal(got[0], want[0])
    hit = got[0] < BIG
    for a, b in zip((*got[1], got[2]), (*want[1], want[2])):
        np.testing.assert_array_equal(a[hit], b[hit])


@pytest.mark.parametrize("kind,name", CASES)
def test_twins_match_pallas_interpret(scenes, kind, name):
    """The twin against art_tpu's interpret-mode kernel, through art_tpu's
    two forms of K2: the twin equals art_tpu's jnp K2 (``sphere_candidates_p``
    + ``sphere_attributes_p``) bit for bit, the Pallas K16 or K17 equals the
    Pallas K2 bit for bit, and the twin meets K2's tolerances against the
    Pallas kernel on every lane where art_tpu's two K2 forms meet them.
    At these scenes' scale they do not everywhere: with coordinates of
    ~1000 and radii of 10 the discriminant b*b - a*c cancels, and the
    Pallas kernel's fused float program (and its rsqrt normal under
    ``pos_r``) rounds it otherwise than the jnp form, which moves t beyond
    rtol 1e-5 on grazing lanes and normals beyond 1e-4 on long (unnormalized,
    cluster-aimed) directions; those lanes are counted."""
    jt, t = scenes[name]
    culled, planar = _pallas(kind, name, jt), _pallas("planar", name, jt)
    apart = []
    for n, share in enumerate(SHARES):
        o, d, tm = _rays(10 + n, _box(kind, t), share, _SPAN[name])
        J = tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)
        k_t, k_n, _, _, k_m = culled(*J)
        p_t, p_n, _, _, p_m = planar(*J)
        j_t, j_i = jax_candidates(jt, *J, T_MIN)
        j_n, _, _, j_m = jax_attrs(jt, *J, j_t, j_i, False)
        kern, k2, ref = _np(k_t, k_n, k_m), _np(p_t, p_n, p_m), _np(j_t, j_n, j_m)
        twin = tuple(x.numpy() if isinstance(x, torch.Tensor) else tuple(c.numpy() for c in x)
                     for x in _twin(kind, t, *_port(o, d, tm)))
        _assert_equal(twin, ref)
        _assert_equal(kern, k2)
        agree = _within(k2, ref)  # art_tpu's two K2 forms within K2's tolerances
        assert not (agree & ~_within(twin, kern)).any(), share
        assert int((twin[0] < BIG).sum()) > (R // 20 if share else 0), share
        apart.append(int((~agree).sum()))
    # measured: at most 24 lanes apart in t (1 at share 0); with normals up
    # to 4627 of 8192 on cluster-aimed rays (|d| ~ 1000)
    assert apart[0] <= R // 100, apart


def _segment_ties(rows, meta, rays, t_min=T_MIN):
    """(R,) bool: lanes whose closest t is reached exactly in two segments
    (the head counting as one)."""
    n_head, segs, _ = meta
    ts = [K.sphere_hit_attrs_plain(None, *rays, t_min, rows=rows[a:b])[0]
          for a, b in [(0, n_head)] + [(a, b) for a, b, _ in segs]]
    ts = torch.stack(ts)
    best = ts.min(dim=0).values
    return ((ts == best) & (best < BIG)).sum(dim=0) >= 2


@pytest.mark.parametrize("kind,name", CASES)
def test_twins_equal_the_full_table_k2(scenes, kind, name):
    _, t = scenes[name]
    rows, meta = ((t.sph_skip_rows, t.sph_skip_bins) if kind == "skip"
                  else (t.sph_cellbin_rows, t.sph_cellbin_meta))
    for n, share in enumerate(SHARES):
        rays = _port(*_rays(20 + n, _box(kind, t), share, _SPAN[name]))
        got = _twin(kind, t, *rays)
        full = K.sphere_hit_attrs_plain(t, *rays)
        assert torch.equal(got[0], full[0]), share
        differ = got[2] != full[2]
        for c in range(3):
            differ |= got[1][c] != full[1][c]
        ties = _segment_ties(rows, meta, rays)
        assert not bool((differ & ~ties).any()), share
        assert int(ties.sum()) == 0  # counted: none on these rays
        if share:
            hits_cluster = int((full[0] < BIG).sum())
            assert hits_cluster > R // 20


def test_tail_only_skip_equals_the_tail_k2(scenes):
    """K16 with tail_only and n_live against K2 over the tail rows."""
    _, t = scenes["final_scene"]
    rays = _port(*_rays(30, t.sph_tail_box, 0.5, _SPAN["final_scene"]))
    n_live = torch.tensor([5000], dtype=torch.int32)
    got = K.sphere_skip_hit_attrs(t, *rays, tail_only=True, n_live=n_live)
    want = K.sphere_hit_attrs_plain(t, *rays, rows=t.sph_tail_rows, n_live=n_live)
    for a, b in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert torch.equal(a, b)
    assert bool((got[0][5000:] == BIG).all()) and int((got[0][:5000] < BIG).sum()) > 500


RS = 8320  # a pool above SPH_K (8192), so the split's gate holds


def _pool_rays(t, seed=40):
    o, d, tm = _rays(seed, t.sph_tail_box, 0.5, _SPAN["final_scene"])
    rng = np.random.default_rng(seed)
    extra = tuple(rng.uniform(-500, 900, (3, RS - R)).astype(np.float32))
    o = np.concatenate([o, np.stack(extra)], axis=1)
    d = np.concatenate([d, rng.normal(size=(3, RS - R)).astype(np.float32)], axis=1)
    tm = np.concatenate([tm, rng.random(RS - R, dtype=np.float32)])
    return _port(o, d, tm)


@pytest.fixture(scope="module")
def final_default(scenes):
    _, t = scenes["final_scene"]
    rays = _pool_rays(t)
    return t, rays, closest_surface_p(t, *rays, T_MIN)


SPLIT_VARIANTS = {
    "occlusion gate": dict(compact_sph=True, occ_gate=True),
    "tail-only skip": dict(compact_sph=True, sph_skip=True, compact_skip=True),
    "gate and tail-only skip": dict(compact_sph=True, occ_gate=True, sph_skip=True,
                                    compact_skip=True),
    "dense, K17": dict(compact_sph=True, force_branch="dense", compact_cellbin=True),
    "dense, K16": dict(compact_sph=True, force_branch="dense", sph_skip=True),
    "dense, K2": dict(compact_sph=True, force_branch="dense"),
    "split": dict(compact_sph=True),
    "K16": dict(sph_skip=True),
    "K17": dict(sph_cellbin=True),
}


@pytest.mark.parametrize("variant", list(SPLIT_VARIANTS))
def test_routes_equal_the_default_route(final_default, variant):
    t, rays, want = final_default
    with routes.using(**SPLIT_VARIANTS[variant]):
        got = closest_surface_p(t, *rays, T_MIN)
    for k in ("t", "u", "v", "mat"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for c in range(3):
        assert torch.equal(got.normal[c], want.normal[c])
    assert int(want.hit.sum()) > RS // 4


@pytest.fixture
def calls(monkeypatch):
    """The sphere functions that closest_surface_p reaches, recorded by name
    with their keyword arguments: the split and, below it, the kernels it
    calls (not the K2 twin calls inside the K16 and K17 twins)."""
    seen, depth = [], [0]

    def recorder(name, fn, nests):
        def spy(*a, **kw):
            if depth[0] == 0 or (depth[0] == 1 and seen and seen[0][0] == "split"):
                seen.append((name, kw))
            depth[0] += nests
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= nests
        return spy

    for name in ("sphere_hit_attrs_plain", "sphere_skip_hit_attrs_plain",
                 "sphere_cellbin_hit_attrs_plain"):
        monkeypatch.setattr(K, name, recorder(name, getattr(K, name), 2))
    monkeypatch.setattr(cs, "sphere_hit_attrs_split",
                        recorder("split", cs.sphere_hit_attrs_split, 1))
    return seen


def _route(t, rays, **switches):
    with routes.using(**switches):
        closest_surface_p(t, *rays, T_MIN, plain=True)


def _names(seen):
    return [n for n, _ in seen]


# (switches, the sphere calls closest_surface_p makes, in order)
ROUTE_CASES = {
    "default: the full-table K2": ({}, ["sphere_hit_attrs_plain"]),
    "COMPACT_SPH: the split": (dict(compact_sph=True),
                               ["split", "sphere_hit_attrs_plain", "sphere_hit_attrs_plain"]),
    "SPH_SKIP: K16": (dict(sph_skip=True), ["sphere_skip_hit_attrs_plain"]),
    "SPH_CELLBIN: K17, before the split": (dict(sph_cellbin=True, compact_sph=True),
                                           ["sphere_cellbin_hit_attrs_plain"]),
    "COMPACT_SPH before SPH_SKIP": (dict(compact_sph=True, sph_skip=True),
                                    ["split", "sphere_hit_attrs_plain",
                                     "sphere_hit_attrs_plain"]),
    "COMPACT_SKIP: K16's tail-only call": (
        dict(compact_sph=True, sph_skip=True, compact_skip=True),
        ["split", "sphere_hit_attrs_plain", "sphere_skip_hit_attrs_plain"]),
    "COMPACT_SKIP needs SPH_SKIP": (dict(compact_sph=True, compact_skip=True),
                                    ["split", "sphere_hit_attrs_plain",
                                     "sphere_hit_attrs_plain"]),
    "FORCE_BRANCH dense: the full-table K2": (dict(compact_sph=True, force_branch="dense"),
                                              ["sphere_hit_attrs_plain"]),
    "FORCE_BRANCH dense with SPH_SKIP: K16": (
        dict(compact_sph=True, force_branch="dense", sph_skip=True),
        ["sphere_skip_hit_attrs_plain"]),
    "COMPACT_CELLBIN: K17 as the dense fallback": (
        dict(compact_sph=True, force_branch="dense", compact_cellbin=True, sph_skip=True),
        ["sphere_cellbin_hit_attrs_plain"]),
    "COMPACT_CELLBIN only in the dense branch": (
        dict(compact_sph=True, compact_cellbin=True),
        ["split", "sphere_hit_attrs_plain", "sphere_hit_attrs_plain"]),
    "FORCE_BRANCH compact: the port's branch": (
        dict(compact_sph=True, force_branch="compact"),
        ["split", "sphere_hit_attrs_plain", "sphere_hit_attrs_plain"]),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_selection(final_default, calls, case):
    t, rays, _ = final_default
    switches, want = ROUTE_CASES[case]
    _route(t, rays, **switches)
    assert _names(calls) == want
    if want[0] == "split":
        kw = calls[0][1]
        assert kw["occ_t"] is None
        assert kw["skip_tail"] == (switches.get("sph_skip", False)
                                   and switches.get("compact_skip", False))
    if case.startswith("COMPACT_SKIP: "):
        assert calls[-1][1] == dict(tail_only=True, n_live=calls[-1][1]["n_live"])


def test_occlusion_gate_passes_the_closest_quad_or_box(final_default, calls):
    t, rays, _ = final_default
    _route(t, rays, compact_sph=True, occ_gate=True)
    occ = calls[0][1]["occ_t"]
    assert occ is not None and occ.shape == (RS,) and bool((occ < BIG).any())


def test_cellbin_route_needs_its_table(calls):
    """SPH_CELLBIN on a scene without cell bins takes the full-table K2."""
    t = build_scene("three_spheres", 16, 16).tables
    _route(t, _port(*_rays(3, (-1, -1, -2, 1, 1, 0), 0.5, (-3.0, 3.0))), sph_cellbin=True,
           sph_skip=True)
    assert _names(calls) == ["sphere_hit_attrs_plain"]


def test_split_pool_bounds(scenes, calls):
    """art_tpu's bounds SPH_K < R < 2^24: plan_batches' 8192-slot pool of a
    final_scene 32x32 @ 8 render on the card takes the full-table K2."""
    _, t = scenes["final_scene"]
    R_ = plan_batches(32 * 32, 8, t.n_spheres, RenderConfig(), "cuda")[2]
    assert R_ == cs.SPH_K == 8192
    assert not cs.use_split(t, R_) and cs.use_split(t, R_ + 128) and cs.use_split(t)
    assert not cs.use_split(t, 1 << 24)
    _route(t, _port(*_rays(4, t.sph_tail_box, 0.5, _SPAN["final_scene"])), compact_sph=True)
    assert _names(calls) == ["sphere_hit_attrs_plain"]


def test_routes_from_the_environment():
    names = {"ART_TPU_COMPACT_SPH": "compact_sph", "ART_TPU_OCC_GATE": "occ_gate",
             "ART_TPU_SPH_SKIP": "sph_skip", "ART_TPU_COMPACT_SKIP": "compact_skip",
             "ART_TPU_SPH_CELLBIN": "sph_cellbin", "ART_TPU_COMPACT_CELLBIN": "compact_cellbin"}
    assert routes.from_environ({}) == routes.Routes()
    assert not routes.Routes().compact_sph  # the split is opt-in
    for env, field in names.items():
        r = routes.from_environ({env: "1"})
        assert getattr(r, field) and r == routes.Routes(**{field: True})
    r = routes.from_environ({"ART_TPU_SPH_FORCE_BRANCH": "dense"})
    assert r == routes.Routes(force_branch="dense")
    with routes.using(sph_skip=True) as r:
        assert routes.ROUTES is r and r.sph_skip
    assert routes.ROUTES == routes.from_environ()


@pytest.mark.parametrize("switch", ["sph_cellbin", "sph_skip"])
def test_final_scene_lockstep_render(switch):
    """16x16 @ 2 on art_tpu's injected uniforms: after every staged
    iteration, the pool, queue, framebuffer and counters under the route
    equal the default route's."""
    nx = ny = 16
    spp = 2
    _, _, scene = _carried("final_scene", nx, ny)
    t = scene.tables
    P = nx * ny
    R_ = plan_batches(P, spp, max(t.n_spheres, t.n_quads, t.n_boxes), RenderConfig(),
                      "cpu")[2]
    ncols = n_uniform_cols(t)
    uniforms = _threefry(1984, R_, ncols)
    state = []
    for _ in range(2):
        state.append(dict(pool=rk.new_pool(R_, "cpu"), q=torch.zeros(2, dtype=torch.int64),
                          hist=torch.zeros(128, dtype=torch.int64), fb=torch.zeros((P, 3)),
                          lost=torch.zeros(1, dtype=torch.int32)))
    scal = rk.RefillScal(spp, P, 0, P, nx, ny)
    for it in range(128):
        block = torch.from_numpy(uniforms(0, 0, it).copy())
        for s, switches in zip(state, ({}, {switch: True})):
            with routes.using(**switches):
                staged_step(s["pool"], scene.camera, s["q"], it % 2, s["hist"], it, scal, t,
                            scene.background, s["fb"], s["lost"], block=block, ncols=ncols,
                            max_depth=50, gradient=scene.gradient_bg)
        a, b = state
        for k in a["pool"]:
            assert torch.equal(a["pool"][k], b["pool"][k]), (k, it)
        for k in ("q", "hist", "fb", "lost"):
            assert torch.equal(a[k], b[k]), (k, it)
        if not bool(a["pool"]["act"].any()) and int(a["q"][it % 2]) == P * spp:
            break
    assert it > 10 and float(a["fb"].sum()) > 0
