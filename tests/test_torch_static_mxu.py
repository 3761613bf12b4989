"""K13 (the baked spheres), K14 (the bilinear-feature spheres) and the
split's MXU tail against art_tpu on the CPU.

* Tables: the port's ``static_sphere_cells``, ``sph_expand`` and
  ``sph_pos_r`` equal art_tpu's value for value on bouncing_spheres,
  cornell_box (a hollow shell: ``pos_r`` False) and final_scene (a
  1000-row tail); ``sph_mxu_feat``, ``sph_mxu_attr``, ``mxu_sphere_pad``
  and the recentered tail tables bit for bit; the scale gate rejects
  final_scene; ``tables_from_numpy`` carries art_tpu's.
* K13's twin against art_tpu's Pallas ``sphere_static_hit_attrs`` in
  interpret mode, on hand-packed cells in the three forms of
  tests/test_pallas_kernels.py:708-803 (8 moving rows with a hollow-glass
  radius, direct; 8 moving rows, expanded; none moving) and on a 64-sphere
  cut of bouncing_spheres' cells (interpret mode takes minutes on all 488),
  at that test's bars: hit sets agree on > 99.9% of lanes, t within 2e-5
  relative / 1e-5 absolute on >= 98% and 2e-2 / 1e-2 on all, materials equal
  on the tight lanes, normals within 1e-3 / 2e-3 (the TPU kernel rejects
  roots by NaN and, with ``pos_r``, normalizes by rsqrt).
* K13's twin against the full-table K2 twin: in the direct form t bit for
  bit on every lane and the winner equal but on exact ties; in the expanded
  form the same hits and materials, with t and the normals within the
  expanded quadratic's rounding bound (``expanded_bound``): at the scenes'
  scale the bars above hold on only 87-98% of the hits.
* K14's twin against art_tpu's Pallas ``sphere_hit_attrs_mxu`` in interpret
  mode on bouncing_spheres' gated tables, at
  tests/test_pallas_kernels.py:643-693's bars (hits > 99.9%, t 2e-5 / 1e-3
  with a budget of 2 loose lanes, materials, normals 1e-3 / 4e-3).
* The split's MXU-tail dense branch against the dense K2 route on
  final_scene, at tests/test_compact_sphere.py:204-250's bars.
* ``closest_surface_p`` under each new switch against art_tpu's plain
  record: K13's direct form at K2's tolerances (tests/test_torch_cluster.py
  ``_within_k2``) on every lane; the expanded quadratic (K13's builder
  form, K14, the MXU tail) at the expanded quadratic's bar of
  tests/test_compact_sphere.py, with the lanes apart at K2's tolerances
  counted and held to bars; under ``ART_TPU_MXU_SPHERES`` also the lanes
  where art_tpu's own two forms (its Pallas K14 and its jnp K2) part.
* The route order (``art_tpu/ops/intersect.py:611-700``),
  ``routes.from_environ`` with the four new route names, and the builder's
  ``ART_TPU_MXU_FORCE``."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import compact_sphere as cs
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import routes
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene.builder import tables_from_numpy
from test_pallas_kernels import _assert_two_tier, _hand_packed_spheres
from test_torch_cluster import _within_k2
from test_torch_scene import _jax_arrays

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
DENSE = dict(compact_sph=True, force_branch="dense")  # the split's dense branch
NAMES = ("bouncing_spheres", "cornell_box", "final_scene")


@pytest.fixture(scope="module")
def scenes():
    """(art_tpu tables, port tables) by name, built once."""
    return {n: (jax_build_scene(n, 16, 16).tables, build_scene(n, 16, 16).tables)
            for n in NAMES}


def _rays(seed, span=20.0, centre=(0.0, 3.0, 0.0)):
    """Origins uniform in a cube of side ``span`` about ``centre``, normal
    directions (not normalized, as camera rays), shutter times uniform."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((3, R)) - 0.5) * span + np.asarray(centre)[:, None]).astype(np.float32)
    d = rng.normal(size=(3, R)).astype(np.float32)
    return o, d, rng.random(R, dtype=np.float32)


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def _jax(o, d, tm):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)


def _np(rec):
    t, n, m = rec
    return np.asarray(t), tuple(np.asarray(c) for c in n), np.asarray(m)


_SPAN = {"bouncing_spheres": dict(span=60.0, centre=(0.0, 3.0, 0.0)),
         "cornell_box": dict(span=555.0, centre=(277.5, 277.5, 277.5)),
         "final_scene": dict(span=1400.0, centre=(200.0, 200.0, 200.0))}


# ---- tables ----------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_sphere_kernel_tables_match_art_tpu(scenes, name):
    jt, t = scenes[name]
    assert t.sph_static_cells == jt.sph_static_cells
    assert (t.sph_expand, t.sph_pos_r) == (jt.sph_expand, jt.sph_pos_r)
    assert t.sph_pos_r == (name != "cornell_box")
    assert t.mxu_sphere_pad == jt.mxu_sphere_pad
    assert t.mxu_tail_pad == jt.mxu_tail_pad
    assert t.sph_tail_centroid == jt.sph_tail_centroid
    for k, pad in (("sph_mxu_feat", t.mxu_sphere_pad), ("sph_mxu_attr", t.mxu_sphere_pad),
                   ("sph_mxu_tail_feat", t.mxu_tail_pad),
                   ("sph_mxu_tail_attr", t.mxu_tail_pad)):
        if pad:
            np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(jt, k)),
                                          err_msg=k)
        else:
            assert getattr(t, k) is None, k
    # bouncing_spheres takes K14's features; final_scene's scale is gated out
    # (tests/test_pallas_kernels.py:696) but its tail's recentered ones are in
    assert (t.mxu_sphere_pad > 0) == (name == "bouncing_spheres")
    assert (t.mxu_tail_pad > 0) == (name == "final_scene")
    moving, main, tail = t.sph_static_cells
    assert len(moving) + len(main) + len(tail) == t.n_spheres
    assert len(tail) == t.sph_n_tail


def test_tables_from_numpy_carries_the_sphere_kernel_tables():
    js = jax_build_scene("final_scene", 16, 16)
    arrays, cam = _jax_arrays(js)
    jt = js.tables
    extra = {k: getattr(jt, k) for k in port_builder._SPH_KERNEL_META}
    extra.update({k: np.asarray(getattr(jt, k)) for k in port_builder._MXU_ARRAYS})
    carried = tables_from_numpy({**arrays, **extra}, cam)[0]
    derived = tables_from_numpy(arrays, cam)[0]
    for t in (carried, derived):
        assert t.sph_static_cells == jt.sph_static_cells
        assert t.sph_tail_centroid == jt.sph_tail_centroid and t.mxu_sphere_pad == 0
        assert t.sph_mxu_feat is None
        np.testing.assert_array_equal(t.sph_mxu_tail_feat.numpy(),
                                      np.asarray(jt.sph_mxu_tail_feat))


def test_mxu_force_passes_the_scale_gate():
    """``mxu_force`` makes K14's tables past the scale gate; the builder
    reads its default from ``ART_TPU_MXU_FORCE`` at import."""
    t = build_scene("final_scene", 16, 16).tables
    assert t.mxu_sphere_pad == 0 and not port_builder.MXU_FORCE
    tail = dict(sph_n_tail=t.sph_n_tail, sph_tail_r=t.sph_tail_r,
                sph_tail_mat=t.sph_tail_mat, sph_tail_box=t.sph_tail_box)
    forced = port_builder._sphere_kernel_tables(t.sph_rows.numpy(), tail,
                                                t.sph_tail_rows.numpy(), mxu_force=True)
    assert forced["mxu_sphere_pad"] == 1024 and forced["sph_mxu_feat"].shape == (2048, 16)
    code = "from art_tpu_torch.scene import builder; print(builder.MXU_FORCE)"
    env = dict(os.environ, ART_TPU_MXU_FORCE="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.split() == ["True"]


# ---- K13 -------------------------------------------------------------------

def _assert_static_bars(got, want):
    """tests/test_pallas_kernels.py:708-803's bars on (t, normal, mat)."""
    t, n, m = got
    wt, wn, wm = want
    hit, w_hit = t < BIG * 0.5, wt < BIG * 0.5
    assert hit.any() and (~hit).any()
    assert (hit == w_hit).mean() > 0.999
    both = hit & w_hit
    tight = _assert_two_tier(t[both], wt[both], tight_rtol=2e-5, tight_atol=1e-5)
    np.testing.assert_array_equal(m[both][tight], wm[both][tight])
    for c in range(3):
        np.testing.assert_allclose(n[c][both][tight], wn[c][both][tight], rtol=1e-3,
                                   atol=2e-3)


def _with_cells(tables, cells, tail_r, tail_mat):
    return dataclasses.replace(tables, sph_static_cells=cells, sph_tail_r=tail_r,
                               sph_tail_mat=tail_mat)


@pytest.mark.parametrize("n_mov,expand,neg_radius", [(8, False, True), (8, True, False),
                                                     (0, False, False)])
def test_static_twin_matches_pallas_interpret_hand_packed(scenes, n_mov, expand, neg_radius):
    tail_r, tail_mat = 0.35, 7.0
    packed, n_moving_pad, n_static = _hand_packed_spheres(42 + n_mov, n_mov, 5, 35, tail_r,
                                                          tail_mat, neg_radius=neg_radius)
    cells = pk.static_sphere_cells(packed, n_moving_pad, n_static, 35)
    o, d, tm = _rays(11 + n_mov, span=24.0)
    t_j, n_j, _, _, m_j = pk.sphere_static_hit_attrs(
        *_jax(o, d, tm), cells=cells, tail_r=tail_r, tail_mat=tail_mat,
        pos_r=not neg_radius, expand=expand, needs_uv=False, interpret=True)
    tables = _with_cells(scenes["bouncing_spheres"][1], cells, tail_r, tail_mat)
    got = _np(K.sphere_static_hit_attrs_plain(tables, *_port(o, d, tm), expand=expand))
    _assert_static_bars(got, _np((t_j, n_j, m_j)))


def test_static_twin_matches_pallas_interpret_bouncing_cut(scenes):
    """48 moving and 16 main rows of bouncing_spheres' cells, in the
    builder's form (expanded)."""
    jt, t = scenes["bouncing_spheres"]
    moving, main, _ = jt.sph_static_cells
    cells = (moving[:48], main[:16], ())
    o, d, tm = _rays(12, span=30.0)
    t_j, n_j, _, _, m_j = pk.sphere_static_hit_attrs(
        *_jax(o, d, tm), cells=cells, tail_r=1.0, tail_mat=0.0, pos_r=True,
        expand=t.sph_expand, needs_uv=False, interpret=True)
    got = _np(K.sphere_static_hit_attrs_plain(_with_cells(t, cells, 1.0, 0.0),
                                              *_port(o, d, tm), expand=t.sph_expand))
    _assert_static_bars(got, _np((t_j, n_j, m_j)))


def _sphere_t_all(rows, o, d, tm):
    from art_tpu_torch.ops.intersect import sphere_candidates_p
    return torch.stack([sphere_candidates_p(rows[k:k + 1], o, d, tm, T_MIN)[0]
                        for k in range(rows.shape[0])], dim=1)


def expanded_bound(rows, o, d, tm, idx):
    """(R,) float64 bound on |t_expanded - t_direct| at the winner ``idx`` of
    ``rows``: the expanded quadratic rounds its c = |o|^2 + K - 2 o.c to
    within dc = 8 eps (|o|^2 + |c|^2) and its b = o.d - c.d to within
    db = 4 eps |d| (|o| + |c|), and a root of a t^2 + 2 b t + c moves by
    (dc / 2 + |t| db) / sqrt(disc) (eps = 2^-23); the direct form's own
    rounding is far below it."""
    eps = 2.0 ** -23
    row = rows[idx.long()].double().numpy()
    O = np.stack([x.double().numpy() for x in o], 1)
    D = np.stack([x.double().numpy() for x in d], 1)
    c = row[:, 0:3] + tm.double().numpy()[:, None] * row[:, 3:6]
    oc = O - c
    b = (oc * D).sum(1)
    disc = b * b - (D * D).sum(1) * ((oc * oc).sum(1) - row[:, 8])
    no2, nc2 = (O * O).sum(1), (c * c).sum(1)
    dc = 8 * eps * (no2 + nc2)
    db = 4 * eps * np.sqrt((D * D).sum(1)) * (np.sqrt(no2) + np.sqrt(nc2))
    return dc, db, np.sqrt(np.maximum(disc, 1e-30))


@pytest.mark.parametrize("name", NAMES)
def test_static_twin_against_the_full_table_k2(scenes, name):
    """Direct form: t bit for bit; a winner that differs ties exactly with
    another sphere (moving-first order, the tail merged once).  Expanded
    form: the same hits on > 99.9% of lanes, the same materials, and t and
    the normals within the expanded quadratic's rounding bound
    (``expanded_bound``, plus 2e-5 relative and 1e-5; measured at most 0.2
    of it): at these scenes' scale (coordinates to ~1000) the TPU test's
    2e-5 tier holds on only 87-98% of the hits."""
    from art_tpu_torch.ops.intersect import sphere_candidates_p

    t = scenes[name][1]
    rays = _port(*_rays(20, **_SPAN[name]))
    full = K.sphere_hit_attrs_plain(t, *rays)
    got = K.sphere_static_hit_attrs_plain(t, *rays, expand=False)
    assert torch.equal(got[0], full[0])
    differ = got[2] != full[2]
    for c in range(3):
        differ |= got[1][c] != full[1][c]
    if bool(differ.any()):
        t_all = _sphere_t_all(t.sph_rows, *rays)
        tied = ((t_all == full[0][:, None]) & (full[0][:, None] < BIG)).sum(dim=1) >= 2
        assert not bool((differ & ~tied).any())
    assert int((full[0] < BIG).sum()) > R // 50
    ft, fn, fm = _np(full)
    gt, gn, gm = _np(K.sphere_static_hit_attrs_plain(t, *rays, expand=True))
    hit, g_hit = ft < BIG * 0.5, gt < BIG * 0.5
    assert (hit == g_hit).mean() > 0.999
    both = hit & g_hit
    dc, db, sq = expanded_bound(t.sph_rows, *rays, sphere_candidates_p(t.sph_rows, *rays,
                                                                      T_MIN)[1])
    tt = ft.astype(np.float64)
    bound = (dc / 2 + np.abs(tt) * db) / sq + 2e-5 * np.abs(tt) + 1e-5
    assert (np.abs(gt - tt) <= bound)[both].all()
    np.testing.assert_array_equal(gm[both], fm[both])
    d_len = np.sqrt(sum(x.double().numpy() ** 2 for x in rays[1]))
    r = np.abs(t.sph_rows[:, 6].double().numpy()).min()
    for c in range(3):
        assert (np.abs(gn[c] - fn[c]) <= d_len * bound / r + 2e-3)[both].all()


# ---- K14 and the MXU tail ----------------------------------------------------

def test_mxu_twin_matches_pallas_interpret(scenes, records, mxu_pallas):
    t = scenes["bouncing_spheres"][1]
    wt, wn, wm = mxu_pallas
    gt, gn, gm = _np(K.sphere_mxu_hit_attrs_plain(t.sph_mxu_feat, t.sph_mxu_attr,
                                                  *_port(*records["bouncing_spheres"][0])))
    hit, w_hit = gt < BIG * 0.5, wt < BIG * 0.5
    assert hit.any() and (~hit).any()
    assert (hit == w_hit).mean() > 0.999
    both = hit & w_hit
    tight = _assert_two_tier(gt[both], wt[both], tight_rtol=2e-5, tight_atol=1e-3,
                             loose_budget=2)
    np.testing.assert_array_equal(gm[both][tight], wm[both][tight])
    for c in range(3):
        np.testing.assert_allclose(gn[c][both][tight], wn[c][both][tight], rtol=1e-3,
                                   atol=4e-3)
    assert (gn[0][~hit] == 1).all() and (gm[~hit] == 0).all()


def _tail_rays(t, seed=1):
    """tests/test_compact_sphere.py:204-250's rays: origins about the tail's
    centroid with a spread of 400, aimed within 120 of it; time 0."""
    rng = np.random.default_rng(seed)
    ctr = np.array(t.sph_tail_centroid)
    o = ctr + rng.normal(0, 400, (R, 3))
    d = ctr + rng.normal(0, 120, (R, 3)) - o
    return (o.T.astype(np.float32), d.T.astype(np.float32), np.zeros(R, np.float32))


def test_mxu_tail_dense_branch_close_to_k2(scenes):
    t = scenes["final_scene"][1]
    rays = _port(*_tail_rays(t))
    a = K.sphere_hit_attrs_plain(t, *rays)
    b = cs.sphere_hit_attrs_mxu_tail(t, *rays, plain=True)
    ta, tb = a[0].numpy(), b[0].numpy()
    assert ((ta < 1e9) == (tb < 1e9)).all()
    m = ta < 1e9
    assert m.mean() > 0.2
    rel = np.abs(ta[m] - tb[m]) / np.maximum(ta[m], 1e-6)
    assert np.percentile(rel, 99) < 1e-3
    na = torch.stack(a[1], 1).numpy()[m]
    nb = torch.stack(b[1], 1).numpy()[m]
    assert (np.abs(na - nb).max(1) > 1e-2).mean() < 0.005
    assert (a[2].numpy()[m] == b[2].numpy()[m]).all()


# ---- closest_surface_p under each switch -------------------------------------

def _jax_record(jt, o, d, tm):
    rec = jax_closest(jt, *_jax(o, d, tm), T_MIN)
    return _np((rec.t, rec.normal, rec.mat))


def _port_record(t, rays, **switches):
    with routes.using(**switches):
        rec = closest_surface_p(t, *rays, T_MIN, plain=True)
    return _np((rec.t, rec.normal, rec.mat))


RS = 8320  # above the split's SPH_K (8192), so its gate holds


def _record_rays(name, t):
    """bouncing_spheres: 8192 rays through the scene's volume; final_scene:
    8192 aimed at the tail (``_tail_rays``) and 128 through the scene."""
    if name != "final_scene":
        return _rays(30, **_SPAN[name])
    o, d, tm = _tail_rays(t, 3)
    rng = np.random.default_rng(4)
    o = np.concatenate([o, rng.uniform(-500, 900, (3, RS - R)).astype(np.float32)], 1)
    d = np.concatenate([d, rng.normal(size=(3, RS - R)).astype(np.float32)], 1)
    return o, d, np.concatenate([tm, rng.random(RS - R, dtype=np.float32)])


# (scene, switches, the direct form, the bar on lanes apart from art_tpu's
# plain record at K2's tolerances; measured on these rays: 0, 0, 85, 1607,
# 1032 and 161)
RECORD_CASES = {
    "SPH_STATIC direct, bouncing_spheres": ("bouncing_spheres", dict(sph_static=True), True, 0),
    "SPH_STATIC direct, final_scene": ("final_scene", dict(sph_static=True), True, 0),
    "SPH_STATIC, bouncing_spheres": ("bouncing_spheres", dict(sph_static=True), False, 128),
    "SPH_STATIC, final_scene": ("final_scene", dict(sph_static=True), False, 2400),
    "MXU_TAIL, final_scene": ("final_scene", dict(**DENSE, mxu_tail=True), False, 1600),
    "MXU_SPHERES, bouncing_spheres": ("bouncing_spheres", dict(mxu_spheres=True), False, 256),
}


@pytest.fixture(scope="module")
def records(scenes):
    """The record rays of each scene and art_tpu's plain record on them."""
    out = {}
    for name in ("bouncing_spheres", "final_scene"):
        jt, t = scenes[name]
        rays = _record_rays(name, t)
        out[name] = rays, _jax_record(jt, *rays)
    return out


@pytest.fixture(scope="module")
def mxu_pallas(scenes, records):
    """art_tpu's Pallas K14 (interpret mode) on bouncing_spheres' record rays."""
    jt = scenes["bouncing_spheres"][0]
    rays = records["bouncing_spheres"][0]
    t_j, n_j, _, _, m_j = pk.sphere_hit_attrs_mxu(
        jt.sph_mxu_feat, jt.sph_mxu_attr, *_jax(*rays), s_pad=jt.mxu_sphere_pad,
        needs_uv=False, interpret=True)
    return _np((t_j, n_j, m_j))


@pytest.mark.parametrize("case", list(RECORD_CASES))
def test_records_against_art_tpu(scenes, records, case):
    """closest_surface_p under each switch against art_tpu's plain record.
    K13's direct form meets K2's tolerances on every lane.  The expanded
    quadratic (K13 in the builder's form, expanded on both scenes; K14 and
    the MXU tail) parts from it at these scales, so it is held to the
    expanded quadratic's bar of tests/test_compact_sphere.py:204-250 (the
    same hits, t within 1e-3 relative at the 99th percentile, normals beyond
    1e-2 on < 0.5% of the hits) with its materials equal on >= 99.9% of the
    hits, and the lanes apart at K2's tolerances are counted."""
    name, switches, direct, bar = RECORD_CASES[case]
    jt, t = scenes[name]
    if direct:
        t = dataclasses.replace(t, sph_expand=False)
    assert direct or not switches.get("sph_static") or t.sph_expand
    (o, d, tm), want = records[name]
    got = _port_record(t, _port(o, d, tm), **switches)
    apart = int((~_within_k2(got, want)).sum())
    assert apart <= bar, apart
    hit, w_hit = got[0] < BIG * 0.5, want[0] < BIG * 0.5
    assert (hit == w_hit).mean() > 0.999 and w_hit.sum() > len(tm) // 10
    m = hit & w_hit
    rel = np.abs(got[0][m] - want[0][m]) / np.maximum(want[0][m], 1e-6)
    assert np.percentile(rel, 99) < 1e-3
    normal_apart = np.abs(np.stack(got[1], 1)[m] - np.stack(want[1], 1)[m]).max(1) > 1e-2
    assert normal_apart.mean() < 0.005
    assert (got[2][m] == want[2][m]).mean() >= 0.999


def test_mxu_record_where_art_tpu_forms_agree(scenes, records, mxu_pallas):
    """Under MXU_SPHERES on bouncing_spheres, against art_tpu's Pallas K14
    (interpret mode) and its plain record: the lanes where art_tpu's two
    forms part at K2's tolerances (measured 155 on these rays), and the
    lanes where they meet them and the port does not (measured 10: the
    port sums the features in column order, the TPU's matmul otherwise)."""
    t = scenes["bouncing_spheres"][1]
    rays, want = records["bouncing_spheres"]
    agree = _within_k2(mxu_pallas, want)
    got = _port_record(t, _port(*rays), mxu_spheres=True)
    assert int((~agree).sum()) <= 256, int((~agree).sum())
    assert int((agree & ~_within_k2(got, want)).sum()) <= 24


@pytest.fixture
def calls(monkeypatch):
    """The sphere functions closest_surface_p calls itself, by name."""
    seen, depth = [], [0]

    def recorder(name, fn):
        def spy(*a, **kw):
            if depth[0] == 0:
                seen.append(name)
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return spy

    for name in ("sphere_hit_attrs_plain", "sphere_static_hit_attrs_plain",
                 "sphere_mxu_hit_attrs_plain", "sphere_cellbin_hit_attrs_plain",
                 "sphere_cluster_hit_attrs_plain", "sphere_skip_hit_attrs_plain"):
        monkeypatch.setattr(K, name, recorder(name.removesuffix("_hit_attrs_plain"),
                                              getattr(K, name)))
    for name in ("sphere_hit_attrs_split", "sphere_hit_attrs_mxu_tail"):
        monkeypatch.setattr(cs, name, recorder(name.removeprefix("sphere_hit_attrs_"),
                                               getattr(cs, name)))
    return seen


# (scene, switches, the sphere calls of closest_surface_p), art_tpu's order
ROUTE_CASES = {
    "MXU_SPHERES": ("bouncing_spheres", dict(mxu_spheres=True), ["sphere_mxu"]),
    "CLUSTER before MXU_SPHERES": ("bouncing_spheres", dict(cluster=True, mxu_spheres=True),
                                   ["sphere_cluster"]),
    "MXU_SPHERES before SPH_STATIC": ("bouncing_spheres",
                                      dict(mxu_spheres=True, sph_static=True), ["sphere_mxu"]),
    "MXU_SPHERES needs its features": ("final_scene", dict(mxu_spheres=True), ["sphere"]),
    "SPH_STATIC": ("final_scene", dict(sph_static=True), ["sphere_static"]),
    "SPH_STATIC before SPH_CELLBIN": ("bouncing_spheres",
                                      dict(sph_static=True, sph_cellbin=True),
                                      ["sphere_static"]),
    "MXU_TAIL in the dense branch": ("final_scene", dict(**DENSE, mxu_tail=True),
                                     ["mxu_tail"]),
    "MXU_TAIL before COMPACT_CELLBIN": ("final_scene",
                                        dict(**DENSE, mxu_tail=True, compact_cellbin=True),
                                        ["mxu_tail"]),
    "SPH_CELLBIN before the dense branch": ("final_scene",
                                            dict(**DENSE, mxu_tail=True, sph_cellbin=True),
                                            ["sphere_cellbin"]),
    "MXU_TAIL only in the dense branch": ("final_scene",
                                          dict(compact_sph=True, mxu_tail=True), ["split"]),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_selection(scenes, calls, case):
    name, switches, want = ROUTE_CASES[case]
    t = scenes[name][1]
    o, d, tm = _rays(3, **_SPAN[name])
    rng = np.random.default_rng(3)
    extra = RS - R  # a pool above SPH_K for the split's gate
    rays = _port(np.concatenate([o, o[:, :extra]], 1), np.concatenate(
        [d, rng.normal(size=(3, extra)).astype(np.float32)], 1),
        np.concatenate([tm, tm[:extra]]))
    with routes.using(**switches):
        closest_surface_p(t, *rays, T_MIN, plain=True)
    assert calls == want


def test_routes_from_the_environment():
    names = {"ART_TPU_SEAM_FLUSH": "seam_flush", "ART_TPU_SPH_STATIC": "sph_static",
             "ART_TPU_MXU_SPHERES": "mxu_spheres", "ART_TPU_MXU_TAIL": "mxu_tail"}
    default = routes.Routes()
    assert not any(getattr(default, f) for f in names.values())  # all opt-in
    for env, field in names.items():
        assert routes.from_environ({env: "1"}) == routes.Routes(**{field: True})
        assert routes.from_environ({env: ""}) == default


def test_cpu_wrappers_take_the_twins(scenes):
    t = scenes["bouncing_spheres"][1]
    rays = _port(*_rays(5))
    for a, b in ((K.sphere_static_hit_attrs(t, *rays, expand=True),
                  K.sphere_static_hit_attrs_plain(t, *rays, expand=True)),
                 (K.sphere_mxu_hit_attrs(t.sph_mxu_feat, t.sph_mxu_attr, *rays),
                  K.sphere_mxu_hit_attrs_plain(t.sph_mxu_feat, t.sph_mxu_attr, *rays))):
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    with pytest.raises(ValueError):  # both kernels bake t_min = 1e-3
        K.sphere_static_hit_attrs(t, *rays, 0.01)
