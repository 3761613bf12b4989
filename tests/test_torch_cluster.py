"""K15, the cluster-culled spheres and boxes, against art_tpu on the CPU.

* Tables (``scene/cull.py cluster_tables``): the port's sphere and box rows
  in BVH-leaf order equal art_tpu's ``sph_cl_packed[:n, :9]`` and
  ``box_cl_packed[:n]``, its cluster boxes ``sph_cl_box[:, :6]`` and
  ``box_cl_box[:, :6]`` bit for bit, on bouncing_spheres (moving spheres),
  final_scene (spheres and the ground's boxes) and a field of 64 ``RotateY``
  boxes; the row ranges are exact (the last cluster shorter where art_tpu
  pads); ``tables_from_numpy`` builds the same tables; below 32 of a kind
  there are none.
* The twins against art_tpu's Pallas ``sphere_hit_attrs_clustered`` and
  ``box_hit_attrs_clustered`` in interpret mode (one call each: spheres on
  bouncing_spheres and final_scene, boxes on final_scene and the rotated
  field) at R = 8192 rays from a numpy seed, half aimed at the clusters'
  union box.  Spheres, through art_tpu's two forms of K2: the twin equals
  art_tpu's jnp K2 (``sphere_candidates_p`` + ``sphere_attributes_p``) bit
  for bit and meets K2's tolerances (``test_torch_intersect.py``: the same
  hit and material, t to rtol 1e-5 and atol 5e-5, normals to 1e-4) against
  the Pallas kernel wherever the jnp K2 and the Pallas kernel meet them; at
  final_scene's scale they part on grazing lanes (b*b - a*c cancels) and,
  in the normal, on long aimed directions: counted, and held to bars above
  the measured counts (``APART``).  Boxes, at K6's tolerances
  (``test_plain_k6_matches_art_tpu``): the same hits, materials and
  normals, t to rtol 2e-6 and atol 1e-3; (u, v) to 1e-5, where K6's test
  holds them to 2e-6 on cornell_box's 165-wide boxes: the rotated field's
  boxes are 0.5 to 2.5 wide, so a t that differs in its last ulps (up to
  1.9e-6 here) moves u by that over the width (measured: 5.7e-6 on 30 of
  its hits; on final_scene 2.2e-6 on one, by another division form).
* Each twin against the port's full-table twin (K2's, K6's): t bit for bit
  on every lane, the winner equal but on exact ties between primitives (leaf
  order is not scene order: final_scene's ground boxes share faces).
* Route selection under ``routes.using(cluster=True)`` and ``(bvh=True)``:
  art_tpu's precedence (boxes: clusters before K9 / K10 / K6; spheres: the
  BVH descent, then the clusters, then the other routes), and the records of
  ``closest_surface_p`` under either against the default route's.
* A lock-step final_scene render (16x16 @ 4) under ``ART_TPU_CLUSTER``: every
  pool plane equal after every iteration to the default route's with the
  box grid off, so that its boxes round as K6's (K9's lattice slabs round
  otherwise, ROADMAP §3), on the same injected uniforms."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.ops.intersect import sphere_attributes_p as jax_attrs
from art_tpu.ops.intersect import sphere_candidates_p as jax_candidates
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import compact_sphere as cs
from art_tpu_torch.ops import intersect as I
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops import routes
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.render.integrator import n_uniform_cols, staged_step
from art_tpu_torch.render.renderer import RenderConfig, plan_batches
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import cull
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.scene.builder import tables_from_numpy
from test_torch_scene import _jax_arrays

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
CL_FIELDS = ("sph_cl_rows", "sph_cl_meta", "sph_cl_seg", "n_sphere_clusters", "box_cl_rows",
             "box_cl_meta", "box_cl_seg", "n_box_clusters")


def _rotated_boxes(builder_mod, O, M):
    """64 boxes from a numpy seed, each turned about y and translated."""
    rng = np.random.default_rng(48)
    mats = [M.Lambertian((0.7, 0.3, 0.2)), M.Metal((0.8, 0.8, 0.8), 0.1)]
    b = builder_mod.SceneBuilder()
    for k in range(64):
        size = tuple(float(x) for x in rng.uniform(0.5, 2.5, 3))
        off = tuple(float(x) for x in rng.uniform(-15.0, 15.0, 3))
        b.add(O.Translate(O.RotateY(O.Box((0.0, 0.0, 0.0), size, mats[k % 2]),
                                    float(rng.uniform(-90.0, 90.0))), off))
    b.set_camera(lookfrom=(0, 5, 40), lookat=(0, 0, 0), vup=(0, 1, 0), vfov_degrees=40.0,
                 aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


@pytest.fixture(scope="module")
def scenes():
    """(art_tpu scene, port tables) by name, built once."""
    out = {n: (jax_build_scene(n, 16, 16), build_scene(n, 16, 16).tables)
           for n in ("bouncing_spheres", "final_scene")}
    out["rotated_boxes"] = (_rotated_boxes(jax_builder, JO, JM),
                            _rotated_boxes(port_builder, PO, PM).tables)
    return out


def _assert_clusters(rows, meta, seg, want_rows, want_boxes, n, cols):
    n_head, segs, union = meta
    assert n_head == 0 and len(segs) == want_boxes.shape[0] == -(-n // 64)
    np.testing.assert_array_equal(rows.numpy()[:, :cols], want_rows[:n, :cols])
    assert rows.shape[0] == n and segs[-1][1] == n
    for k, (r0, r1, box) in enumerate(segs):
        assert (r0, r1) == (64 * k, min(64 * k + 64, n))
        np.testing.assert_array_equal(np.float32(box), want_boxes[k, :6])
    np.testing.assert_array_equal(np.float32(union), np.concatenate(
        [want_boxes[:, :3].min(axis=0), want_boxes[:, 3:6].max(axis=0)]))
    np.testing.assert_array_equal(seg.numpy(), cull.seg_table(meta).numpy())


@pytest.mark.parametrize("name", ["bouncing_spheres", "final_scene", "rotated_boxes"])
def test_cluster_tables_match_art_tpu(scenes, name):
    js, t = scenes[name]
    jt = js.tables
    assert t.n_sphere_clusters == jt.n_sphere_clusters
    assert t.n_box_clusters == jt.n_box_clusters
    if t.n_spheres >= 32:
        _assert_clusters(t.sph_cl_rows, t.sph_cl_meta, t.sph_cl_seg,
                         np.asarray(jt.sph_cl_packed), np.asarray(jt.sph_cl_box),
                         t.n_spheres, 9)
    else:
        assert t.sph_cl_rows is None and t.n_sphere_clusters == 0
    if t.n_boxes >= 32:
        _assert_clusters(t.box_cl_rows, t.box_cl_meta, t.box_cl_seg,
                         np.asarray(jt.box_cl_packed), np.asarray(jt.box_cl_box),
                         t.n_boxes, 12)
    else:
        assert t.box_cl_rows is None and t.n_box_clusters == 0
    carried = tables_from_numpy(*_jax_arrays(js))[0]
    for k in CL_FIELDS:
        a, b = getattr(carried, k), getattr(t, k)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
        else:
            assert a == b, k


def test_no_cluster_tables_below_the_gates():
    t = build_scene("cornell_box", 16, 16).tables
    assert 0 < t.n_boxes < 32 and 0 < t.n_spheres < 32
    assert all(not getattr(t, k) for k in CL_FIELDS)


def _rays(seed, box, share, span):
    """R rays from origins uniform in ``span``: a ``share`` of them aimed at
    a point within 0.4 of ``box``'s extent of its centre, the rest in normal
    directions; shutter times uniform."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(*span, (3, R)).astype(np.float32)
    d = rng.normal(size=(3, R)).astype(np.float32)
    lo, hi = np.asarray(box[:3])[:, None], np.asarray(box[3:])[:, None]
    target = (lo + hi) / 2 + rng.uniform(-0.4, 0.4, (3, R)) * (hi - lo)
    d = np.where(rng.random(R) < share, target - o, d).astype(np.float32)
    return o, d, rng.random(R, dtype=np.float32)


_SPAN = {"bouncing_spheres": (-30.0, 30.0), "final_scene": (-500.0, 900.0),
         "rotated_boxes": (-25.0, 25.0)}


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def _jax(o, d, tm):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)


def _np(x):
    return tuple(np.asarray(c) if not isinstance(c, tuple) else tuple(map(np.asarray, c))
                 for c in x)


def _within_k2(got, want):
    """(R,) bool: K2's tolerances per lane (the same hit and material, t to
    rtol 1e-5 and atol 5e-5, normals to 1e-4)."""
    t, n, m = got
    wt, wn, wm = want
    hit = t < BIG
    ok = (hit == (wt < BIG)) & (~hit | (m == wm))
    ok &= ~hit | np.isclose(t, wt, rtol=1e-5, atol=5e-5)
    for c in range(3):
        ok &= ~hit | (np.abs(n[c] - wn[c]) <= 1e-4)
    return ok


# bars on the lanes where art_tpu's jnp K2 and its Pallas K15 part beyond
# K2's tolerances, and where they part in t or the hit alone (measured on
# these rays: bouncing_spheres 38 and 8, final_scene 247 and 0; the rest in
# the normal)
APART = {"bouncing_spheres": (64, 16), "final_scene": (400, 8)}


@pytest.mark.parametrize("name", ["bouncing_spheres", "final_scene"])
def test_sphere_twin_matches_pallas_interpret(scenes, name):
    js, t = scenes[name]
    jt = js.tables
    o, d, tm = _rays(10, t.sph_cl_meta[2], 0.5, _SPAN[name])
    J = _jax(o, d, tm)
    fn = jax.jit(lambda o_, d_, tm_: pk.sphere_hit_attrs_clustered(
        jt.sph_cl_packed, jt.sph_cl_box, o_, d_, tm_, n_clusters=jt.n_sphere_clusters,
        moving=jt.has_moving, needs_uv=False, interpret=True))
    k_t, k_n, _, _, k_m = fn(*J)
    kern = _np((k_t, k_n, k_m))
    j_t, j_i = jax_candidates(jt, *J, T_MIN)
    j_n, _, _, j_m = jax_attrs(jt, *J, j_t, j_i, False)
    ref = _np((j_t, j_n, j_m))
    twin = _np(K.sphere_cluster_hit_attrs_plain(t, *_port(o, d, tm)))
    np.testing.assert_array_equal(twin[0], ref[0])
    hit = twin[0] < BIG
    for a, b in zip((*twin[1], twin[2]), (*ref[1], ref[2])):
        np.testing.assert_array_equal(a[hit], b[hit])
    agree = _within_k2(kern, ref)  # art_tpu's two K2 forms
    assert not (agree & ~_within_k2(twin, kern)).any()
    t_apart = (ref[0] < BIG) != (kern[0] < BIG)
    t_apart |= (ref[0] < BIG) & ~np.isclose(ref[0], kern[0], rtol=1e-5, atol=5e-5)
    bar, t_bar = APART[name]
    assert int((~agree).sum()) <= bar and int(t_apart.sum()) <= t_bar, (
        int((~agree).sum()), int(t_apart.sum()))
    assert int(hit.sum()) > R // 20


@pytest.mark.parametrize("name", ["final_scene", "rotated_boxes"])
def test_box_twin_matches_pallas_interpret(scenes, name):
    js, t = scenes[name]
    jt = js.tables
    o, d, _ = _rays(11, t.box_cl_meta[2], 0.5, _SPAN[name])
    J = _jax(o, d, o[0])[:2]
    fn = jax.jit(lambda o_, d_: pk.box_hit_attrs_clustered(
        jt.box_cl_packed, jt.box_cl_box, o_, d_, n_clusters=jt.n_box_clusters,
        rotated=jt.has_rotated_boxes, interpret=True))
    rt, rn, ru, rv, rm = _np(fn(*J))
    tt, tn, tu, tv, tmat = _np(K.box_cluster_hit_attrs_plain(t, *_port(o, d, o[0])[:2]))
    hit = tt < BIG
    assert t.has_rotated_boxes == (name == "rotated_boxes") and hit.sum() > R // 20
    np.testing.assert_array_equal(hit, rt < BIG)
    np.testing.assert_allclose(tt, rt, rtol=2e-6, atol=1e-3)
    np.testing.assert_array_equal(tmat[hit], rm[hit])
    for c in range(3):
        np.testing.assert_array_equal(tn[c][hit], rn[c][hit])
    np.testing.assert_allclose(tu[hit], ru[hit], atol=1e-5)
    np.testing.assert_allclose(tv[hit], rv[hit], atol=1e-5)
    assert (tn[0][~hit] == 1).all() and (tmat[~hit] == 0).all()


def _box_t_all(rows, rotated, o, d):
    """(R, B) candidate t of every box row (``box_candidates_rows``' matrix)."""
    lo, ld = I._box_frame(rows, o, d, rotated)
    t0s, t1s = I._slabs(lo, ld, [rows[None, :, k] for k in range(3)],
                        [rows[None, :, k] for k in range(3, 6)])
    t0 = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t1 = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    through = t0 < t1
    return torch.where(through & (t0 > T_MIN), t0, torch.where(through & (t1 > T_MIN), t1, BIG))


def _sphere_t_all(rows, o, d, tm):
    return torch.stack([I.sphere_candidates_p(rows[k:k + 1], o, d, tm, T_MIN)[0]
                        for k in range(rows.shape[0])], dim=1)


def _differ(a, b):
    out = a[-1] != b[-1]
    for x, y in zip((*a[1], *a[2:-1]), (*b[1], *b[2:-1])):
        out |= x != y
    return out


# (scene, kind, shares, exact ties counted on those rays)
FULL_CASES = [("bouncing_spheres", "spheres", 0), ("final_scene", "spheres", 0),
              ("final_scene", "boxes", None), ("rotated_boxes", "boxes", 0)]


@pytest.mark.parametrize("name,kind,want_ties", FULL_CASES)
def test_twins_equal_the_full_table_twin(scenes, name, kind, want_ties):
    """t bit for bit on every lane; the winner (normal, u, v, material)
    equal but on lanes where two primitives reach t exactly.  final_scene's
    ground boxes share faces, so rays along a shared edge tie there."""
    _, t = scenes[name]
    box = (t.sph_cl_meta if kind == "spheres" else t.box_cl_meta)[2]
    ties = 0
    for n, share in enumerate((0.0, 0.5, 1.0)):
        o, d, tm = _port(*_rays(20 + n, box, share, _SPAN[name]))
        if kind == "spheres":
            got = K.sphere_cluster_hit_attrs_plain(t, o, d, tm)
            full = K.sphere_hit_attrs_plain(t, o, d, tm)
        else:
            got = K.box_cluster_hit_attrs_plain(t, o, d)
            full = K.box_hit_attrs_plain(t, o, d)
        assert torch.equal(got[0], full[0]), share
        differ = _differ(got, full)
        if bool(differ.any()):
            t_all = (_sphere_t_all(t.sph_rows, o, d, tm) if kind == "spheres"
                     else _box_t_all(t.box_rows, t.has_rotated_boxes, o, d))
            tied = ((t_all == full[0][:, None]) & (full[0][:, None] < BIG)).sum(dim=1) >= 2
            assert not bool((differ & ~tied).any()), share
            ties += int(differ.sum())
        if share:
            assert int((full[0] < BIG).sum()) > R // 20
    if want_ties is not None:
        assert ties == want_ties


def test_cpu_wrappers_take_the_twins(scenes):
    _, t = scenes["final_scene"]
    o, d, tm = _port(*_rays(5, t.box_cl_meta[2], 0.5, _SPAN["final_scene"]))
    for a, b in ((K.sphere_cluster_hit_attrs(t, o, d, tm),
                  K.sphere_cluster_hit_attrs_plain(t, o, d, tm)),
                 (K.box_cluster_hit_attrs(t, o, d), K.box_cluster_hit_attrs_plain(t, o, d))):
        assert torch.equal(a[0], b[0]) and torch.equal(a[-1], b[-1])
    t2 = K.box_cluster_hit_attrs(t, o, d, 300.0)[0]
    assert bool((t2[t2 < BIG] > 300.0).all())


@pytest.fixture
def calls(monkeypatch):
    """The box and sphere functions that closest_surface_p calls itself, by
    name, in order (not the calls inside them)."""
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

    for name in ("box_cluster_hit_attrs_plain", "box_hit_attrs_plain",
                 "box_grid_cells_hit_attrs_plain", "box_grid_hit_attrs_plain",
                 "sphere_cluster_hit_attrs_plain", "sphere_hit_attrs_plain",
                 "sphere_cellbin_hit_attrs_plain", "sphere_skip_hit_attrs_plain"):
        monkeypatch.setattr(K, name, recorder(name.removesuffix("_hit_attrs_plain"),
                                              getattr(K, name)))
    monkeypatch.setattr(cs, "sphere_hit_attrs_split",
                        recorder("split", cs.sphere_hit_attrs_split))
    monkeypatch.setattr(I, "bvh_sphere_candidates_p",
                        recorder("bvh", I.bvh_sphere_candidates_p))
    return seen


# (scene, switches, the box and sphere calls of closest_surface_p in order)
ROUTE_CASES = {
    "default": ("final_scene", {}, ["box_grid_cells", "sphere"]),
    "CLUSTER: boxes before K9, spheres": ("final_scene", dict(cluster=True),
                                          ["box_cluster", "sphere_cluster"]),
    "CLUSTER before every sphere route": (
        "final_scene", dict(cluster=True, sph_cellbin=True, sph_skip=True, compact_sph=True),
        ["box_cluster", "sphere_cluster"]),
    "BVH": ("final_scene", dict(bvh=True), ["box_grid_cells", "bvh"]),
    "BVH before CLUSTER's spheres": ("final_scene", dict(bvh=True, cluster=True),
                                     ["box_cluster", "bvh"]),
    "BVH before K17": ("bouncing_spheres", dict(bvh=True, sph_cellbin=True), ["bvh"]),
    "CLUSTER on bouncing_spheres": ("bouncing_spheres", dict(cluster=True),
                                    ["sphere_cluster"]),
    "CLUSTER before K6": ("rotated_boxes", dict(cluster=True), ["box_cluster"]),
    "K6 by default": ("rotated_boxes", {}, ["box"]),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_selection(scenes, calls, case):
    name, switches, want = ROUTE_CASES[case]
    _, t = scenes[name]
    rays = _port(*_rays(3, (t.sph_cl_meta or t.box_cl_meta)[2], 0.5, _SPAN[name]))
    with routes.using(**switches):
        closest_surface_p(t, *rays, T_MIN, plain=True)
    assert calls == want


def test_routes_need_their_tables(calls):
    """Without clusters (fewer than 32 of a kind) or a BVH (one sphere)
    the switches take the default routes."""
    t = build_scene("cornell_box", 16, 16).tables
    rays = _port(*_rays(4, (0, 0, 0, 555, 555, 555), 0.5, (0.0, 555.0)))
    with routes.using(cluster=True):
        closest_surface_p(t, *rays, T_MIN, plain=True)
    assert calls == ["box", "sphere"]
    calls.clear()
    t = build_scene("quads", 16, 16).tables
    with routes.using(bvh=True, cluster=True):
        closest_surface_p(t, *rays, T_MIN, plain=True)
    assert calls == (["sphere"] if t.n_spheres else [])


def test_routes_from_the_environment():
    assert routes.from_environ({"ART_TPU_CLUSTER": "1"}) == routes.Routes(cluster=True)
    assert routes.from_environ({"ART_TPU_BVH": "1"}) == routes.Routes(bvh=True)
    assert not routes.Routes().cluster and not routes.Routes().bvh


@pytest.mark.parametrize("switches", [dict(cluster=True), dict(bvh=True)])
def test_records_equal_the_default_route(scenes, switches):
    """closest_surface_p on final_scene rays: under CLUSTER equal to the
    default route with the grid off (boxes through K6's twin) in every
    field; under BVH equal to the default route in t, and in every field but
    on exact ties (none on these rays)."""
    _, t = scenes["final_scene"]
    rays = _port(*_rays(6, t.sph_cl_meta[2], 0.5, _SPAN["final_scene"]))
    base = t if switches.get("bvh") else dataclasses.replace(t, box_grid_kx=0)
    want = closest_surface_p(base, *rays, T_MIN, plain=True)
    with routes.using(**switches):
        got = closest_surface_p(t, *rays, T_MIN, plain=True)
    for k in ("t", "u", "v", "mat"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for c in range(3):
        assert torch.equal(got.normal[c], want.normal[c])
    assert int(want.hit.sum()) > R // 4


def test_final_scene_lockstep_render():
    """16x16 @ 4 on injected numpy uniforms: after every staged iteration
    the pool, queue, framebuffer and counters under ART_TPU_CLUSTER equal
    the default route's with the grid off."""
    nx = ny = 16
    spp = 4
    scene = build_scene("final_scene", nx, ny)
    t = scene.tables
    P = nx * ny
    R_ = plan_batches(P, spp, max(t.n_spheres, t.n_quads, t.n_boxes), RenderConfig(),
                      "cpu")[2]
    ncols = n_uniform_cols(t)
    rng = np.random.default_rng(77)
    state = []
    for _ in range(2):
        state.append(dict(pool=rk.new_pool(R_, "cpu"), q=torch.zeros(2, dtype=torch.int64),
                          hist=torch.zeros(128, dtype=torch.int64), fb=torch.zeros((P, 3)),
                          lost=torch.zeros(1, dtype=torch.int32)))
    scal = rk.RefillScal(spp, P, 0, P, nx, ny)
    no_grid = dataclasses.replace(t, box_grid_kx=0)
    for it in range(128):
        block = torch.from_numpy(rng.random((ncols, R_), dtype=np.float32))
        for s, tables, switches in zip(state, (no_grid, t), ({}, dict(cluster=True))):
            with routes.using(**switches):
                staged_step(s["pool"], scene.camera, s["q"], it % 2, s["hist"], it, scal,
                            tables, scene.background, s["fb"], s["lost"], block=block,
                            ncols=ncols, max_depth=50, gradient=scene.gradient_bg)
        a, b = state
        for k in a["pool"]:
            assert torch.equal(a["pool"][k], b["pool"][k]), (k, it)
        for k in ("q", "hist", "fb", "lost"):
            assert torch.equal(a[k], b[k]), (k, it)
        if not bool(a["pool"]["act"].any()) and int(a["q"][it % 2]) == P * spp:
            break
    assert it > 10 and float(a["fb"].sum()) > 0
