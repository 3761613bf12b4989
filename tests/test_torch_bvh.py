"""The port's BVH (``art_tpu_torch/ops/bvh.py``) and its per-ray descent
route (``ops/intersect.bvh_sphere_candidates_p``, ``ART_TPU_BVH``) against
art_tpu on the CPU.

* Host functions, bit for bit against ``art_tpu/ops/bvh.py``: ``build_bvh``
  (every node's float32 box, escape link and primitive), ``leaf_order``,
  ``cluster_primitives``, ``sphere_world_bounds``, ``box_world_bounds`` and
  ``pack_bvh`` on seeded random boxes, with and without ties in the box
  minima (the stable sort's tie rule), and the ``sph_bvh`` tables of
  bouncing_spheres (moving spheres: swept boxes) and final_scene.
* The descent on R = 8192 seeded rays: ``traverse_closest_packed`` with a
  primitive test in each framework, bit for bit; ``bvh_sphere_candidates_p``
  against art_tpu's two forms of the same candidate arithmetic: bit for bit
  against its op-by-op jnp K2 (``sphere_candidates_p``), and within K2's
  tolerances (``test_torch_intersect.py``: rtol 1e-5, atol 5e-5) against its
  descent on every lane where art_tpu's two forms meet them.  They do not
  everywhere: art_tpu's descent is one compiled ``while_loop`` body, which
  XLA fuses and rounds otherwise on grazing lanes (measured: 4 to 11 lanes
  of 8192 beyond the tolerances, counted and held to 16).  Against the
  port's full-table K2 twin, t bit for bit on every lane (the BVH boxes are
  rounded to nearest, so a grazing ray could in principle miss a leaf: none
  does on these rays), the winner equal but on exact ties (counted: none);
  the exit test every ``CHECK_EVERY`` steps gives what a test every step
  gives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import bvh as jbvh
from art_tpu.ops.intersect import bvh_sphere_candidates_p as jax_bvh_candidates
from art_tpu.ops.intersect import sphere_candidates_p as jax_candidates
from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import bvh
from art_tpu_torch.ops.intersect import bvh_sphere_candidates_p, sphere_candidates_p
from art_tpu_torch.scene.builder import tables_from_numpy
from test_torch_scene import _jax_arrays

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192


def _boxes(seed, n, ties: bool):
    """n random boxes; with ``ties`` the minima lie on a coarse lattice, so
    many tie along every axis."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-10.0, 10.0, (n, 3))
    if ties:
        lo = np.round(lo / 4.0) * 4.0
    return lo.astype(np.float32), (lo + rng.uniform(0.1, 2.0, (n, 3))).astype(np.float32)


def _assert_trees_equal(got, want):
    for k in ("bbox_min", "bbox_max", "escape", "prim"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.n_nodes == want.n_nodes


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_build_bvh_matches_art_tpu(n, ties):
    lo, hi = _boxes(n, n, ties)
    got, want = bvh.build_bvh(lo, hi), jbvh.build_bvh(lo, hi)
    _assert_trees_equal(got, want)
    assert got.n_nodes == 2 * n - 1
    np.testing.assert_array_equal(bvh.leaf_order(got), jbvh.leaf_order(want))
    np.testing.assert_array_equal(bvh.pack_bvh(got), jbvh.pack_bvh(want))
    assert sorted(bvh.leaf_order(got)) == list(range(n))


def test_build_bvh_empty():
    tree = bvh.build_bvh(np.zeros((0, 3)), np.zeros((0, 3)))
    assert tree.n_nodes == 0 and bvh.pack_bvh(tree).shape == (0, 8)


@pytest.mark.parametrize("n", [64, 100, 257])
def test_cluster_primitives_matches_art_tpu(n):
    """The port's rows are art_tpu's first n (exact ranges, no padding);
    boxes, cluster count and order equal."""
    lo, hi = _boxes(50 + n, n, ties=True)
    packed = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    want = jbvh.cluster_primitives(lo, hi, packed, 64, pad_row=np.ones(5, np.float32))
    assert want[0].shape[0] == 64 * want[2]
    rows, boxes, n_cl, order = bvh.cluster_primitives(lo, hi, packed, 64)
    np.testing.assert_array_equal(rows, want[0][:n])
    np.testing.assert_array_equal(boxes, want[1])
    assert n_cl == want[2] == -(-n // 64)
    np.testing.assert_array_equal(order, want[3])


def test_world_bounds_match_art_tpu():
    rng = np.random.default_rng(3)
    n = 200
    c = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    v = np.where(rng.random((n, 1)) < 0.5, rng.normal(size=(n, 3)), 0).astype(np.float32)
    r = (rng.uniform(0.1, 3.0, n) * np.where(rng.random(n) < 0.2, -1, 1)).astype(np.float32)
    for a, b in zip(bvh.sphere_world_bounds(c, v, r), jbvh.sphere_world_bounds(c, v, r)):
        np.testing.assert_array_equal(a, b)
    lo, hi = _boxes(4, n, ties=False)
    theta = rng.uniform(-np.pi, np.pi, n)
    args = (lo, hi, np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32),
            rng.uniform(-20, 20, (n, 3)).astype(np.float32))
    for a, b in zip(bvh.box_world_bounds(*args), jbvh.box_world_bounds(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scenes():
    """(art_tpu scene, port tables) by name, built once."""
    return {n: (jax_build_scene(n, 16, 16), build_scene(n, 16, 16).tables)
            for n in ("bouncing_spheres", "final_scene", "three_spheres")}


@pytest.mark.parametrize("name", ["bouncing_spheres", "final_scene", "three_spheres"])
def test_scene_bvh_tables_match_art_tpu(scenes, name):
    js, t = scenes[name]
    jt = js.tables
    assert t.n_sph_bvh_nodes == jt.n_sph_bvh_nodes == 2 * t.n_spheres - 1
    np.testing.assert_array_equal(t.sph_bvh.numpy(), np.asarray(jt.sph_bvh))
    carried = tables_from_numpy(*_jax_arrays(js))[0]
    np.testing.assert_array_equal(carried.sph_bvh.numpy(), t.sph_bvh.numpy())
    assert carried.n_sph_bvh_nodes == t.n_sph_bvh_nodes


def test_no_bvh_below_two_spheres():
    t = build_scene("quads", 16, 16).tables
    assert t.n_spheres < 2 and t.sph_bvh is None and t.n_sph_bvh_nodes == 0


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


_SPAN = {"bouncing_spheres": (-30.0, 30.0), "final_scene": (-500.0, 900.0)}


def _port(o, d, tm):
    return (tuple(torch.from_numpy(x.copy()) for x in o),
            tuple(torch.from_numpy(x.copy()) for x in d), torch.from_numpy(tm.copy()))


def test_traverse_matches_art_tpu_on_boxes():
    """The generic descent over 300 random boxes as primitives (a
    primitive's t: its own slab entry), the same test in each framework."""
    lo, hi = _boxes(9, 300, ties=True)
    nodes = bvh.pack_bvh(bvh.build_bvh(lo, hi))
    o, d, _ = _rays(8, (-10, -10, -10, 12, 12, 12), 0.5, (-15.0, 15.0))
    o, d = o.T.copy(), d.T.copy()

    def prim_t(xp, lo_, hi_, o_, inv):
        def fn(idx, active):
            ta, tb = (lo_[idx] - o_) * inv, (hi_[idx] - o_) * inv
            t0 = xp.minimum(ta, tb).max(-1) if xp is jnp else torch.minimum(ta, tb).amax(-1)
            t1 = xp.maximum(ta, tb).min(-1) if xp is jnp else torch.maximum(ta, tb).amin(-1)
            return xp.where(active & (t0 < t1) & (t0 > T_MIN), t0, BIG)
        return fn

    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.where(d >= 0, 1e-12, -1e-12), d)
    inv = inv.astype(np.float32)
    jt, jp = jbvh.traverse_closest_packed(
        jnp.asarray(nodes), len(nodes), prim_t(jnp, jnp.asarray(lo), jnp.asarray(hi),
                                               jnp.asarray(o), jnp.asarray(inv)),
        jnp.asarray(o), jnp.asarray(d), T_MIN, t_max=BIG)
    to = {k: torch.from_numpy(v) for k, v in dict(lo=lo, hi=hi, o=o, inv=inv, d=d).items()}
    stats = {}
    pt, pp = bvh.traverse_closest_packed(
        torch.from_numpy(nodes), len(nodes), prim_t(torch, to["lo"], to["hi"], to["o"],
                                                    to["inv"]), to["o"], to["d"], T_MIN,
        t_max=BIG, stats=stats)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert int((pp >= 0).sum()) > R // 4 and stats["steps"] % bvh.CHECK_EVERY == 0


def _ties(rows, o, d, tm, t):
    """(R,) bool: lanes whose t is reached exactly by two or more spheres."""
    ts = []
    for k in range(rows.shape[0]):
        ts.append(sphere_candidates_p(rows[k:k + 1], o, d, tm, T_MIN)[0])
    return ((torch.stack(ts) == t) & (t < BIG)).sum(dim=0) >= 2


@pytest.mark.parametrize("name", ["bouncing_spheres", "final_scene"])
def test_bvh_candidates_match_art_tpu(scenes, name):
    """``bvh_sphere_candidates_p`` against art_tpu's two forms and against
    the port's full-table candidate pass (``sphere_candidates_p``, K2's
    twin)."""
    js, t = scenes[name]
    ties_seen, apart = 0, []
    for n, share in enumerate((0.0, 0.5)):
        o, d, tm = _rays(60 + n, t.sph_cl_meta[2], share, _SPAN[name])
        J = tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)), jnp.asarray(tm)
        jt_, ji = map(np.asarray, jax_bvh_candidates(js.tables, *J, T_MIN))
        jk2 = np.asarray(jax_candidates(js.tables, *J, T_MIN)[0])
        rays = _port(o, d, tm)
        stats = {}
        pt, pi = bvh_sphere_candidates_p(t, *rays, T_MIN, stats=stats)
        np.testing.assert_array_equal(pt.numpy(), jk2)
        hit = pt.numpy() < BIG

        def within(a, b):
            return ((a < BIG) == (b < BIG)) & ((a >= BIG) | np.isclose(a, b, rtol=1e-5,
                                                                       atol=5e-5))

        agree = within(jt_, jk2)  # art_tpu's descent and its jnp K2
        assert not (agree & ~within(pt.numpy(), jt_)).any()
        apart.append(int((~agree).sum()))
        full_t, full_i = sphere_candidates_p(t.sph_rows, *rays, T_MIN)
        # t bit for bit on every lane: no grazing ray lost a leaf to the
        # boxes' rounding (none on these rays)
        assert torch.equal(pt, full_t), int((pt != full_t).sum())
        differ = (pi != full_i) & (pt < BIG)
        jdiffer = (pi.numpy() != ji) & hit & agree
        if bool(differ.any()) or jdiffer.any():
            tied = _ties(t.sph_rows, *rays, pt)
            assert not bool((differ & ~tied).any())
            assert not (jdiffer & ~tied.numpy()).any()
            ties_seen += int(tied.sum())
        assert int(hit.sum()) > (R // 20 if share else 0)
        assert 0 < stats["steps"] < t.n_sph_bvh_nodes
    assert ties_seen == 0  # counted: no exact tie on these rays
    assert max(apart) <= 16, apart  # measured: 4 to 11


def test_check_every_changes_nothing(scenes, monkeypatch):
    """The exit test every step (as art_tpu's while_loop) gives the result
    of the test every CHECK_EVERY steps, in fewer steps."""
    _, t = scenes["bouncing_spheres"]
    rays = _port(*_rays(70, t.sph_cl_meta[2], 0.5, _SPAN["bouncing_spheres"]))
    coarse = {}
    want = bvh_sphere_candidates_p(t, *rays, T_MIN, stats=coarse)
    monkeypatch.setattr(bvh, "CHECK_EVERY", 1)
    fine = {}
    got = bvh_sphere_candidates_p(t, *rays, T_MIN, stats=fine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fine["steps"] <= coarse["steps"] < fine["steps"] + 16
