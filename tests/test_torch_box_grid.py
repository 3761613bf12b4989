"""The box grid (M12) against art_tpu: ``_detect_box_grid``'s fields and the
plain twins of K10 (``box_grid_hit_attrs``) and K9
(``box_grid_cells_hit_attrs``) against art_tpu's Pallas kernels in
interpret mode, at R = 8192 rays from a numpy seed.

Fields: ``box_grid``, the lattice, the uniform material and the K9 cell
groups are equal to art_tpu's for final_scene (20x20, one material), for
the 8x8 two-material field of ``tests/test_pallas_kernels.py:439-448``,
and both packages refuse a field with one rotated box or one box off the
lattice.

Kernels: the hit mask is equal.  t gets rtol 2e-5 and atol 1e-3, and
the full attributes (material, normal, u, v) must agree on >= 99% of the
hits — art_tpu's own bar between its two grid kernels
(``test_pallas_kernels.py:474-485``), for the same reason: the interpret
kernel is one fused XLA program whose mul+add pairs (``ex0 + ix * sxv``)
round otherwise than the port's, which rounds every product first (as its
CUDA kernel, built with ``-fmad=false``).  That moves t by about an ulp of
the slab terms (measured: up to 1e-4 relative for a short hit on a far
cell), and on a ray along a shared cell edge or a box's own edge an exact
tie may then go to another cell (another material on the two-material
field) or face.  K9 is held on the 8x8 field only: 400 interpret-mode
cells trace for minutes (``test_pallas_kernels.py:418-421``).  Against the
brute slab test (K6's twin over the same boxes) the grid twins agree to
the same bars."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.models import build_scene as jax_build_scene
from art_tpu.ops import pallas_kernels as pk
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu_torch.core.vecmath import BIG
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R = 8192
GRID_META = ("box_grid_kx", "box_grid_kz", "box_grid_x0", "box_grid_z0", "box_grid_w",
             "box_grid_y0", "box_grid_mat", "box_grid_cells")


def _field(B, M, O, variant="ok", n=8):
    """An n x n box field of 10-wide cells, 5 heights and two materials
    (``test_pallas_kernels.py:439-448``); ``variant`` "rotated" turns one
    box by 90 degrees, "off_lattice" moves one box by a quarter cell."""
    m1, m2 = M.Lambertian((0.5, 0.5, 0.5)), M.Metal((0.8, 0.8, 0.8), 0.1)
    b = B.SceneBuilder()
    for ix in range(n):
        for iz in range(n):
            h = 1.0 + ((ix * 13 + iz * 37) % 5)
            x0 = ix * 10.0 + (2.5 if variant == "off_lattice" and ix == iz == 3 else 0.0)
            box = O.Box((x0, 0.0, iz * 10.0), (x0 + 10.0, h, iz * 10.0 + 10.0),
                        m1 if (ix + iz) % 2 else m2)
            if variant == "rotated" and ix == iz == 5:
                box = O.RotateY(box, 90.0)
            b.add(box)
    b.set_camera(lookfrom=(40, 30, -40), lookat=(40, 0, 40), vup=(0, 1, 0),
                 vfov_degrees=60.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.compile()


def _scenes(name):
    if name == "final_scene":
        return jax_build_scene(name, 16, 16), build_scene(name, 16, 16)
    variant = name.split("_", 1)[1]
    return _field(jax_builder, JM, JO, variant), _field(port_builder, PM, PO, variant)


def _rays(seed, center, span):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-span, span, (3, R)) + np.asarray(center)[:, None]).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (3, R)).astype(np.float32)
    return o, d


# ray origins filling each field: final_scene's spans x, z in [-1000, 1000]
_SPAN = {"final_scene": ((0.0, 60.0, 0.0), 1100.0), "field_ok": ((40.0, 10.0, 40.0), 80.0)}


def _port(o, d):
    return tuple(torch.from_numpy(x.copy()) for x in o), tuple(torch.from_numpy(x.copy())
                                                              for x in d)


def _jax(o, d):
    return tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d))


def _kw(t):
    return dict(kx=t.box_grid_kx, kz=t.box_grid_kz, x0=t.box_grid_x0, z0=t.box_grid_z0,
                w=t.box_grid_w, y0=t.box_grid_y0)


def _compare(got, want):
    """(t, normal, u, v, mat) of the port (tensors) against a reference."""
    t, n, u, v, m = (x.numpy() if isinstance(x, torch.Tensor) else x for x in got)
    n = [c.numpy() for c in n]
    wt, wn, wu, wv, wm = (np.asarray(x) if not isinstance(x, tuple) else x for x in want)
    hit = wt < BIG
    assert hit.sum() > R // 20 and (~hit).any()
    np.testing.assert_array_equal(t < BIG, hit)
    np.testing.assert_allclose(t[hit], wt[hit], rtol=2e-5, atol=1e-3)
    agree = m[hit] == np.asarray(wm)[hit]
    for c in range(3):
        agree &= np.isclose(n[c][hit], np.asarray(wn[c])[hit], rtol=1e-4, atol=2e-4)
    agree &= np.isclose(u[hit], np.asarray(wu)[hit], atol=1e-3)
    agree &= np.isclose(v[hit], np.asarray(wv)[hit], atol=1e-3)
    assert agree.mean() > 0.99, agree.mean()
    # a miss carries closest_surface_p's blend defaults
    assert (n[0][~hit] == 1).all() and (n[1][~hit] == 0).all() and (m[~hit] == 0).all()


@pytest.mark.parametrize("name", ["final_scene", "field_ok", "field_rotated",
                                  "field_off_lattice"])
def test_detect_box_grid_matches_art_tpu(name):
    jscene, scene = _scenes(name)
    jt, t = jscene.tables, scene.tables
    for k in GRID_META:
        assert getattr(t, k) == getattr(jt, k), k
    np.testing.assert_array_equal(t.box_grid.numpy(), np.asarray(jt.box_grid))
    if name in ("field_rotated", "field_off_lattice"):
        assert t.box_grid_kx == 0 and t.box_grid_cell_rows is None
        return
    assert t.box_grid_kx == t.box_grid_kz == (20 if name == "final_scene" else 8)
    assert (t.box_grid_mat >= 0.0) == (name == "final_scene")
    # K10's table is box_grid as (kx, 2 kz); K9's rows list the cells in order
    np.testing.assert_array_equal(t.box_grid_rows.numpy(),
                                  np.asarray(jt.box_grid).reshape(t.box_grid_kx, -1))
    rows = t.box_grid_cell_rows.numpy()
    want = [(ix, iz, h, m) for h, m, g in jt.box_grid_cells for ix, iz in g]
    np.testing.assert_array_equal(rows, np.asarray(want, np.float32))
    assert rows.shape == (t.n_boxes, 4)


@pytest.mark.parametrize("name", ["final_scene", "field_ok"])
def test_plain_k10_matches_pallas_interpret(name):
    jscene, scene = _scenes(name)
    jt = jscene.tables
    o, d = _rays(1, *_SPAN[name])
    want = pk.box_grid_hit_attrs(jt.box_grid, *_jax(o, d), uniform_mat=jt.box_grid_mat,
                                 interpret=True, **_kw(jt))
    _compare(K.box_grid_hit_attrs_plain(scene.tables, *_port(o, d)), want)


def test_plain_k9_matches_pallas_interpret():
    jscene, scene = _scenes("field_ok")
    jt = jscene.tables
    o, d = _rays(9, *_SPAN["field_ok"])
    want = pk.box_grid_static_hit_attrs(*_jax(o, d), cells=jt.box_grid_cells,
                                        uniform_mat=jt.box_grid_mat, interpret=True,
                                        **_kw(jt))
    _compare(K.box_grid_cells_hit_attrs_plain(scene.tables, *_port(o, d)), want)


@pytest.mark.parametrize("name", ["final_scene", "field_ok"])
def test_grid_twins_match_the_brute_box_twin(name):
    """K9 and K10's twins against K6's over the same boxes (the grid off):
    the same hits, t and attributes to the bars above; K9 and K10 agree
    on t bit for bit (the same candidate arithmetic, another cell order)."""
    _, scene = _scenes(name)
    brute = dataclasses.replace(scene.tables, box_grid_kx=0)
    o, d = _port(*_rays(4, *_SPAN[name]))
    want = K.box_hit_attrs_plain(brute, o, d)
    want = (want[0].numpy(), tuple(c.numpy() for c in want[1]), want[2].numpy(),
            want[3].numpy(), want[4].numpy())
    k10 = K.box_grid_hit_attrs_plain(scene.tables, o, d)
    k9 = K.box_grid_cells_hit_attrs_plain(scene.tables, o, d)
    for got in (k10, k9):
        _compare(got, want)
    assert torch.equal(k9[0], k10[0])


def test_grid_routes_and_cpu_wrappers():
    """closest_surface_p takes K9 where the builder set box_grid_cells, K10
    where it did not (here: the cells table dropped, as for a lattice of
    more than 1024 boxes), K6 without a grid — all three agree on the hits;
    on CPU tensors each wrapper is its twin."""
    _, scene = _scenes("field_ok")
    t9 = scene.tables
    t10 = dataclasses.replace(t9, box_grid_cells=None, box_grid_cell_rows=None)
    t6 = dataclasses.replace(t9, box_grid_kx=0)
    o, d = _port(*_rays(5, *_SPAN["field_ok"]))
    tm = torch.zeros(R)
    recs = [closest_surface_p(t, o, d, tm, 1e-3) for t in (t9, t10, t6)]
    for rec in recs[1:]:
        assert torch.equal(rec.hit, recs[0].hit)
        torch.testing.assert_close(rec.t, recs[0].t, rtol=2e-5, atol=1e-3)
    k9, k10 = K.box_grid_cells_hit_attrs_plain(t9, o, d), K.box_grid_hit_attrs_plain(t9, o, d)
    assert torch.equal(recs[0].t, k9[0]) and torch.equal(recs[1].t, k10[0])
    for kernel, plain in ((K.box_grid_cells_hit_attrs, K.box_grid_cells_hit_attrs_plain),
                          (K.box_grid_hit_attrs, K.box_grid_hit_attrs_plain)):
        a, b = kernel(t9, o, d), plain(t9, o, d)
        assert torch.equal(a[0], b[0]) and torch.equal(a[-1], b[-1])
        # t_min reaches the twin: every hit lies beyond it
        t = kernel(t9, o, d, 5.0)[0]
        assert bool((t[t < BIG] > 5.0).all()) and bool((t != a[0]).any())
