"""The roofline's least time counts the work the rays need, not a kernel's
loop: on one pool the default sphere route (the full-table K2) and the
opt-in cell-bin route (K17, ``ART_TPU_SPH_CELLBIN``) read the same count."""

import torch

from portbench import judge, roofline
from portbench.cells import load_cell
from portbench.trace import REFILL, Stretch

SPANS = ["art_tpu_torch.render.integrator:closest_surface_p", REFILL]


def _counts_on_one_pool(**route):
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops import routes
    from art_tpu_torch.render import integrator

    scene = build_scene("final_scene", 16, 16)
    tables, dev = scene.tables, torch.device("cpu")
    R, P = 1024, 256
    scal = rk.RefillScal(64, P, 0, P, 16, 16)
    pool = rk.new_pool(R, dev)
    q = torch.zeros(2, dtype=torch.int64)
    hist = torch.zeros(16, dtype=torch.int64)
    fb = torch.zeros((P, 3))
    lost = torch.zeros(1, dtype=torch.int32)
    kw = dict(key=(5, 0, 0), ncols=integrator.n_uniform_cols(tables), max_depth=50,
              gradient=scene.gradient_bg)
    stretch = Stretch(SPANS, start=2, iters=3)
    stretch.install()
    try:
        with routes.using(**route):
            for it in range(6):
                integrator.staged_step(pool, scene.camera, q, it % 2, hist, it, scal, tables,
                                       scene.background, fb, lost, **kw)
    finally:
        stretch.uninstall()
    stretch.stop()
    st = stretch.summary()
    counts = judge.reference_scene(load_cell("final_scene.job"),
                                   {"nx": 16, "ny": 16}).counts()
    return (st["iterations"], st["live"], st["started"],
            roofline.intersect_s(st["iterations"], st["live"], counts),
            roofline.refill_s(st["iterations"], R, st["started"]),
            roofline.shade_s(st["iterations"], st["live"], counts))


def test_same_count_for_default_and_cellbin_routes():
    default = _counts_on_one_pool()
    cellbin = _counts_on_one_pool(sph_cellbin=True)
    assert default[0] == 3 and default[1] > 0 and default[2] > 0
    assert default == cellbin


def test_bytes_bound_every_share():
    counts = {"spheres": 1006, "quads": 1, "boxes": 400, "materials": 12}
    live = 131072
    by_bytes = (live * roofline.INTERSECT_RAY_BYTES + roofline.geometry_bytes(counts)) \
        / roofline.PEAK_BYTES_PER_S
    assert roofline.intersect_s(1, live, counts) == by_bytes
