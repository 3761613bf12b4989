"""The route switches, read once from the environment.

``art_tpu`` reads its route switches once, at import
(``art_tpu/ops/intersect.py:112-183``, ``ops/compact_sphere.py:52-60``,
``ops/pallas_kernels.py:1084``, ``render/integrator.py:96``,
``scene/builder.py:800-804``); the port reads the same names once into
one frozen record, ``ROUTES``, which ``ops/intersect.closest_surface_p``
and ``render/integrator`` read at call time.  Two names shape tables, not
routes, and are read by the scene layer: K16's bin count
``ART_TPU_SPH_BINS`` (``scene/cull.py``) and ``ART_TPU_MXU_FORCE``, which
makes K14's tables past the builder's coordinate-scale gate
(``scene/builder.py``).  A switch is on
when its variable is set to a non-empty value, as in ``art_tpu``.

=========================  ==================================================
``ART_TPU_CLUSTER``        K15: spheres and boxes in BVH-leaf clusters of 64
                           (spheres through K17's ``csrc/sphere_cellbin.cu``
                           with no head, ``csrc/box_cluster.cu``) where the
                           builder made them; the box clusters
                           before the grid kernels K9 / K10, the sphere
                           clusters before every sphere route below
``ART_TPU_BVH``            the per-ray BVH descent over the spheres
                           (``ops/intersect.bvh_sphere_candidates_p``, plain
                           PyTorch on every device, as in ``art_tpu``); before
                           every other sphere route
``ART_TPU_COMPACT_SPH``    the split sphere pass (``ops/compact_sphere.py``);
                           on by default in ``art_tpu``, opt-in here: on the
                           H100 it lost to the full-table K2 on every
                           measurement (PERF.md §6)
``ART_TPU_OCC_GATE``       the occlusion gate on the split's needy set
``ART_TPU_SPH_SKIP``       K16 (skip bins): standalone, and as the split's
                           dense fallback
``ART_TPU_COMPACT_SKIP``   with ``ART_TPU_SPH_SKIP``: K16 as the split's
                           tail-only call on the compacted lanes
``ART_TPU_SPH_CELLBIN``    K17 (cell bins) standalone; before the split
``ART_TPU_COMPACT_CELLBIN`` K17 as the split's dense fallback
``ART_TPU_MXU_SPHERES``    K14: the bilinear-feature sphere kernel
                           (``csrc/sphere_mxu.cu``) where the builder's scale
                           gate made its tables; after the clusters, before
                           K13 and the routes below
``ART_TPU_SPH_STATIC``     K13: every sphere baked into a per-scene kernel
                           (``csrc/sphere_static.cu``, ``ops/_build.py``) for
                           scenes of at most 2048 spheres; before K17
``ART_TPU_SPH_FORCE_BRANCH`` ``dense``: the split runs its dense fallback
                           (measurement only); ``compact`` is the port's
                           only branch anyway
``ART_TPU_MXU_TAIL``       in the split's dense branch: K2 over the head and
                           K14 over the recentered tail features, before
                           ``ART_TPU_COMPACT_CELLBIN``
``ART_TPU_SEAM_FLUSH``     the seam route of the integrator
                           (``render/integrator.py seam_step``): K12 flushes
                           the dead slots and refills them, the shading is
                           plain PyTorch, and the short path is off
=========================  ==================================================

``using(**changes)`` swaps the record within one process (tests and
``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Routes:
    cluster: bool = False
    bvh: bool = False
    compact_sph: bool = False
    occ_gate: bool = False
    sph_skip: bool = False
    compact_skip: bool = False
    sph_cellbin: bool = False
    compact_cellbin: bool = False
    force_branch: str = ""
    sph_static: bool = False
    mxu_spheres: bool = False
    mxu_tail: bool = False
    seam_flush: bool = False


def from_environ(env=os.environ) -> Routes:
    def on(name: str) -> bool:
        return bool(env.get(f"ART_TPU_{name}"))

    return Routes(
        cluster=on("CLUSTER"),
        bvh=on("BVH"),
        compact_sph=on("COMPACT_SPH"),
        occ_gate=on("OCC_GATE"),
        sph_skip=on("SPH_SKIP"),
        compact_skip=on("COMPACT_SKIP"),
        sph_cellbin=on("SPH_CELLBIN"),
        compact_cellbin=on("COMPACT_CELLBIN"),
        force_branch=env.get("ART_TPU_SPH_FORCE_BRANCH", ""),
        sph_static=on("SPH_STATIC"),
        mxu_spheres=on("MXU_SPHERES"),
        mxu_tail=on("MXU_TAIL"),
        seam_flush=on("SEAM_FLUSH"),
    )


ROUTES = from_environ()


@contextlib.contextmanager
def using(**changes):
    """``ROUTES`` with ``changes`` applied for the duration of the block."""
    global ROUTES
    saved = ROUTES
    ROUTES = dataclasses.replace(saved, **changes)
    try:
        yield ROUTES
    finally:
        ROUTES = saved
