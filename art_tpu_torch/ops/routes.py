"""The intersection-route switches, read once from the environment.

``art_tpu`` reads its route switches once, at import
(``art_tpu/ops/intersect.py:112-183``, ``ops/compact_sphere.py:52-60``,
``ops/pallas_kernels.py:1084``); the port reads the same names once into
one frozen record, ``ROUTES``, which ``ops/intersect.closest_surface_p``
reads at call time (K16's bin count, ``ART_TPU_SPH_BINS``, is a table
shape and is read by ``scene/cull.py``).  A switch is on
when its variable is set to a non-empty value, as in ``art_tpu``.

=========================  ==================================================
``ART_TPU_CLUSTER``        K15: spheres and boxes in BVH-leaf clusters of 64
                           (``csrc/sphere_cluster.cu``, ``csrc/box_cluster.cu``)
                           where the builder made them; the box clusters
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
``ART_TPU_SPH_FORCE_BRANCH`` ``dense``: the split runs its dense fallback
                           (measurement only); ``compact`` is the port's
                           only branch anyway
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
