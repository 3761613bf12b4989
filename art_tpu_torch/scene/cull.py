"""The culling tables: K16's skip bins, K17's cell bins, K15's BVH-leaf
clusters of spheres and boxes, and the sphere BVH of the per-ray descent.

Ports of ``art_tpu/ops/pallas_kernels.py:pack_skip_spheres`` (``:1089``),
``pack_cellbin_spheres`` (``:1407``) and ``pack_tail2d_spheres``
(``:1521``), with the gates of ``art_tpu``'s ``finish``
(``scene/builder.py:689-737``), in the port's row format
(``tables.sphere_rows``: ``[c(3) v(3) r mat r2 0]``):

* a tail scene (a tail of at least ``SKIP_MIN_TAIL`` rows with its box)
  gets the skip bins — the tail sorted (stably) along one axis and cut into
  up to 16 equal-count bins — and the tail lattice, the tail cut into a
  3x3x3 lattice of cells by each sphere's box centre;
* another scene of at least ``CELLBIN_MIN`` spheres gets the whole-set
  lattice: a 4x4 lattice over the two largest extents of the swept boxes
  of the spheres within 8x the median extent, each sphere in the cell of
  its box centre unless its box spans more than 1.5 cells along either
  lattice axis (the r = 1000 ground sphere), which leaves it in the head.

Each table is a head then its segments, every segment a contiguous row
range: ``rows`` (N, 10) float32 and static metadata ``(n_head, segments,
box)``, each segment ``(row0, row1, box6)`` with ``box6 = (x0, y0, z0, x1,
y1, z1)`` bounding its members' (swept) spheres inflated by ``1e-3 + 1e-6
max|coord|`` in float64, as ``art_tpu``'s packers bound them; ``box`` is
the skip bins' whole-tail box (``sph_tail_box``) or the lattice's union
box.  The kernels read the metadata as a (1 + segments, 8) float32 device
table ``seg``: row 0 ``(0, n_head, box)``, then ``(row0, row1, box6)`` per
segment.

``art_tpu`` pads each segment with inert rows to its unroll multiple (a
TPU loop device): dropped, so the row ranges are exact.  Its head and each
of its cells hold the moving rows first; here the head and the cells keep
scene order (a row carries its velocity), and the bins keep ``art_tpu``'s
order (the tail in scene order, sorted stably along the bin axis).

K15's tables (``cluster_tables``) port ``art_tpu``'s ``cluster_spheres``
(``pallas_kernels.py:934``) and ``cluster_boxes`` (``:2642``) with the gates
of ``finish`` (``scene/builder.py:812-824``: at least 32 spheres, at least
32 boxes): the kernel rows (``sphere_rows``, ``box_rows``) in BVH-leaf order
(``ops/bvh.py cluster_primitives``) cut into clusters of 64, each cluster a
segment of the layout above with no head and its box rounded to float32 as
``art_tpu``'s ``sph_cl_box`` / ``box_cl_box`` (a sphere's swept over t in
[0, 1], a box's over its 8 rotated corners); the last cluster is shorter
where ``art_tpu`` pads it with inert rows, and row 0 of ``seg`` holds the
clusters' union box.  ``bvh_table`` is the packed sphere BVH of ``finish``
(``:825-848``, at least 2 spheres; velocities zeroed unless a sphere moves).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from art_tpu_torch.ops import bvh

SKIP_MIN_TAIL = 512  # pallas_kernels.py:1084
SPH_BINS = int(os.environ.get("ART_TPU_SPH_BINS", "16"))  # pallas_kernels.py:1086
CELLBIN_MIN = 128  # pallas_kernels.py:1404
CELLBIN_GRID = 4  # pallas_kernels.py:1407 _CELLBIN_GRID
TAIL_LATTICE = 3  # pack_tail2d_spheres' g
SPHERE_CLUSTER = 64  # pallas_kernels.py:775
BOX_CLUSTER = 64  # pallas_kernels.py:2479
CLUSTER_MIN = 32  # finish's gate for either kind (builder.py:814, :820)


def _box(lo: np.ndarray, hi: np.ndarray) -> tuple:
    """The inflated box of per-sphere float64 bounds (n, 3)."""
    lo3, hi3 = lo.min(axis=0), hi.max(axis=0)
    eps = 1e-3 + 1e-6 * float(np.max(np.abs(np.concatenate([lo3, hi3]))))
    return tuple(float(v) for v in np.concatenate([lo3 - eps, hi3 + eps]))


def _bounds(rows: np.ndarray, swept: bool):
    """Per-sphere float64 (lo, hi): centre ± |r|, over the centre at t = 0
    and t = 1 when ``swept`` (src/sphere.cuh:33-37)."""
    c0 = rows[:, 0:3].astype(np.float64)
    r = np.abs(rows[:, 6:7].astype(np.float64))
    if not swept:
        return c0 - r, c0 + r
    c1 = c0 + rows[:, 3:6].astype(np.float64)
    return np.minimum(c0, c1) - r, np.maximum(c0, c1) + r


def _layout(head: np.ndarray, groups, bounds_of) -> tuple:
    """(rows, segments) of a head then the non-empty row groups, each
    group's box from ``bounds_of(group index)``."""
    segs, row0 = [], len(head)
    for k, rows in enumerate(groups):
        if len(rows):
            segs.append((row0, row0 + len(rows), _box(*bounds_of(k))))
            row0 += len(rows)
    table = np.concatenate([head, *groups], axis=0).astype(np.float32)
    return table, tuple(segs)


def pack_skip(head: np.ndarray, tail: np.ndarray, tail_box: tuple, n_bins: int):
    """K16's table: the head, then ``tail`` sorted stably along the bin axis
    (``finish``: y when the tail box's y extent is at least a quarter of its
    largest, else the largest) in ``max(1, min(n_bins, n_tail // 32))``
    equal-count bins (``np.linspace`` edges, rounded).  Returns (rows,
    (n_head, bins, tail_box))."""
    ext = [tail_box[3] - tail_box[0], tail_box[4] - tail_box[1], tail_box[5] - tail_box[2]]
    axis = 1 if ext[1] >= 0.25 * max(ext) else int(np.argmax(ext))
    nbins = max(1, min(n_bins, len(tail) // 32))
    tail = tail[np.argsort(tail[:, axis], kind="stable")]
    edges = np.linspace(0, len(tail), nbins + 1).round().astype(int)
    groups = [tail[edges[i]:edges[i + 1]] for i in range(nbins)]
    table, bins = _layout(head, groups, lambda k: _bounds(groups[k], swept=False))
    return table, (len(head), bins, tuple(tail_box))


def pack_tail_lattice(head: np.ndarray, tail: np.ndarray, g: int = TAIL_LATTICE):
    """K17's table over a tail: the head, then the tail's g x g x g lattice
    cells in (ix, iy, iz) row-major order, each sphere in the cell of its
    box centre.  Returns (rows, (n_head, cells, union_box))."""
    lo, hi = _bounds(tail, swept=False)
    lo3 = lo.min(axis=0)
    cell3 = np.maximum((hi.max(axis=0) - lo3) / g, 1e-30)
    idx3 = np.clip(((0.5 * (lo + hi) - lo3) / cell3).astype(int), 0, g - 1)
    cell_of = (idx3[:, 0] * g + idx3[:, 1]) * g + idx3[:, 2]
    sel = [cell_of == ci for ci in range(g ** 3)]
    table, cells = _layout(head, [tail[s] for s in sel], lambda k: (lo[sel[k]], hi[sel[k]]))
    return table, (len(head), cells, _box(lo, hi))


def pack_cellbin(rows: np.ndarray, gx: int = CELLBIN_GRID, gz: int = CELLBIN_GRID):
    """K17's whole-set table (rows, (n_head, cells, union_box)), or None
    when fewer than ``CELLBIN_MIN`` spheres are binnable (module
    docstring)."""
    rows = rows[rows[:, 8] > 0.0]  # art_tpu's real rows: r2 > 0
    if len(rows) < CELLBIN_MIN:
        return None
    lo, hi = _bounds(rows, swept=True)
    ext = hi - lo
    med = np.median(ext, axis=0)
    small = np.all(ext <= 8.0 * med + 1e-12, axis=1)
    if int(small.sum()) < CELLBIN_MIN:
        return None
    span = hi[small].max(axis=0) - lo[small].min(axis=0)
    ax0, ax1 = sorted(int(a) for a in np.argsort(span)[-2:])  # the two largest extents
    lo0, hi0 = lo[small, ax0].min(), hi[small, ax0].max()
    lo1, hi1 = lo[small, ax1].min(), hi[small, ax1].max()
    cell0, cell1 = (hi0 - lo0) / gx, (hi1 - lo1) / gz
    binnable = small & (ext[:, ax0] <= 1.5 * cell0) & (ext[:, ax1] <= 1.5 * cell1)
    if int(binnable.sum()) < CELLBIN_MIN:
        return None
    blo, bhi = lo[binnable], hi[binnable]
    mid = 0.5 * (blo + bhi)
    i0 = np.clip(((mid[:, ax0] - lo0) / max(cell0, 1e-30)).astype(int), 0, gx - 1)
    i1 = np.clip(((mid[:, ax1] - lo1) / max(cell1, 1e-30)).astype(int), 0, gz - 1)
    cell_of = i0 * gz + i1
    binned = rows[binnable]
    sel = [cell_of == ci for ci in range(gx * gz)]
    table, cells = _layout(rows[~binnable], [binned[s] for s in sel],
                           lambda k: (blo[sel[k]], bhi[sel[k]]))
    return table, (int((~binnable).sum()), cells, _box(blo, bhi))


def seg_table(meta) -> torch.Tensor:
    """The (1 + segments, 8) float32 device form of ``(n_head, segments,
    box)``."""
    n_head, segs, box = meta
    return torch.tensor([(0, n_head, *box)] + [(r0, r1, *b) for r0, r1, b in segs],
                        dtype=torch.float32)


def cull_tables(head: torch.Tensor, tail: torch.Tensor, sph_rows: torch.Tensor,
                tail_box: tuple, n_bins: int = SPH_BINS) -> dict:
    """The culling fields of ``SceneTables`` by ``finish``'s gates: a tail
    scene's skip bins and tail lattice, another scene's whole-set lattice
    (module docstring); None where a table does not apply."""
    out = dict(sph_skip_rows=None, sph_skip_bins=None, sph_skip_seg=None,
               sph_cellbin_rows=None, sph_cellbin_meta=None, sph_cellbin_seg=None)
    if len(tail) >= SKIP_MIN_TAIL and tail_box:
        h, t = head.numpy(), tail.numpy()
        rows, bins = pack_skip(h, t, tail_box, n_bins)
        out.update(sph_skip_rows=torch.from_numpy(rows), sph_skip_bins=bins,
                   sph_skip_seg=seg_table(bins))
        cell = pack_tail_lattice(h, t)
    elif sph_rows.shape[0] >= CELLBIN_MIN:
        cell = pack_cellbin(sph_rows.numpy())
    else:
        cell = None
    if cell is not None:
        out.update(sph_cellbin_rows=torch.from_numpy(cell[0]), sph_cellbin_meta=cell[1],
                   sph_cellbin_seg=seg_table(cell[1]))
    return out


def _clusters(bmin, bmax, rows: np.ndarray, size: int):
    """(rows in BVH-leaf order, (0, clusters, union box)) of ``rows`` in
    clusters of ``size`` (module docstring)."""
    ordered, boxes, n_cl, _ = bvh.cluster_primitives(bmin, bmax, rows, size)
    n = len(rows)
    segs = tuple((c * size, min((c + 1) * size, n), tuple(float(v) for v in boxes[c, :6]))
                 for c in range(n_cl))
    union = tuple(float(v) for v in np.concatenate([boxes[:, :3].min(axis=0),
                                                    boxes[:, 3:6].max(axis=0)]))
    return ordered, (0, segs, union)


def cluster_tables(a: dict, n_s: int, n_b: int, sph_rows: torch.Tensor,
                   box_rows: torch.Tensor) -> dict:
    """K15's fields of ``SceneTables`` from ``art_tpu``-named float32 arrays
    ``a`` and the kernel rows (module docstring); None where a kind has
    fewer than ``CLUSTER_MIN`` primitives."""
    out = dict(sph_cl_rows=None, sph_cl_meta=None, sph_cl_seg=None, box_cl_rows=None,
               box_cl_meta=None, box_cl_seg=None)
    if n_s >= CLUSTER_MIN:
        lo, hi = bvh.sphere_world_bounds(a["sph_center"][:n_s], a["sph_vel"][:n_s],
                                         a["sph_radius"][:n_s])
        rows, meta = _clusters(lo, hi, sph_rows.numpy(), SPHERE_CLUSTER)
        out.update(sph_cl_rows=torch.from_numpy(rows), sph_cl_meta=meta,
                   sph_cl_seg=seg_table(meta))
    if n_b >= CLUSTER_MIN:
        lo, hi = bvh.box_world_bounds(*(a[k][:n_b] for k in (
            "box_min", "box_max", "box_cos", "box_sin", "box_off")))
        rows, meta = _clusters(lo, hi, box_rows.numpy(), BOX_CLUSTER)
        out.update(box_cl_rows=torch.from_numpy(rows), box_cl_meta=meta,
                   box_cl_seg=seg_table(meta))
    return out


def bvh_table(a: dict, n_s: int, has_moving: bool) -> torch.Tensor | None:
    """``sph_bvh`` (M, 8), the packed sphere BVH of the per-ray descent
    (module docstring); None below 2 spheres."""
    if n_s < 2:
        return None
    center = a["sph_center"][:n_s]
    vel = a["sph_vel"][:n_s] if has_moving else np.zeros_like(center)
    tree = bvh.build_bvh(*bvh.sphere_world_bounds(center, vel, a["sph_radius"][:n_s]))
    return torch.from_numpy(bvh.pack_bvh(tree))
