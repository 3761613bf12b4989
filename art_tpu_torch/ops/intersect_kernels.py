"""Intersection kernels and their plain twins.

* K2 ``sphere_hit_attrs`` (``csrc/sphere_hit.cu``), replacing
  ``art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_planar`` (its
  ``_sphere_kernel``): the closest hit with ``t > t_min`` over all spheres
  in scene order (moving centers at the ray's shutter time), its
  signed-radius normal ``(p - c) / r`` and its material id.
* K16 ``sphere_skip_hit_attrs`` (``csrc/sphere_skip.cu``), replacing
  ``sphere_skip_hit_attrs`` (``:1353``), and K17
  ``sphere_cellbin_hit_attrs`` (``csrc/sphere_cellbin.cu``), replacing
  ``sphere_cellbin_hit_attrs`` (``:1798``): K2's outputs over a head of rows
  and contiguous segments with boxes (``scene/cull.py``): K16's skip bins
  over a sphere tail, K17's lattice cells with an occlusion bound.  Their
  twins are K2's twin over the head and over each segment, masked per ray by
  the kernels' slab tests and merged with a strict ``<``.
* K15's sphere half ``sphere_cluster_hit_attrs``, replacing
  ``sphere_hit_attrs_clustered`` (``:896``): K17's kernel
  (``csrc/sphere_cellbin.cu``) with no head over the spheres in BVH-leaf
  clusters of 64 (``scene/cull.py``), a cluster scanned where its box can be
  met before the running best t, counted as its own launch
  (``sphere_cluster``); its twin is K17's (``culled_plain`` with the
  occlusion bound) over that table with no head.
* K15's box half ``box_cluster_hit_attrs`` (``csrc/box_cluster.cu``),
  replacing ``box_hit_attrs_clustered`` (``:2601``): K6's outputs over the
  boxes in BVH-leaf clusters of 64, a cluster scanned where ``art_tpu``'s
  bounded test of its box (``intersect.cluster_slab``) passes against the
  running best t; its twin is K6's twin over each cluster, masked by that
  test and merged with a strict ``<``, then the winner's attributes.
* K13 ``sphere_static_hit_attrs`` (``csrc/sphere_static.cu``, built per
  scene by ``_build.static_libraries``), replacing ``sphere_static_hit_attrs``
  (``:520``): K2's outputs over ``tables.sph_static_cells`` baked into the
  kernel, the moving rows, then the static rows but the tail, then the tail
  merged once (a tail row wins only on a strictly smaller t), in the direct
  or the expanded quadratic (``expand``; the route passes the builder's
  ``sph_expand``), with t_min = 1e-3 baked in.  Its twin walks the same
  cells in the same order, vectorized: a first-index min over the moving and
  main rows, another over the tail, and the strict merge.
* K14 ``sphere_mxu_hit_attrs`` (``csrc/sphere_mxu.cu``), replacing
  ``sphere_hit_attrs_mxu`` (``:730``): K2's outputs through the bilinear
  features (F, attrT) of ``scene/builder.sphere_mxu_features``, with the
  TPU kernel's 2 t_min margin, first-index argmin and one Newton step; its
  twin sums the same feature terms in the same order (no matmul).
* K5 ``quad_hit_attrs`` (``csrc/quad_hit.cu``), replacing
  ``quad_closest_hit_planar`` (``_quad_kernel``) together with the winner
  attributes ``art_tpu`` computes after it (``intersect.quad_attributes_p``):
  the closest quad's t, its ray-facing normal, (alpha, beta) and material.
* K6 ``box_hit_attrs`` (``csrc/box_hit.cu``), replacing
  ``box_hit_attrs_planar`` (``_box_kernel``): the closest oriented box's t,
  face normal, make_box (u, v) and material; its merge form
  ``box_hit_attrs_merge`` updates a running closest hit (the quads') in
  place where a box is strictly closer, the merge ``art_tpu`` makes in jnp
  after its kernel (``intersect.py:593-595, 726-740``).
* K10 ``box_grid_hit_attrs`` and K9 ``box_grid_cells_hit_attrs``
  (``csrc/box_grid.cu``), replacing ``box_grid_hit_attrs`` (``:2297``) and
  ``box_grid_static_hit_attrs`` (``:2435``): K6's outputs over a regular
  lattice of unrotated boxes on one floor (``scene/builder._detect_box_grid``),
  K10 in row-major order from the run-time table ``box_grid_rows``, over
  the cells each ray's slabs can meet (per ray an interval of columns and
  in each an interval of rows, exact on the twin's floats, so its result
  is the twin's over every cell), K9 over the non-empty cells in ``box_grid_cells``
  order (``box_grid_cell_rows``); the two pick different, equally close
  cells on an exact tie.  ``box_grid_skip_p`` is the predicate by which a
  K9 warp tests no cell (the tests hold it to the twin's misses), and
  ``box_grid_cells_form`` names K9's form for a lattice.

Each but K13 and K14 (which bake 1e-3, as the TPU kernels do) takes
``t_min`` as a run-time argument.  A miss gives ``t = BIG``,
normal ``(1, 0, 0)``, u = v = 0 (K5: alpha = beta = 0) and material 0 — the values
``closest_surface_p`` blends in for misses.  Each wrapper launches its
kernel for CUDA tensors and runs the plain twin for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN, p_ray_at, p_where, safe_dir, sqrt
from art_tpu_torch.ops import _build
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.intersect import (
    box_attributes_p,
    box_candidates_p,
    box_grid_attributes_p,
    box_attributes_rows,
    box_candidates_rows,
    box_grid_candidates_p,
    _closer,
    cluster_slab,
    grid_cells,
    miss_defaults,
    quad_attributes_p,
    quad_candidates_p,
    sphere_attributes_p,
    sphere_candidates_p,
    sphere_row_t_p,
    slab_interval,
)
from art_tpu_torch.scene.tables import SceneTables

NAME = "sphere_hit"
SKIP = "sphere_skip"  # K16
CELLBIN = "sphere_cellbin"  # K17
CLUSTER = "sphere_cluster"  # K15, spheres
STATIC = "sphere_static"  # K13
MXU = "sphere_mxu"  # K14
BOX_CLUSTER = "box_cluster"  # K15, boxes
QUAD = "quad_hit"
BOX = "box_hit"
BOX_MERGE = "box_hit_merge"  # K6's merge form
GRID = "box_grid"  # K10
GRID_CELLS = "box_grid_cells"  # K9
_RAY = ("ox", "oy", "oz", "dx", "dy", "dz")


def sphere_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN, *, rows=None,
                           n_live=None):
    """Plain PyTorch K2: the candidate pass plus the winner attributes over
    ``rows`` (default ``tables.sph_rows``); lanes at or past ``n_live`` miss."""
    rows = tables.sph_rows if rows is None else rows
    t, idx = sphere_candidates_p(rows, o, d, tm, t_min)
    if n_live is not None:
        lane = torch.arange(t.shape[0], dtype=torch.int32, device=t.device)
        t = torch.where(lane < n_live, t, BIG)
    if rows.shape[0] == 0:
        zero = torch.zeros_like(t)
        return t, (torch.ones_like(t), zero, zero), torch.zeros_like(idx)
    normal, mat = sphere_attributes_p(rows, o, d, tm, t, idx)
    normal, (mat,) = miss_defaults(t < BIG, normal, (mat,))
    return t, normal, mat


def sphere_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN, *, rows=None,
                     n_live=None):
    """K2 over ``rows`` (default ``tables.sph_rows``): the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors.  ``n_live``, a (1,) int32
    tensor on the rays' device or None, makes every lane at or past
    ``n_live[0]`` a miss without testing a sphere (the compacted tail pass)."""
    if o[0].device.type == "cpu":
        return sphere_hit_attrs_plain(tables, o, d, tm, t_min, rows=rows, n_live=n_live)
    dev = o[0].device
    ins = (*o, *d, tm)
    R = ins[0].shape[0]
    _build.check_planes(_RAY + ("tm",), ins, R, torch.float32, dev)
    rows = _build.check_table("sphere rows", tables.sph_rows if rows is None else rows,
                              10, dev)
    if n_live is not None:
        _build.check_planes(("n_live",), (n_live,), 1, torch.int32, dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    nx, ny, nz = (torch.empty_like(t) for _ in range(3))
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    ptrs = _build.pointers((*ins, t, nx, ny, nz, mat))
    rc = _build.library().art_sphere_hit(
        rows.data_ptr(), rows.shape[0], R, float(t_min),
        None if n_live is None else n_live.data_ptr(), ptrs, _build.stream_handle(dev))
    _build.check(rc, NAME)
    _build.launch(NAME)
    return t, (nx, ny, nz), mat


def culled_plain(rows, meta, o, d, tm, t_min, *, occlusion: bool, head: bool = True,
                 n_live=None):
    """The twin of K16 (``occlusion`` False) and K17 (True) over ``rows`` and
    ``meta`` = (n_head, segments, box): K2's twin over the head rows (none
    unless ``head``), then over each segment's rows, taken where the ray's
    slab test of the segment's box passes (with ``occlusion``, at t_near <=
    the running best t) and the segment's t is strictly closer; lanes at or
    past ``n_live`` miss (K16's ``csrc/sphere.cuh`` spread_hit by the least
    (t, row), K17's ``csrc/sphere_cellbin.cu``, also K15's spheres with no
    head, in the same order, lane by lane)."""
    n_head, segs, box = meta
    n_head = n_head if head else 0
    t, normal, mat = sphere_hit_attrs_plain(None, o, d, tm, t_min, rows=rows[:n_head],
                                            n_live=n_live)
    ok, t_near = slab_interval(box, o, d, t_min)
    live = torch.ones_like(ok) if n_live is None else torch.arange(
        t.shape[0], dtype=torch.int32, device=t.device) < n_live
    needy = ok & live
    if occlusion:
        needy = needy & (t_near <= t)
    for row0, row1, seg_box in segs:
        ok, t_near = slab_interval(seg_box, o, d, t_min)
        cross = needy & ok
        if occlusion:
            cross = cross & (t_near <= t)
        t_s, n_s, m_s = sphere_hit_attrs_plain(None, o, d, tm, t_min, rows=rows[row0:row1])
        better = cross & (t_s < t)
        t, normal, mat = (torch.where(better, t_s, t), p_where(better, n_s, normal),
                          torch.where(better, m_s, mat))
    return t, normal, mat


# K16's merge key (csrc/sphere.cuh order_key): order_bits(t) << 32 | row,
# unsigned 64-bit `<` being the lexicographic (t, row) order
KEY_ARRIVE = 1 << 32  # spread_hit's ticket sum at a tile's last arrival


def order_bits(t) -> np.ndarray:
    """float32 values -> uint32 that order as float ``<`` does (the two
    zeros one value; NaN has no place: no candidate is NaN)."""
    u = np.asarray(t, np.float32).copy()
    u[u == 0.0] = 0.0  # -0 -> +0
    u = u.view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def order_key(t, row) -> np.ndarray:
    """The uint64 keys of candidates ``t`` (float32) at table rows ``row``."""
    return (order_bits(t).astype(np.uint64) << np.uint64(32)) | np.asarray(
        row, np.uint64) & np.uint64(0xFFFFFFFF)


def key_t(key) -> np.ndarray:
    """The float32 t of keys (a zero decodes as +0)."""
    hi = (np.asarray(key, np.uint64) >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF), ~hi)
    return u.astype(np.uint32).view(np.float32)


MISS_KEY = int(order_key(np.float32(BIG), 0xFFFFFFFF))  # t = BIG, row 0xffffffff


SKIP_BINS = 4  # bins a block of K16's on a whole pool (csrc/sphere_skip.cu kBinsPool)
SKIP_BINS_LIVE = 1  # and on compacted lanes, with n_live (kBinsLive)


def spread_scan_p(rows, meta, o, d, tm, t_min, *, head: bool = True, n_live=None,
                  order=None, tile: int = _build.BLOCK, bins: int | None = None):
    """A model of K16's scan (``csrc/sphere.cuh`` spread_hit) on CPU
    tensors: the blocks (tile, group) of the tiles below ``n_live``, group
    0 the head and group g >= 1 the bins (g - 1) ``bins`` + 1 .. g ``bins``
    (by default the kernel's: ``SKIP_BINS_LIVE`` with ``n_live``, else
    ``SKIP_BINS``), take their work in ``order`` (a permutation of the
    block list, by default the list's order), each testing its segments'
    rows against its tile's lanes whose slab predicates admit them and
    keeping each lane's least ``order_key`` of a root.  A tile whose bins
    no lane crosses (W = 0) is written by its head block; otherwise a block
    with no testing lane takes no ticket, the head adds ``KEY_ARRIVE`` - W
    and each other block 1.  Returns ((t, normal, mat) from each winner's
    row, {tile: the block index that writes it: the head's, or the one
    whose ticket sum reached ``KEY_ARRIVE``})."""
    n_head, segs, box = meta
    n_head = n_head if head else 0
    bins = (SKIP_BINS if n_live is None else SKIP_BINS_LIVE) if bins is None else bins
    R = o[0].shape[0]
    n = R if n_live is None else min(int(n_live.reshape(-1)[0]), R)
    live = torch.arange(R) < n
    needy = slab_interval(box, o, d, t_min)[0] & live
    work = [(0, n_head, live & (n_head > 0))] + [
        (r0, r1, needy & slab_interval(b, o, d, t_min)[0]) for r0, r1, b in segs]
    groups = [[0]] + [list(range(g, min(len(segs), g + bins - 1) + 1))
                      for g in range(1, len(segs) + 1, bins)]
    t_all = sphere_row_t_p(rows, o, d, tm, t_min).numpy()  # (R, N)
    n_tiles = -(-R // tile)
    blocks = [(b, g) for b in range(n_tiles) if b * tile < n for g in range(len(groups))]
    spans = {b: slice(b * tile, min(R, (b + 1) * tile)) for b in range(n_tiles)}
    W = {b: sum(any(bool(work[k][2][spans[b]].any()) for k in grp) for grp in groups[1:])
         for b in spans}
    keys = np.full(R, MISS_KEY, np.uint64)
    tickets, last = dict.fromkeys(spans, 0), {}
    for x in (range(len(blocks)) if order is None else order):
        b, g = blocks[x]
        took = False
        for k in groups[g]:
            r0, r1, cross = work[k]
            lanes = torch.arange(R)[spans[b]][cross[spans[b]]].numpy()
            took |= bool(len(lanes))
            if len(lanes) and r1 > r0:
                t = t_all[lanes, r0:r1]
                key = np.where(t < BIG, order_key(t, np.arange(r0, r1)[None, :]), MISS_KEY)
                keys[lanes] = np.minimum(keys[lanes], key.min(axis=1))
        if g == 0 and W[b] == 0:
            last[b] = x
            continue
        if g and not took:
            continue
        tickets[b] += KEY_ARRIVE - W[b] if g == 0 else 1
        if tickets[b] == KEY_ARRIVE:
            if b in last:
                raise AssertionError(f"tile {b} reached its ticket sum twice")
            last[b] = x
    hit = torch.from_numpy(keys != MISS_KEY)
    idx = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    idx = torch.where(hit, idx, 0)
    t = torch.from_numpy(t_all).gather(1, idx[:, None])[:, 0]
    t = torch.where(hit, t, BIG)
    normal, mat = sphere_attributes_p(rows, o, d, tm, t, idx)
    normal, (mat,) = miss_defaults(hit, normal, (mat,))
    return (t, normal, mat), last


_SKIP_SCRATCH: dict = {}  # str(device) -> (keys, tickets)


def skip_scratch(R: int, dev):
    """K16's scratch on ``dev`` for a call of ``R`` lanes: (keys int64
    (>= R), each ``MISS_KEY``'s bits, tickets int64 (>= ceil(R / 256)),
    each 0), grown to the largest R asked for and kept across calls (the
    standalone and tail-only calls differ in R); every call leaves it as it
    found it.  Calls on one stream only: two calls in flight at once on
    different streams would share it."""
    tiles = -(-R // _build.BLOCK)
    have = _SKIP_SCRATCH.get(str(dev))
    if have is None or have[1].shape[0] < tiles:
        miss = MISS_KEY - (1 << 64) if MISS_KEY >= 1 << 63 else MISS_KEY
        have = (torch.full((tiles * _build.BLOCK,), miss, dtype=torch.int64, device=dev),
                torch.zeros(tiles, dtype=torch.int64, device=dev))
        _SKIP_SCRATCH[str(dev)] = have
    return have


def _culled_launch(name, rows, seg, n_head, o, d, tm, t_min, n_live=None):
    dev = o[0].device
    ins = (*o, *d, tm)
    R = ins[0].shape[0]
    _build.check_planes(_RAY + ("tm",), ins, R, torch.float32, dev)
    rows = _build.check_table(f"{name} rows", rows, 10, dev)
    seg = _build.check_table(f"{name} segments", seg, 8, dev)
    if n_live is not None:
        _build.check_planes(("n_live",), (n_live,), 1, torch.int32, dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    nx, ny, nz = (torch.empty_like(t) for _ in range(3))
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    ptrs = _build.pointers((*ins, t, nx, ny, nz, mat))
    lib = _build.library()
    if name == SKIP:
        keys, tickets = skip_scratch(R, dev)
        rc = lib.art_sphere_skip(rows.data_ptr(), seg.data_ptr(), seg.shape[0] - 1, n_head, R,
                                 float(t_min), None if n_live is None else n_live.data_ptr(),
                                 keys.data_ptr(), tickets.data_ptr(), ptrs,
                                 _build.stream_handle(dev))
    else:  # K17, or K15's spheres (CLUSTER) through it with no head
        rc = lib.art_sphere_cellbin(rows.data_ptr(), seg.data_ptr(), seg.shape[0] - 1, n_head,
                                    R, float(t_min), ptrs, _build.stream_handle(dev))
    _build.check(rc, name)
    _build.launch(name)
    return t, (nx, ny, nz), mat


def sphere_skip_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                                tail_only: bool = False, n_live=None):
    """Plain PyTorch K16 over ``sph_skip_rows`` (``culled_plain``)."""
    return culled_plain(tables.sph_skip_rows, tables.sph_skip_bins, o, d, tm, t_min,
                        occlusion=False, head=not tail_only, n_live=n_live)


def sphere_skip_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                          tail_only: bool = False, n_live=None):
    """K16: K2's (t, normal, mat) over the head and the skip bins of the
    sphere tail; ``tail_only`` skips the head (the split pass's call on its
    compacted lanes), ``n_live`` as K2's.  The CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return sphere_skip_hit_attrs_plain(tables, o, d, tm, t_min, tail_only=tail_only,
                                           n_live=n_live)
    n_head = 0 if tail_only else tables.sph_skip_bins[0]
    return _culled_launch(SKIP, tables.sph_skip_rows, tables.sph_skip_seg, n_head, o, d, tm,
                          t_min, n_live)


def sphere_cellbin_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """Plain PyTorch K17 over ``sph_cellbin_rows`` (``culled_plain``)."""
    return culled_plain(tables.sph_cellbin_rows, tables.sph_cellbin_meta, o, d, tm, t_min,
                        occlusion=True)


def sphere_cellbin_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """K17: K2's (t, normal, mat) over the head and the lattice cells with
    the occlusion bound; the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    if o[0].device.type == "cpu":
        return sphere_cellbin_hit_attrs_plain(tables, o, d, tm, t_min)
    return _culled_launch(CELLBIN, tables.sph_cellbin_rows, tables.sph_cellbin_seg,
                          tables.sph_cellbin_meta[0], o, d, tm, t_min)


def sphere_cluster_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """Plain PyTorch K15 (spheres) over ``sph_cl_rows``: ``culled_plain``
    with the occlusion bound and no head."""
    return culled_plain(tables.sph_cl_rows, tables.sph_cl_meta, o, d, tm, t_min,
                        occlusion=True, head=False)


def sphere_cluster_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """K15 (spheres): K2's (t, normal, mat) over the BVH-leaf clusters; for
    CUDA tensors K17's kernel with no head (any number of clusters), counted
    as ``sphere_cluster``, for CPU tensors the plain twin."""
    if o[0].device.type == "cpu":
        return sphere_cluster_hit_attrs_plain(tables, o, d, tm, t_min)
    return _culled_launch(CLUSTER, tables.sph_cl_rows, tables.sph_cl_seg, 0, o, d, tm, t_min)


def _sphere_outputs(R: int, dev):
    t = torch.empty(R, dtype=torch.float32, device=dev)
    return (t, *(torch.empty_like(t) for _ in range(3)),
            torch.empty(R, dtype=torch.int32, device=dev))


def _baked_t_min(t_min: float, name: str) -> None:
    if t_min != T_MIN:
        raise ValueError(f"{name} bakes t_min = {T_MIN} in, as the TPU kernel; got {t_min}")


_STATIC_ROWS: dict = {}  # (id(cells), device) -> (cells, _static_rows' tables)


def _static_rows(tables: SceneTables, dev):
    """K13's cells as the twin's tables on ``dev``: (R_mm (M, 10) [c v r mat
    r2 K], the moving rows first, then the main rows with v = 0; the number
    of moving rows; R_tail (T, 10) with the tail's radius and material)."""
    cells = tables.sph_static_cells
    hit = _STATIC_ROWS.get((id(cells), str(dev)))
    if hit is not None and hit[0] is cells:
        return hit[1]
    moving, main, tail = cells
    mm = [(*r[:9], 0.0) for r in moving]
    mm += [(cx, cy, cz, 0.0, 0.0, 0.0, r, m, r2, k) for cx, cy, cz, r, m, r2, k in main]
    tr = [(cx, cy, cz, 0.0, 0.0, 0.0, tables.sph_tail_r, tables.sph_tail_mat, r2, k)
          for cx, cy, cz, r2, k in tail]
    out = (torch.tensor(mm, dtype=torch.float32, device=dev).reshape(-1, 10), len(moving),
           torch.tensor(tr, dtype=torch.float32, device=dev).reshape(-1, 10))
    _STATIC_ROWS[(id(cells), str(dev))] = (cells, out)
    return out


def _static_scan(rows, n_moving: int, o, d, tm, expand: bool):
    """(t, cx, cy, cz, row index) of the first closest of ``rows`` [c v r mat
    r2 K] per ray, K13's candidate: a moving row (the first ``n_moving``)
    in the direct form with its centre at the ray's time, a zero velocity
    component skipping the motion term; a static row in the direct form or,
    with ``expand``, the expanded one (``csrc/sphere.cuh``)."""
    R = o[0].shape[0]
    if rows.shape[0] == 0:
        big = torch.full_like(o[0], BIG)
        zero = torch.zeros_like(big)
        return big, zero, zero, zero, torch.zeros(R, dtype=torch.int64, device=big.device)
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    a = dx * dx + dy * dy + dz * dz
    tcol = tm[:, None]
    mov, stat = rows[:n_moving], rows[n_moving:]
    centres = [torch.cat([torch.where(mov[None, :, 3 + k] == 0.0,
                                      mov[None, :, k].expand(R, -1),
                                      mov[None, :, k] + tcol * mov[None, :, 3 + k]),
                          stat[None, :, k].expand(R, -1)], dim=1) for k in range(3)]
    ocx, ocy, ocz = (oc - c for oc, c in zip((ox, oy, oz), centres))
    bq = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rows[None, :, 8]
    if expand and stat.shape[0]:
        sx, sy, sz = (s[:, n_moving:] for s in centres)
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        bq_s = od - (sx * dx + sy * dy + sz * dz)
        c_s = (oo + stat[None, :, 9]) - (sx * (2.0 * ox) + sy * (2.0 * oy) + sz * (2.0 * oz))
        bq = torch.cat([bq[:, :n_moving], bq_s], dim=1)
        c = torch.cat([c[:, :n_moving], c_s], dim=1)
    disc = bq * bq - a * c
    s = sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    t1 = (-bq - s) * inv_a
    t2 = (-bq + s) * inv_a
    valid = disc > 0.0
    t = torch.where(valid & (t1 > T_MIN), t1,
                    torch.where(valid & (t2 > T_MIN), t2, torch.full_like(t1, BIG)))
    t_best, idx = torch.min(t, dim=1)  # the first index among exact ties
    pick = idx[:, None]
    return (t_best, *(torch.gather(x, 1, pick)[:, 0] for x in centres), idx)


def sphere_static_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                                  expand: bool = False):
    """Plain PyTorch K13 over ``tables.sph_static_cells`` (module
    docstring)."""
    _baked_t_min(t_min, STATIC)
    mm, n_moving, tail = _static_rows(tables, o[0].device)
    t, cx, cy, cz, idx = _static_scan(mm, n_moving, o, d, tm, expand)
    r = mm[:, 6][idx] if mm.shape[0] else torch.ones_like(t)
    mat = mm[:, 7][idx] if mm.shape[0] else torch.zeros_like(t)
    t_t, tx, ty, tz, _ = _static_scan(tail, 0, o, d, tm, expand)
    better = t_t < t
    t = torch.where(better, t_t, t)
    cx, cy, cz = (torch.where(better, a, b) for a, b in ((tx, cx), (ty, cy), (tz, cz)))
    r = torch.where(better, float(tables.sph_tail_r), r)
    mat = torch.where(better, float(tables.sph_tail_mat), mat)
    p = p_ray_at(o, d, t)
    inv_r = 1.0 / r
    normal = ((p[0] - cx) * inv_r, (p[1] - cy) * inv_r, (p[2] - cz) * inv_r)
    normal, (mat,) = miss_defaults(t < BIG, normal, (mat.to(torch.int32),))
    return t, normal, mat


def sphere_static_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                            expand: bool = False):
    """K13: the scene's baked kernel (built on first use, ``expand`` picking
    the quadratic form) for CUDA tensors, the plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return sphere_static_hit_attrs_plain(tables, o, d, tm, t_min, expand=expand)
    _baked_t_min(t_min, STATIC)
    if tables.sph_static_cells is None:
        raise ValueError("sphere_static_hit_attrs: the scene has no static cells "
                         "(more than 2048 spheres)")
    dev = o[0].device
    ins = (*o, *d, tm)
    R = ins[0].shape[0]
    _build.check_planes(_RAY + ("tm",), ins, R, torch.float32, dev)
    lib = static_library(tables, expand)
    outs = _sphere_outputs(R, dev)
    rc = lib.art_sphere_static(R, _build.pointers(ins + outs), _build.stream_handle(dev))
    _build.check(rc, STATIC)
    _build.launch(STATIC)
    t, nx, ny, nz, mat = outs
    return t, (nx, ny, nz), mat


def static_library(tables: SceneTables, expand: bool):
    """K13's library for the scene's cells and form (``_build.static_libraries``)."""
    return _build.static_libraries([(tables.sph_static_cells, tables.sph_tail_r,
                                     tables.sph_tail_mat, expand)])[0]


def sphere_mxu_hit_attrs_plain(F, attr, o, d, tm, t_min=T_MIN):
    """Plain PyTorch K14 over the features ``F`` (2 S_pad, 16) and ``attr``
    (8, S_pad) (``csrc/sphere_mxu.cu``, term for term)."""
    _baked_t_min(t_min, MXU)
    b, disc, ta2, neg_inv_a = mxu_discriminants(F, attr.shape[1], o, d, tm, t_min)
    sq = sqrt(torch.clamp_min(disc, 0.0))
    cand = (b + torch.where(b + sq < ta2, sq, -sq)) * neg_inv_a
    tc = torch.where((disc > 0.0) & (cand > 2.0 * t_min), cand, torch.full_like(cand, BIG))
    best, sid = torch.min(tc, dim=1)  # the first index among exact ties
    return mxu_winner(attr, o, d, tm, best, sid)


def mxu_discriminants(F, s_pad: int, o, d, tm, t_min=T_MIN):
    """K14's (R, S_pad) b = o.d - B and disc = b^2 - a c (c = C + |o|^2),
    each feature sum in ascending column order, and the per-ray (R, 1)
    root terms -2 t_min a and -1 / a."""
    ox, oy, oz = o
    dx, dy, dz = d
    rf = (dx, dy, dz, tm * dx, tm * dy, tm * dz, ox, oy, oz, tm * ox, tm * oy, tm * oz,
          None, tm, tm * tm)
    fb, fc = F[:s_pad], F[s_pad:]
    B = fb[None, :, 0] * dx[:, None]
    for k in range(1, 6):
        B = B + fb[None, :, k] * rf[k][:, None]
    C = fc[None, :, 6] * ox[:, None]
    for k in range(7, 15):
        C = C + (fc[None, :, k] if k == 12 else fc[None, :, k] * rf[k][:, None])
    a = dx * dx + dy * dy + dz * dz
    t_sel = 2.0 * t_min
    neg_inv_a = (-1.0 / a)[:, None]
    od = (ox * dx + oy * dy + oz * dz)[:, None]
    o2 = (ox * ox + oy * oy + oz * oz)[:, None]
    ta2 = (-t_sel * a)[:, None]
    b = od - B
    c = C + o2
    return b, b * b - a[:, None] * c, ta2, neg_inv_a


def mxu_winner(attr, o, d, tm, best, sid):
    """K14's output from each ray's least candidate ``best`` at feature row
    ``sid``: the winner's attribute column, one Newton step, the normal; a
    miss (best >= BIG / 2) as K2's."""
    ox, oy, oz = o
    dx, dy, dz = d
    hit = best < BIG * 0.5
    A = attr[:, sid]  # (8, R): the winner's column
    cx, cy, cz = (A[k] + tm * A[3 + k] for k in range(3))
    r = A[6]
    px, py, pz = ox + best * dx - cx, oy + best * dy - cy, oz + best * dz - cz
    f = px * px + py * py + pz * pz - r * r
    fp = 2.0 * (dx * px + dy * py + dz * pz)
    step = fp.abs() > 1e-12
    t = torch.where(step, best - f / torch.where(step, fp, torch.ones_like(fp)), best)
    inv_r = 1.0 / r
    normal = ((ox + t * dx - cx) * inv_r, (oy + t * dy - cy) * inv_r,
              (oz + t * dz - cz) * inv_r)
    normal, (mat,) = miss_defaults(hit, normal, (A[7].to(torch.int32),))
    return torch.where(hit, t, BIG), normal, mat


def sphere_mxu_hit_attrs(F, attr, o, d, tm, t_min=T_MIN):
    """K14 over the features ``F`` and ``attr``: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return sphere_mxu_hit_attrs_plain(F, attr, o, d, tm, t_min)
    _baked_t_min(t_min, MXU)
    dev = o[0].device
    ins = (*o, *d, tm)
    R = ins[0].shape[0]
    _build.check_planes(_RAY + ("tm",), ins, R, torch.float32, dev)
    F = _build.check_table("F", F, 16, dev)
    s_pad = F.shape[0] // 2
    attr = _build.check_table("attrT", attr, s_pad, dev)
    if attr.shape[0] != 8 or s_pad % 128 or F.shape[0] != 2 * s_pad or F.data_ptr() % 16:
        raise ValueError(f"K14 needs F (2 S_pad, 16), 16-byte aligned, and attrT (8, S_pad) "
                         f"with S_pad a multiple of 128, got {tuple(F.shape)} and "
                         f"{tuple(attr.shape)}")
    outs = _sphere_outputs(R, dev)
    rc = _build.library().art_sphere_mxu(F.data_ptr(), attr.data_ptr(), s_pad, R,
                                         _build.pointers(ins + outs),
                                         _build.stream_handle(dev))
    _build.check(rc, MXU)
    _build.launch(MXU)
    t, nx, ny, nz, mat = outs
    return t, (nx, ny, nz), mat


def quad_hit_attrs_plain(tables: SceneTables, o, d, t_min=T_MIN):
    """Plain PyTorch K5: ``quad_candidates_p`` over ``quad_rows``, then
    ``quad_attributes_p`` of the winner (row 0 for a miss) and the miss
    defaults; returns (t, normal 3-tuple, alpha, beta, mat int32)."""
    t, idx = quad_candidates_p(tables, o, d, t_min)
    normal, alpha, beta, mat = quad_attributes_p(tables, o, d, t, idx.clamp_min(0))
    normal, (alpha, beta, mat) = miss_defaults(t < BIG, normal, (alpha, beta, mat))
    return t, normal, alpha, beta, mat


def quad_hit_attrs(tables: SceneTables, o, d, t_min=T_MIN):
    """K5: the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return quad_hit_attrs_plain(tables, o, d, t_min)
    dev = o[0].device
    ins = (*o, *d)
    R = ins[0].shape[0]
    _build.check_planes(_RAY, ins, R, torch.float32, dev)
    rows = _build.check_table("quad_rows", tables.quad_rows, 12, dev)
    attrs = _build.check_table("quad_attr_packed", tables.quad_attr_packed, 16, dev)
    if attrs.shape[0] != rows.shape[0]:
        raise ValueError(f"quad_attr_packed has {attrs.shape[0]} rows, quad_rows "
                         f"{rows.shape[0]}")
    outs = tuple(torch.empty(R, dtype=torch.float32, device=dev) for _ in range(6))
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    rc = _build.library().art_quad_hit(rows.data_ptr(), attrs.data_ptr(), rows.shape[0], R,
                                       float(t_min), _build.pointers((*ins, *outs, mat)),
                                       _build.stream_handle(dev))
    _build.check(rc, QUAD)
    _build.launch(QUAD)
    t, nx, ny, nz, alpha, beta = outs
    return t, (nx, ny, nz), alpha, beta, mat


def box_hit_attrs_plain(tables: SceneTables, o, d, t_min=T_MIN):
    """Plain PyTorch K6: ``box_candidates_p`` + ``box_attributes_p`` over
    ``box_rows``; returns (t, normal 3-tuple, u, v, mat)."""
    t, idx = box_candidates_p(tables, o, d, t_min)
    normal, u, v, mat = box_attributes_p(tables, o, d, t, idx.clamp_min(0))
    normal, (u, v, mat) = miss_defaults(t < BIG, normal, (u, v, mat))
    return t, normal, u, v, mat


def box_hit_attrs(tables: SceneTables, o, d, t_min=T_MIN):
    """K6: the CUDA kernel (rotated or axis-aligned form, by
    ``tables.has_rotated_boxes``) for CUDA tensors, the plain twin for CPU
    tensors."""
    if o[0].device.type == "cpu":
        return box_hit_attrs_plain(tables, o, d, t_min)
    outs = _box_outputs(o[0].shape[0], o[0].device)
    _box_launch(tables, o, d, t_min, outs, BOX)
    t, nx, ny, nz, u, v, mat = outs
    return t, (nx, ny, nz), u, v, mat


def box_hit_attrs_merge_plain(tables: SceneTables, o, d, best, t_min=T_MIN):
    """Plain PyTorch K6 merge form: ``_closer(best, box_hit_attrs_plain(...))``,
    the boxes' hit where it is strictly closer than ``best`` (t, normal,
    u, v, mat), which keeps exact ties; ``best`` is not changed."""
    return _closer(best, box_hit_attrs_plain(tables, o, d, t_min))


def box_hit_attrs_merge(tables: SceneTables, o, d, best, t_min=T_MIN):
    """K6's merge form: for CUDA tensors the kernel updates ``best``'s
    planes in place (the caller's own: ``closest_surface_p`` hands it K5's
    fresh outputs) and returns ``best``; for CPU tensors the plain twin,
    which returns new tensors."""
    if o[0].device.type == "cpu":
        return box_hit_attrs_merge_plain(tables, o, d, best, t_min)
    t, (nx, ny, nz), u, v, mat = best
    planes = (t, nx, ny, nz, u, v)
    _build.check_planes(("t", "nx", "ny", "nz", "u", "v"), planes, o[0].shape[0],
                        torch.float32, o[0].device)
    _build.check_planes(("mat",), (mat,), o[0].shape[0], torch.int32, o[0].device)
    _box_launch(tables, o, d, t_min, (*planes, mat), BOX_MERGE)
    return best


def _box_launch(tables: SceneTables, o, d, t_min, outs, name):
    """``art_box_hit`` into the seven planes ``outs``; ``name`` (BOX or
    BOX_MERGE) picks the form and the launch count."""
    dev = o[0].device
    ins = (*o, *d)
    R = ins[0].shape[0]
    _build.check_planes(_RAY, ins, R, torch.float32, dev)
    rows = _build.check_table("box_rows", tables.box_rows, 12, dev)
    rc = _build.library().art_box_hit(rows.data_ptr(), rows.shape[0], R, float(t_min),
                                      int(tables.has_rotated_boxes), int(name == BOX_MERGE),
                                      _build.pointers(ins + tuple(outs)),
                                      _build.stream_handle(dev))
    _build.check(rc, name)
    _build.launch(name)


def _box_outputs(R: int, dev):
    """K6's output planes: t, normal x3, u, v (float32) and mat (int32)."""
    t = torch.empty(R, dtype=torch.float32, device=dev)
    return (t, *(torch.empty_like(t) for _ in range(5)),
            torch.empty(R, dtype=torch.int32, device=dev))


def box_cluster_hit_attrs_plain(tables: SceneTables, o, d, t_min=T_MIN):
    """Plain PyTorch K15 (boxes) over ``box_cl_rows``: per cluster K6's
    candidate pass over its rows, taken where ``cluster_slab`` passes (the
    clusters' union box first, then the cluster's box, bounded by the running
    best t) and strictly closer; then K6's winner attributes."""
    rows, (_, segs, union) = tables.box_cl_rows, tables.box_cl_meta
    inv = tuple(1.0 / safe_dir(c) for c in d)
    t = torch.full_like(o[0], BIG)
    idx = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)
    needy = cluster_slab(union, o, inv, t_min, t)
    for row0, row1, box in segs:
        cross = needy & cluster_slab(box, o, inv, t_min, t)
        t_c, i_c = box_candidates_rows(rows[row0:row1], tables.has_rotated_boxes, o, d, t_min)
        better = cross & (t_c < t)
        t, idx = torch.where(better, t_c, t), torch.where(better, i_c + row0, idx)
    normal, u, v, mat = box_attributes_rows(take_rows(rows, idx.clamp_min(0)), o, d, t)
    normal, (u, v, mat) = miss_defaults(t < BIG, normal, (u, v, mat))
    return t, normal, u, v, mat


def box_cluster_hit_attrs(tables: SceneTables, o, d, t_min=T_MIN):
    """K15 (boxes): K6's (t, normal, u, v, mat) over the BVH-leaf clusters;
    the CUDA kernel (rotated or axis-aligned form) for CUDA tensors, the
    plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return box_cluster_hit_attrs_plain(tables, o, d, t_min)
    dev = o[0].device
    ins = (*o, *d)
    R = ins[0].shape[0]
    _build.check_planes(_RAY, ins, R, torch.float32, dev)
    rows = _build.check_table("box_cl_rows", tables.box_cl_rows, 12, dev)
    seg = _build.check_table("box_cl_seg", tables.box_cl_seg, 8, dev)
    t, nx, ny, nz, u, v, mat = outs = _box_outputs(R, dev)
    rc = _build.library().art_box_cluster(rows.data_ptr(), seg.data_ptr(), seg.shape[0] - 1,
                                          R, float(t_min), int(tables.has_rotated_boxes),
                                          _build.pointers(ins + outs),
                                          _build.stream_handle(dev))
    _build.check(rc, BOX_CLUSTER)
    _build.launch(BOX_CLUSTER)
    return t, (nx, ny, nz), u, v, mat


def _grid_plain(tables: SceneTables, o, d, t_min, grouped: bool):
    cells = grid_cells(tables, grouped)
    t, idx = box_grid_candidates_p(tables, cells, o, d, t_min)
    normal, u, v, mat = box_grid_attributes_p(tables, cells, o, d, t, idx.clamp_min(0))
    normal, (u, v, mat) = miss_defaults(t < BIG, normal, (u, v, mat))
    return t, normal, u, v, mat


def box_grid_hit_attrs_plain(tables: SceneTables, o, d, t_min=T_MIN):
    """Plain PyTorch K10: every cell of the grid in row-major order."""
    return _grid_plain(tables, o, d, t_min, grouped=False)


def box_grid_cells_hit_attrs_plain(tables: SceneTables, o, d, t_min=T_MIN):
    """Plain PyTorch K9: the non-empty cells in ``box_grid_cells`` order."""
    return _grid_plain(tables, o, d, t_min, grouped=True)


def box_grid_skip_p(tables: SceneTables, o, d, t_min=T_MIN):
    """The lanes K9 may leave untested (``csrc/box_grid.cu``): with ``t_min
    >= 0``, a ray that starts at or above the floor and every top of
    ``box_grid_cell_rows`` and does not point down misses every cell.  The
    kernel skips a warp whose 32 lanes all pass it (over each tile's tops);
    the tests hold it to ``box_grid_cells_hit_attrs_plain``."""
    top = max(tables.box_grid_y0, float(tables.box_grid_cell_rows[:, 2].max()))
    return (o[1] >= top) & (d[1] >= 0.0) & (float(t_min) >= 0.0)


def box_grid_cells_form(tables: SceneTables) -> str:
    """K9's form for the scene's lattice: "hoisted" (the x and z slabs once a
    column and row, in shared memory) or "per-cell" (``csrc/box_grid.cu``
    art_box_grid_cells_form; needs the built library)."""
    hoisted = _build.library().art_box_grid_cells_form(tables.box_grid_kx, tables.box_grid_kz)
    return "hoisted" if hoisted else "per-cell"


def _grid_launch(tables: SceneTables, o, d, t_min, grouped: bool):
    dev = o[0].device
    ins = (*o, *d)
    R = ins[0].shape[0]
    _build.check_planes(_RAY, ins, R, torch.float32, dev)
    if grouped:
        cells = _build.check_table("box_grid_cell_rows", tables.box_grid_cell_rows, 4, dev)
        n = cells.shape[0]
    else:
        cells = _build.check_table("box_grid_rows", tables.box_grid_rows,
                                   2 * tables.box_grid_kz, dev)
        n = tables.box_grid_kx
    t = torch.empty(R, dtype=torch.float32, device=dev)
    nx, ny, nz, u, v = (torch.empty_like(t) for _ in range(5))
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    ptrs = _build.pointers((*ins, t, nx, ny, nz, u, v, mat))
    lattice = (ctypes.c_float * 4)(tables.box_grid_x0, tables.box_grid_z0,
                                   tables.box_grid_w, tables.box_grid_y0)
    lib, name = _build.library(), GRID_CELLS if grouped else GRID
    if grouped:
        rc = lib.art_box_grid_cells(cells.data_ptr(), n, tables.box_grid_kx,
                                    tables.box_grid_kz, lattice, R, float(t_min), ptrs,
                                    _build.stream_handle(dev))
    else:
        rc = lib.art_box_grid(cells.data_ptr(), n, tables.box_grid_kz, lattice, R,
                              float(t_min), ptrs, _build.stream_handle(dev))
    _build.check(rc, name)
    _build.launch(name)
    return t, (nx, ny, nz), u, v, mat


def box_grid_hit_attrs(tables: SceneTables, o, d, t_min=T_MIN):
    """K10: (t, normal, u, v, mat) over the run-time (kx, 2 kz) cell table
    ``box_grid_rows``; the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors."""
    if o[0].device.type == "cpu":
        return box_grid_hit_attrs_plain(tables, o, d, t_min)
    return _grid_launch(tables, o, d, t_min, grouped=False)


def box_grid_cells_hit_attrs(tables: SceneTables, o, d, t_min=T_MIN):
    """K9: as K10 over ``box_grid_cell_rows``, the non-empty cells in
    ``box_grid_cells`` order; the CUDA kernel for CUDA tensors, the plain
    twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return box_grid_cells_hit_attrs_plain(tables, o, d, t_min)
    return _grid_launch(tables, o, d, t_min, grouped=True)
