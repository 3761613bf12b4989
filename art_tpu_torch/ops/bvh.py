"""Host-built BVH with a flattened, traversal-friendly layout
(``art_tpu/ops/bvh.py``, whole).

The host part is plain numpy and gives ``art_tpu``'s arrays bit for bit:

* ``build_bvh`` (``:53``): split axis = the largest spread of box *minima*
  with the reference's tie rule (src/bvh.cuh:45-63), the range sorted stably
  by box minimum along it, a midpoint split, a leaf per primitive; bounds in
  float64, rounded to float32 to nearest once the tree is built (so a box
  is conservative only to half an ulp);
* ``leaf_order`` (``:120``), ``cluster_primitives`` (``:125``; the port's
  clusters are exact row ranges, so it pads nothing),
  ``sphere_world_bounds`` (``:170``), ``box_world_bounds`` (``:180``) and
  ``pack_bvh`` (``:206``): (M, 8) float32 rows ``[min(3) max(3) escape
  prim]``.

The tree is in preorder with escape links: node i's subtree is [i,
escape_i), its left child i + 1, and a miss jumps to escape_i, so a
traversal is one monotone node counter per ray.  ``traverse_closest_packed``
(``:230``) is that walk in PyTorch on tensors, the opt-in per-ray descent of
``ART_TPU_BVH`` (``ops/intersect.bvh_sphere_candidates_p``): a Python loop
of steps, each a handful of tensor operations over every ray.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

# The descent reads its exit condition (any lane still walking) from the
# device every CHECK_EVERY steps, not every step as art_tpu's while_loop
# does on its device: a finished lane stays at node M and a step changes
# nothing there, so the extra steps are no-ops and the result is the same.
CHECK_EVERY = 16
DIR_GUARD = 1e-12  # the descent's slab guard (art_tpu/ops/bvh.py:254)


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Preorder node arrays; leaves reference primitive indices."""

    bbox_min: np.ndarray  # (M, 3) float32
    bbox_max: np.ndarray  # (M, 3) float32
    escape: np.ndarray  # (M,) int32: index after the node's subtree (miss jump)
    prim: np.ndarray  # (M,) int32: primitive index of a leaf, -1 internal

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


def build_bvh(bmin: np.ndarray, bmax: np.ndarray) -> FlatBVH:
    """The flattened tree over primitive boxes (N, 3) / (N, 3)."""
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    n = bmin.shape[0]
    order = np.arange(n)
    nodes_min: list = []
    nodes_max: list = []
    nodes_escape: list = []
    nodes_prim: list = []

    def build(start: int, end: int) -> None:
        count = end - start
        idxs = order[start:end]
        me = len(nodes_min)
        nodes_min.append(bmin[idxs].min(axis=0))
        nodes_max.append(bmax[idxs].max(axis=0))
        nodes_escape.append(-1)  # set once the subtree is emitted
        nodes_prim.append(int(idxs[0]) if count == 1 else -1)
        if count > 1:
            # x wins ties against y, y against z; z needs a strict win over
            # x and >= y (src/bvh.cuh:45-63)
            mins = bmin[idxs]
            spread = mins.max(axis=0) - mins.min(axis=0)
            axis = 0
            if spread[1] > spread[0] and spread[1] >= spread[2]:
                axis = 1
            elif spread[2] > spread[0] and spread[2] >= spread[1]:
                axis = 2
            seg = order[start:end]
            order[start:end] = seg[np.argsort(bmin[seg, axis], kind="stable")]
            mid = start + (count >> 1)  # midpoint split (bvh.cuh:79)
            build(start, mid)
            build(mid, end)
        nodes_escape[me] = len(nodes_min)

    if n > 0:
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 2 * n + 100))
        try:
            build(0, n)
        finally:
            sys.setrecursionlimit(old)
    return FlatBVH(
        bbox_min=np.asarray(nodes_min, np.float32).reshape(-1, 3),
        bbox_max=np.asarray(nodes_max, np.float32).reshape(-1, 3),
        escape=np.asarray(nodes_escape, np.int32),
        prim=np.asarray(nodes_prim, np.int32),
    )


def leaf_order(tree: FlatBVH) -> np.ndarray:
    """Primitive indices in preorder-leaf sequence: spatially local runs."""
    return tree.prim[tree.prim >= 0]


def cluster_primitives(bmin: np.ndarray, bmax: np.ndarray, packed: np.ndarray,
                       cluster_size: int):
    """The rows ``packed`` (N, K) in BVH-leaf order, cut into clusters of
    ``cluster_size``, each with its box: returns (rows, boxes (C, 8) float32
    ``[min(3) max(3) 0 0]``, C, order (N,)).  Each box is its members'
    float64 bounds rounded to float32.  The last cluster is simply shorter
    where ``art_tpu`` pads the rows with inert ones to C * cluster_size."""
    n = packed.shape[0]
    order = leaf_order(build_bvh(bmin, bmax))
    assert len(order) == n
    rows = np.asarray(packed, np.float32)[order]
    n_cl = -(-n // cluster_size)
    boxes = np.zeros((n_cl, 8), np.float32)
    bmin = np.asarray(bmin, np.float64)
    bmax = np.asarray(bmax, np.float64)
    for c in range(n_cl):
        idxs = order[c * cluster_size:(c + 1) * cluster_size]
        boxes[c, 0:3] = bmin[idxs].min(axis=0)
        boxes[c, 3:6] = bmax[idxs].max(axis=0)
    return rows, boxes, n_cl, order


def sphere_world_bounds(center, vel, radius):
    """Union of the t=0 and t=1 sphere boxes (src/sphere.cuh:33-37), float64."""
    c0 = np.asarray(center, np.float64)
    v = np.asarray(vel, np.float64)
    r = np.abs(np.asarray(radius, np.float64))[:, None]
    return np.minimum(c0, c0 + v) - r, np.maximum(c0, c0 + v) + r


def box_world_bounds(bmn, bmx, cos_t, sin_t, off):
    """World AABB of a y-rotated, translated box: its 8 rotated corners
    (reference rotate_y bbox, src/hittable.cuh:100-116), float64."""
    bmn = np.asarray(bmn, np.float64)
    bmx = np.asarray(bmx, np.float64)
    cos_t = np.asarray(cos_t, np.float64)
    sin_t = np.asarray(sin_t, np.float64)
    off = np.asarray(off, np.float64)
    lo = np.full((bmn.shape[0], 3), np.inf)
    hi = np.full((bmn.shape[0], 3), -np.inf)
    for ix in range(2):
        for iy in range(2):
            for iz in range(2):
                x = np.where(ix, bmx[:, 0], bmn[:, 0])
                y = np.where(iy, bmx[:, 1], bmn[:, 1])
                z = np.where(iz, bmx[:, 2], bmn[:, 2])
                # world = R(theta) * local + off
                pt = np.stack([cos_t * x + sin_t * z, y, -sin_t * x + cos_t * z], axis=-1)
                lo = np.minimum(lo, pt)
                hi = np.maximum(hi, pt)
    return lo + off, hi + off


def pack_bvh(tree: FlatBVH) -> np.ndarray:
    """(M, 8) float32 rows [min(3) max(3) escape prim]."""
    # escape links and prim indices ride float32 columns: exact below 2^24
    assert tree.n_nodes < (1 << 24), tree.n_nodes
    if tree.prim.size:
        assert int(np.max(tree.prim)) < (1 << 24), "prim index exceeds f32 width"
    out = np.zeros((tree.n_nodes, 8), np.float32)
    out[:, 0:3] = tree.bbox_min
    out[:, 3:6] = tree.bbox_max
    out[:, 6] = tree.escape
    out[:, 7] = tree.prim
    return out


def traverse_closest_packed(nodes: torch.Tensor, n_nodes: int, prim_t_fn, o: torch.Tensor,
                            d: torch.Tensor, t_min: float, t_max: float = 1e30,
                            stats: dict | None = None):
    """Escape-link descent over packed (M, 8) node rows (``pack_bvh``) with
    the shrinking-tmax closest-hit rule (reference bvh_node::hit,
    src/bvh.cuh:95-106), every ray walking its own node counter.

    ``o``, ``d``: (R, 3) rays.  ``prim_t_fn(prim (R,) int64, active (R,)
    bool)`` returns each ray's candidate t against its primitive (BIG on a
    miss).  A step: gather each ray's node row; the slab test of its box,
    bounded by t_min and the ray's best t so far; at a leaf the primitive's
    t, kept where t_min < t < best; descend to node + 1 from an internal
    node that is hit, else jump to its escape link.  Returns (t_best (R,),
    prim_best (R,) int32, -1 where nothing is hit).  ``stats``, when given,
    gets the number of steps taken under ``"steps"``."""
    R, M = o.shape[0], n_nodes
    guard = torch.where(d >= 0.0, DIR_GUARD, -DIR_GUARD)
    inv_d = 1.0 / torch.where(d.abs() < DIR_GUARD, guard, d)
    node = torch.zeros(R, dtype=torch.int64, device=o.device)
    best_t = torch.full((R,), t_max, dtype=torch.float32, device=o.device)
    best_p = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    steps = 0
    while steps % CHECK_EVERY or bool((node < M).any()):
        walking = node < M
        nid = node.clamp_max(M - 1)
        row = nodes.index_select(0, nid)
        ta = (row[:, 0:3] - o) * inv_d
        tb = (row[:, 3:6] - o) * inv_d
        t0 = torch.minimum(ta, tb).amax(dim=1)
        t1 = torch.maximum(ta, tb).amin(dim=1)
        box_hit = (t0.clamp_min(t_min) <= torch.minimum(t1, best_t)) & walking
        p = row[:, 7].to(torch.int64)
        is_leaf = p >= 0
        test_prim = box_hit & is_leaf
        cand = prim_t_fn(p.clamp_min(0), test_prim)
        better = test_prim & (cand < best_t) & (cand > t_min)
        best_t = torch.where(better, cand, best_t)
        best_p = torch.where(better, p, best_p)
        # an internal node that is hit: descend; a miss or a leaf: escape
        node = torch.where(box_hit & ~is_leaf, nid + 1, row[:, 6].to(torch.int64))
        node = torch.where(walking, node, M)  # finished lanes stay done
        steps += 1
    if stats is not None:
        stats["steps"] = steps
    return best_t, best_p.to(torch.int32)
