"""The split sphere pass: the sphere tail only for the rays that can reach it.

Port of ``art_tpu/ops/compact_sphere.py``.  final_scene and original_scene
hold a 1000-ball cluster of one radius and material (the tail,
``scene/builder._sphere_tail``) inside a small box that most rays never
cross.  ``sphere_hit_attrs_split`` is K2 over ``sph_rows`` computed as:

1. K2 over ``sph_head_rows`` (every other sphere) at all R lanes;
2. ``needy = tail_box_needy(sph_tail_box)``, a conservative slab test;
3. ``compact_ray_ids(needy)`` (K4, ``ops/compact_fetch.py``): slot j holds
   the j-th needy lane's ray id, the count stays on the device;
4. one gather of the (6, R) ray planes at those ids;
5. K2 over ``sph_tail_rows`` on the compacted slots with ``n_live`` = the
   needy count, so slots past it miss without a sphere test;
6. a scatter of (t, normal) back to the needy lanes (the other slots go to
   a spare row) and a merge with the head by closest t, the head keeping
   exact ties; a tail winner takes ``sph_tail_mat``.

``art_tpu`` runs a 8192-slot compact branch or the dense kernel by the needy
count through ``lax.cond``; PyTorch has no device-side cond and reading the
count would sync every iteration, so the port runs one pipeline at the
compacted fetch's capacity (``ceil(R / 128) * 128`` slots), as the image
fetch does.  The split equals K2 over ``sph_rows`` but on an exact tie
between a head sphere that comes after the tail in scene order and a tail
sphere (no reference scene has one).  ``art_tpu``'s occlusion gate, MXU
tail and skip and cell-bin fallbacks (``compact_sphere.py:156-213``,
``:237-248``) are opt-in there and not ported.  With ``plain=True`` every
kernel's plain twin runs.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.ops import compact_fetch as cf
from art_tpu_torch.ops import intersect_kernels as K
from art_tpu_torch.scene.tables import SceneTables

SPLIT_MIN_TAIL = 512  # art_tpu's gate (intersect.py:164, _COMPACT_SPH_MIN_TAIL)


def use_split(tables: SceneTables) -> bool:
    """``art_tpu``'s gate (``intersect.py:666-673``): a tail of at least 512
    spheres with its box."""
    return tables.sph_n_tail >= SPLIT_MIN_TAIL and bool(tables.sph_tail_box)


def tail_box_interval(box, o, d, t_min: float):
    """((R,) bool could-hit, (R,) entry t) of the inflated tail box over the
    ray's (t_min, inf) segment.  A zero direction component becomes 1e-20
    (not IEEE inf semantics): an origin inside that slab then spans the whole
    line, one outside it a one-sided huge interval — both err toward needy."""
    x0, y0, z0, x1, y1, z1 = box
    t_near = torch.full_like(o[0], t_min)
    t_far = torch.full_like(o[0], BIG)
    for lo, hi, oc, dc in ((x0, x1, o[0], d[0]), (y0, y1, o[1], d[1]),
                           (z0, z1, o[2], d[2])):
        inv = 1.0 / torch.where(dc == 0.0, 1e-20, dc)
        ta = (lo - oc) * inv
        tb = (hi - oc) * inv
        t_near = torch.maximum(t_near, torch.minimum(ta, tb))
        t_far = torch.minimum(t_far, torch.maximum(ta, tb))
    return t_far >= t_near, t_near


def tail_box_needy(box, o, d, t_min: float) -> torch.Tensor:
    """(R,) bool: True wherever the ray's (t_min, inf) segment could meet the
    tail box (``tail_box_interval``)."""
    return tail_box_interval(box, o, d, t_min)[0]


def sphere_hit_attrs_split(tables: SceneTables, o, d, tm, t_min=T_MIN, *,
                           plain: bool = False):
    """K2's (t, normal 3-tuple, mat) over ``sph_rows``, computed as the
    head pass plus the compacted tail pass (module docstring)."""
    hit_attrs = K.sphere_hit_attrs_plain if plain else K.sphere_hit_attrs
    t_h, n_h, m_h = hit_attrs(tables, o, d, tm, t_min, rows=tables.sph_head_rows)
    R = o[0].shape[0]
    needy = tail_box_needy(tables.sph_tail_box, o, d, t_min)
    cnt = needy.sum(dtype=torch.int32).reshape(1)  # stays on the device
    ray_k = cf.compact_ray_ids(needy, plain=plain)
    rays_k = torch.stack([*o, *d]).index_select(1, ray_k)  # (6, slots)
    t_c, n_c, _ = hit_attrs(tables, tuple(rays_k[0:3]), tuple(rays_k[3:6]),
                            torch.zeros_like(rays_k[0]), t_min,
                            rows=tables.sph_tail_rows, n_live=cnt)
    # slots past the count route to a spare row R; a lane no slot reaches
    # keeps t = 0, read as no tail hit (a real hit has t > t_min > 0)
    slot = torch.arange(ray_k.shape[0], dtype=torch.int32, device=ray_k.device)
    dest = torch.where(slot < cnt, ray_k, R).to(torch.int64)
    out = torch.zeros((R + 1, 4), dtype=torch.float32, device=t_h.device)
    out.index_copy_(0, dest, torch.stack([t_c, *n_c], dim=1))
    t_cl = torch.where(out[:R, 0] > 0.0, out[:R, 0], BIG)
    better = t_cl < t_h  # the head keeps exact ties
    normal = tuple(torch.where(better, out[:R, 1 + c], n_h[c]) for c in range(3))
    return (torch.where(better, t_cl, t_h), normal,
            torch.where(better, int(tables.sph_tail_mat), m_h))
