"""Closest-sphere kernel (K2): ``csrc/sphere_hit.cu`` and its plain twin.

Replaces ``art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_planar`` (its
``_sphere_kernel``).  Both forms return ``(t, normal 3-tuple, mat)`` for
every ray: the closest hit with ``t > t_min`` over all spheres in scene
order (moving centers at the ray's shutter time), its signed-radius normal
``(p - c) / r`` and its material id; a miss gives ``t = BIG``, normal
``(1, 0, 0)`` and material 0 — the values ``closest_surface_p`` blends in
for misses.  UV is zero for the slice's scenes.
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.ops import _build
from art_tpu_torch.ops.intersect import sphere_attributes_p, sphere_candidates_p
from art_tpu_torch.scene.tables import SceneTables

NAME = "sphere_hit"


def sphere_hit_attrs_plain(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """Plain PyTorch K2: the candidate pass plus the winner attributes."""
    t, idx = sphere_candidates_p(tables, o, d, tm, t_min)
    normal, mat = sphere_attributes_p(tables, o, d, tm, t, idx)
    hit = t < BIG
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    normal = (torch.where(hit, normal[0], one), torch.where(hit, normal[1], zero),
              torch.where(hit, normal[2], zero))
    return t, normal, torch.where(hit, mat, torch.zeros_like(mat))


def sphere_hit_attrs(tables: SceneTables, o, d, tm, t_min=T_MIN):
    """K2: the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if o[0].device.type == "cpu":
        return sphere_hit_attrs_plain(tables, o, d, tm, t_min)
    dev = o[0].device
    R = o[0].shape[0]
    rows = tables.sph_rows
    S = rows.shape[0]
    ins = (*o, *d, tm)
    _build.check_planes(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), ins, R,
                        torch.float32, dev)
    if rows.device != dev or rows.dtype != torch.float32 or rows.shape != (S, 10) \
            or not rows.is_contiguous():
        raise ValueError(f"sph_rows: need a contiguous ({S}, 10) float32 "
                         f"tensor on {dev}")
    t = torch.empty(R, dtype=torch.float32, device=dev)
    nx, ny, nz = (torch.empty_like(t) for _ in range(3))
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    lib = _build.library()
    ptrs = _build.pointers((*ins, t, nx, ny, nz, mat))
    rc = lib.art_sphere_hit(rows.data_ptr(), S, R, float(t_min), ptrs,
                            _build.stream_handle(dev))
    _build.check(rc, NAME)
    _build.launches[NAME] += 1
    return t, (nx, ny, nz), mat
