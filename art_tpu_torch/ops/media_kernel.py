"""K18 ``apply_media`` (``csrc/media.cu``): the constant media over the
surface hit record in one launch, in place of the ATen op chain of the plain
twin ``ops/intersect.py apply_media_p_plain`` (``art_tpu/ops/intersect.py:844``
is jnp: no Pallas kernel is replaced).  ``ops/intersect.py apply_media_p``
launches it for CUDA tensors.

The wrapper is the staged loop's host cost of the media, so it does one
library call: the ray and record planes are checked and handed as one
pointer array, the media's uniforms as their first row and the row stride
(the rows of the refill's uniform block), and the outputs are one (9, R)
float32 block viewed as planes, a bool and an int32 plane; ``surf``'s
tensors are only read.
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops import _build
from art_tpu_torch.ops.intersect import HitRecordP
from art_tpu_torch.scene.tables import MED_ROW, SceneTables

MEDIA = "media"
_F32 = ("ox", "oy", "oz", "dx", "dy", "dz", "surf.t", "surf.px", "surf.py", "surf.pz",
        "surf.nx", "surf.ny", "surf.nz", "surf.u", "surf.v")


def apply_media(tables: SceneTables, o, d, t_min, surf: HitRecordP, u_media,
                time=None) -> HitRecordP:
    """K18 on CUDA tensors: ``apply_media_p_plain``'s record, bit for bit.
    ``u_media[m]`` is medium m's (R,) uniform row, the rows equally spaced in
    one allocation (the refill block's); ``time`` None reads as 0."""
    dev = o[0].device
    R = o[0].shape[0]
    C = tables.n_media
    planes = (*o, *d, surf.t, *surf.p, *surf.normal, surf.u, surf.v)
    _build.check_planes(_F32, planes, R, torch.float32, dev)
    _build.check_planes(("surf.hit",), (surf.hit,), R, torch.bool, dev)
    _build.check_planes(("surf.mat",), (surf.mat,), R, torch.int32, dev)
    if time is not None:
        _build.check_planes(("time",), (time,), R, torch.float32, dev)
    rows = [u_media[m] for m in range(C)]
    _build.check_planes([f"u_media[{m}]" for m in range(C)], rows, R, torch.float32, dev)
    base = rows[0].data_ptr()
    stride = (rows[1].data_ptr() - base) // 4 if C > 1 else 0
    if any(row.data_ptr() != base + 4 * m * stride for m, row in enumerate(rows)):
        raise ValueError("u_media: the media's uniform rows must lie at one row stride")
    tab = _build.check_table("med_rows", tables.med_rows, MED_ROW, dev)
    out = torch.empty((9, R), dtype=torch.float32, device=dev)
    hit = torch.empty(R, dtype=torch.bool, device=dev)
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    rc = _build.library().art_media(
        tab.data_ptr(), C, R, float(t_min), stride,
        _build.pointers((*planes[:6], time, *planes[6:], surf.hit, surf.mat, rows[0], out,
                         hit, mat)),
        _build.stream_handle(dev))
    _build.check(rc, MEDIA)
    _build.launch(MEDIA)
    t, px, py, pz, nx, ny, nz, u, v = out.unbind(0)
    return HitRecordP(hit=hit, t=t, p=(px, py, pz), normal=(nx, ny, nz), u=u, v=v, mat=mat)
