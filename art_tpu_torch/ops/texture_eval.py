"""Texture evaluation over hit batches (``art_tpu/ops/texture_eval.py:68-124``).

Slice 1 evaluates the checker redirect loop and the solid leaf — every
texture bouncing_spheres and three_spheres use.  A scene whose tables hold
another texture kind raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.scene.tables import SceneTables, TexType

MAX_TEX_DEPTH = 3  # wrapper chains in the reference are depth <= 2
_PORTED = {int(TexType.SOLID), int(TexType.CHECKER)}


def eval_texture_p(tables: SceneTables, tex_id: torch.Tensor, u, v, p, valid=None):
    """Returns a 3-tuple of (R,) color planes.

    ``u``, ``v`` and ``valid`` feed leaves that later slices port (image,
    uv_offset); solid and checker ignore them."""
    del u, v, valid
    present = set(tables.tex_types_present)
    if present - _PORTED:
        names = sorted(TexType(t).name for t in present - _PORTED)
        raise NotImplementedError(
            f"texture kinds {names}: art_tpu_torch slice 1 evaluates solid "
            "and checker textures only"
        )
    tex_id = torch.clamp(tex_id, 0, tables.tex_type.shape[0] - 1)
    px, py, pz = p
    # packed row: [type, p0..p7, child0, child1, img, rgb(3), rgb2(3)]
    row = take_rows(tables.tex_packed, tex_id)
    if TexType.CHECKER in present:
        for _ in range(MAX_TEX_DEPTH):
            inv_scale = row[:, 1]
            xi = torch.floor(inv_scale * px).to(torch.int32)
            yi = torch.floor(inv_scale * py).to(torch.int32)
            zi = torch.floor(inv_scale * pz).to(torch.int32)
            is_even = ((xi + yi + zi) & 1) == 0
            child = torch.where(is_even, row[:, 9], row[:, 10]).to(torch.int32)
            is_checker = row[:, 0].to(torch.int32) == TexType.CHECKER
            tex_id = torch.where(is_checker, child, tex_id)
            row = take_rows(tables.tex_packed, tex_id)
    rgb = row[:, 12:15].T.contiguous()
    return (rgb[0], rgb[1], rgb[2])
