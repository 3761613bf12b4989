"""Texture evaluation over hit batches (``art_tpu/ops/texture_eval.py``).

The checker redirect loop, the solid leaf and the noise (marble) leaf of
``eval_texture_p`` (``:68-186``), and ``eval_special_p`` (``:239-320``) for
the baked shade mode's noise leaves.  Both reach turbulence through
``_turb``: the turbulence kernel (K7, ``ops/perlin_kernel.py``) for CUDA
tensors, its plain twin for CPU tensors or when asked for the plain path.
Image, noodle and felt textures come with M10 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.perlin import TURB_DEPTH, turb_p
from art_tpu_torch.ops.perlin_kernel import turb
from art_tpu_torch.scene.tables import SceneTables, TexType

MAX_TEX_DEPTH = 3  # wrapper chains in the reference are depth <= 2
_PORTED = {int(TexType.SOLID), int(TexType.CHECKER), int(TexType.NOISE)}
_M10 = "image, noodle and felt textures come with M10 in a later slice of art_tpu_torch"


def _turb(px, py, pz, depth: int, *, plain: bool):
    return (turb_p if plain else turb)(px, py, pz, depth)


def marble(scale, pz, tb):
    """The marble texture's value 0.5 (1 + sin(scale z + 10 turb))
    (src/texture.cuh:67-71)."""
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * tb))


def eval_texture_p(tables: SceneTables, tex_id: torch.Tensor, u, v, p, valid=None, *,
                   plain: bool = False):
    """Returns a 3-tuple of (R,) color planes.

    ``u``, ``v`` and ``valid`` feed leaves that later slices port (image,
    uv_offset); solid, checker and noise ignore them.  ``plain`` takes the
    turbulence twin on any device."""
    del u, v, valid
    present = set(tables.tex_types_present)
    if present - _PORTED:
        names = sorted(TexType(t).name for t in present - _PORTED)
        raise NotImplementedError(f"texture kinds {names}: {_M10}")
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
    out = (rgb[0], rgb[1], rgb[2])
    if TexType.NOISE in present:
        t = marble(row[:, 1], pz, _turb(px, py, pz, TURB_DEPTH, plain=plain))
        is_noise = row[:, 0].to(torch.int32) == TexType.NOISE
        out = tuple(torch.where(is_noise, t, c) for c in out)
    return out


def eval_special_p(tables: SceneTables, specials: tuple, mat: torch.Tensor, u, v, p,
                   valid=None, *, plain: bool = False):
    """Leaf colors of the baked shade mode's special materials
    (``shade_consts[1]`` rows ``(mat_id, "noise", scale)``); 0 elsewhere.

    As in ``art_tpu``, each noise material evaluates its own turbulence
    over the whole batch.  ``tables``, ``u``, ``v`` and ``valid`` feed the
    image leaf, which comes with M10."""
    del tables, u, v, valid
    px, py, pz = p
    zero = torch.zeros_like(px)
    out = (zero, zero, zero)
    for s in specials:
        if s[1] != "noise":
            raise NotImplementedError(f"special leaf {s[1]!r}: {_M10}")
        mid, _, scale = s
        t = marble(scale, pz, _turb(px, py, pz, TURB_DEPTH, plain=plain))
        out = tuple(torch.where(mat == mid, t, c) for c in out)
    return out
