"""Texture evaluation over hit batches (``art_tpu/ops/texture_eval.py``).

``eval_texture_p`` (``:68-236``): the redirect loop of the wrapper
textures — checker (lattice parity) and uv_offset (rotated, clamped u/v) —
then the leaves present in the scene: solid, image (nearest texel), noise
(marble), noodle (warped stripes) and felt (mottling and fibers).
``eval_special_p`` (``:239-346``) evaluates the baked shade mode's special
leaves (image with a folded uv offset, noise, noodle, felt) by material id.

Turbulence goes through ``_turb``: the turbulence kernel (K7,
``ops/perlin_kernel.py``) for CUDA tensors, its plain twin for CPU tensors
or when asked for the plain path.  The image fetch goes through
``ImageAtlas.sample`` with the needy mask, so on CUDA tensors through one
launch of K8's fetch form (``ops/flush_kernel.py atlas_fetch``), and
through its twin on CPU tensors or with ``plain``; lanes outside the mask
read 0.  ``art_tpu`` takes its compacted fetch (``:145-153``, ``:297-306``)
only when ``tpu_paths()`` is true, and gathers densely elsewhere; the port
follows that gate: off the TPU no compaction.
Felt's mottling ``noise_p`` is plain PyTorch on every device, as in
``art_tpu`` (jnp outside any Pallas kernel).
"""

from __future__ import annotations

import torch

from art_tpu_torch.core.vecmath import device_scalar, p_where
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.perlin import TURB_DEPTH, noise_p, turb_p
from art_tpu_torch.ops.perlin_kernel import turb
from art_tpu_torch.scene.tables import SceneTables, TexType

MAX_TEX_DEPTH = 3  # wrapper chains in the reference are depth <= 2
FELT_DEPTH = 2  # felt's fiber turbulence turb(0.5 p, 2) (src/texture.cuh:131)


def _turb(px, py, pz, depth: int, depth_mask=None, *, plain: bool):
    return (turb_p if plain else turb)(px, py, pz, depth, depth_mask)


def marble(scale, pz, tb):
    """The marble texture's value 0.5 (1 + sin(scale z + 10 turb))
    (src/texture.cuh:67-71)."""
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * tb))


def _smoothstep(edge0: float, edge1: float, x):
    """Cubic Hermite smoothstep (src/texture.cuh:78-82), dividing as
    ``art_tpu`` does."""
    t = torch.clamp((x - edge0) / device_scalar(edge1 - edge0, x), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def noodle(px, py, pz, k, amp, f, direction, octaves, rgb, rgb2, *, plain: bool):
    """Warped stripes (src/texture.cuh:94-100): ``octaves`` is an int (the
    baked form, ``turb`` at that depth) or an (R,) int32 per-lane count (the
    table form, ``turb`` at depth 7 under that mask)."""
    un = px * direction[0] + py * direction[1] + pz * direction[2]
    if isinstance(octaves, int):
        wig = _turb(px * f, py * f, pz * f, min(octaves, TURB_DEPTH), plain=plain)
    else:
        wig = _turb(px * f, py * f, pz * f, TURB_DEPTH, octaves, plain=plain)
    t = _smoothstep(0.75, 0.98, torch.abs(torch.sin(k * un + amp * wig)))
    return tuple((1.0 - t) * rgb2[c] + t * rgb[c] for c in range(3))


def felt(px, py, pz, m_scale, m_amt, f_scale, f_amt, rgb, *, plain: bool):
    """Mottling and directional fibers (src/texture.cuh:122-141)."""
    m = noise_p(px * m_scale, py * m_scale, pz * m_scale)
    phase = px * f_scale + 2.0 * _turb(px * 0.5, py * 0.5, pz * 0.5, FELT_DEPTH,
                                       plain=plain)
    fibers = 0.5 * (1.0 + torch.sin(phase))
    gain = torch.clamp(1.0 + m_amt * (m - 0.5) + f_amt * (fibers - 0.5), 0.7, 1.2)
    return tuple(rgb[c] * gain for c in range(3))


def _uv_offset(u, v, du, dv):
    """The uv_offset wrapper's (u, v) (src/texture.cuh:151-164): u rotated
    and wrapped to [0, 1), v shifted and clamped."""
    uu = u + du
    return uu - torch.floor(uu), torch.clamp(v + dv, 0.0, 1.0)


def eval_texture_p(tables: SceneTables, tex_id: torch.Tensor, u, v, p, valid=None, *,
                   plain: bool = False):
    """Returns a 3-tuple of (R,) color planes.

    ``valid`` (R,) bool marks the lanes whose value is consumed: the image
    fetch skips the others (they may read 0), so dead and missed lanes that
    keep a stale image material do not count as needy.  ``plain`` takes the
    kernels' twins on any device."""
    present = set(tables.tex_types_present)
    tex_id = torch.clamp(tex_id, 0, tables.tex_type.shape[0] - 1)
    px, py, pz = p
    # packed row: [type, p0..p7, child0, child1, img, rgb(3), rgb2(3)]
    row = take_rows(tables.tex_packed, tex_id)
    if TexType.CHECKER in present or TexType.UV_OFFSET in present:
        for _ in range(MAX_TEX_DEPTH):
            ttype = row[:, 0].to(torch.int32)
            new_id = tex_id
            if TexType.CHECKER in present:
                inv_scale = row[:, 1]
                xi = torch.floor(inv_scale * px).to(torch.int32)
                yi = torch.floor(inv_scale * py).to(torch.int32)
                zi = torch.floor(inv_scale * pz).to(torch.int32)
                is_even = ((xi + yi + zi) & 1) == 0
                child = torch.where(is_even, row[:, 9], row[:, 10]).to(torch.int32)
                new_id = torch.where(ttype == TexType.CHECKER, child, new_id)
            if TexType.UV_OFFSET in present:
                is_off = ttype == TexType.UV_OFFSET
                uu, vv = _uv_offset(u, v, row[:, 1], row[:, 2])
                u, v = torch.where(is_off, uu, u), torch.where(is_off, vv, v)
                new_id = torch.where(is_off, row[:, 9].to(torch.int32), new_id)
            tex_id = new_id
            row = take_rows(tables.tex_packed, tex_id)
    ttype = row[:, 0].to(torch.int32)
    rgb = row[:, 12:15].T.contiguous()
    out = (rgb[0], rgb[1], rgb[2])  # the solid leaf
    if TexType.IMAGE in present:
        is_img = ttype == TexType.IMAGE
        needy = is_img if valid is None else is_img & valid
        img = tables.atlas.sample(row[:, 11].to(torch.int32), u, v, needy, plain=plain)
        out = p_where(is_img, img.unbind(1), out)
    if TexType.NOISE in present:
        t = marble(row[:, 1], pz, _turb(px, py, pz, TURB_DEPTH, plain=plain))
        out = p_where(ttype == TexType.NOISE, (t, t, t), out)
    if TexType.NOODLE in present:
        # params = [k, amp, f, octaves, dx, dy, dz]
        col = noodle(px, py, pz, row[:, 1], row[:, 2], row[:, 3],
                     (row[:, 5], row[:, 6], row[:, 7]), row[:, 4].to(torch.int32),
                     (row[:, 12], row[:, 13], row[:, 14]),
                     (row[:, 15], row[:, 16], row[:, 17]), plain=plain)
        out = p_where(ttype == TexType.NOODLE, col, out)
    if TexType.FELT in present:
        # params = [m_scale, m_amt, f_scale, f_amt]
        col = felt(px, py, pz, row[:, 1], row[:, 2], row[:, 3], row[:, 4],
                   (row[:, 12], row[:, 13], row[:, 14]), plain=plain)
        out = p_where(ttype == TexType.FELT, col, out)
    return out


def image_lanes(specials: tuple, mat: torch.Tensor, u, v, valid=None):
    """The image fetch's inputs of ``eval_special_p``: (R,) int32 image ids,
    u and v (each lane's folded uv offset applied) and the needy mask, the
    lanes whose material is one of ``specials``' images (and ``valid``)."""
    needy = torch.zeros_like(mat, dtype=torch.bool)
    img_id = torch.zeros_like(mat)
    uu, vv = u, v
    for mid, _, gid, du, dv in (s for s in specials if s[1] == "image"):
        m = mat == mid
        needy = needy | m
        img_id = torch.where(m, gid, img_id)
        if du or dv:  # a folded uv_offset wrapper
            uo, vo = _uv_offset(u, v, du, dv)
            uu, vv = torch.where(m, uo, uu), torch.where(m, vo, vv)
    if valid is not None:
        needy = needy & valid
    return img_id, uu, vv, needy


def eval_special_p(tables: SceneTables, specials: tuple, mat: torch.Tensor, u, v, p,
                   valid=None, *, plain: bool = False):
    """Leaf colors of the baked shade mode's special materials
    (``shade_consts[1]``: ``(mat_id, "image", img, du, dv)``,
    ``(mat_id, "noise", scale)``, ``(mat_id, "noodle", ...)`` or
    ``(mat_id, "felt", ...)``); 0 elsewhere.

    The image materials share one fetch over the lanes that hit one of them
    (and are ``valid``), the first leaf: its planes are 0 off those lanes,
    so they start ``out`` as they are; each turbulence material evaluates
    over the whole batch, as in ``art_tpu``."""
    px, py, pz = p
    if not any(s[1] == "image" for s in specials):
        zero = torch.zeros_like(px)
        out = (zero, zero, zero)
    else:
        img_id, uu, vv, needy = image_lanes(specials, mat, u, v, valid)
        out = tables.atlas.sample(img_id, uu, vv, needy, plain=plain).unbind(1)
    for s in specials:
        if s[1] == "noise":
            mid, _, scale = s
            t = marble(scale, pz, _turb(px, py, pz, TURB_DEPTH, plain=plain))
            col = (t, t, t)
        elif s[1] == "noodle":
            mid, _, k, amp, f, octaves, dx, dy, dz, rgb, rgb2 = s
            col = noodle(px, py, pz, k, amp, f, (dx, dy, dz), octaves, rgb, rgb2,
                         plain=plain)
        elif s[1] == "felt":
            mid, _, m_scale, m_amt, f_scale, f_amt, rgb = s
            col = felt(px, py, pz, m_scale, m_amt, f_scale, f_amt, rgb, plain=plain)
        else:
            continue
        out = p_where(mat == mid, col, out)
    return out
