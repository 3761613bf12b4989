"""Turbulence (K7): ``csrc/turb.cu`` and its plain twin ``perlin.turb_p``.

Replaces ``art_tpu/ops/perlin_kernel.py:turb_pallas`` (:113): the
multi-octave turbulence ``|sum_{i<depth} 0.5^i noise(2^i p)|`` over (R,)
float32 planes, with an optional (R,) int32 per-lane octave count.  The
marble formula's ``sin`` stays with the caller (``ops/texture_eval.py``),
as on the TPU.  Any R works (the TPU's ``R % 8192`` rule is its layout's).
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops import _build
from art_tpu_torch.ops.perlin import turb_p

NAME = "turb"


def turb(px, py, pz, depth: int, depth_mask: torch.Tensor | None = None) -> torch.Tensor:
    """K7: the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    dev = px.device
    if dev.type == "cpu":
        return turb_p(px, py, pz, depth, depth_mask=depth_mask)
    R = px.shape[0]
    _build.check_planes(("px", "py", "pz"), (px, py, pz), R, torch.float32, dev)
    if depth_mask is not None:
        _build.check_planes(("depth_mask",), (depth_mask,), R, torch.int32, dev)
    if not 0 <= depth <= 31:
        raise ValueError(f"depth={depth}: the turbulence kernel takes 0..31 octaves")
    out = torch.empty_like(px)
    rc = _build.library().art_turb(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(),
        None if depth_mask is None else depth_mask.data_ptr(), out.data_ptr(), R, depth,
        _build.stream_handle(dev))
    _build.check(rc, NAME)
    _build.launch(NAME)
    return out
