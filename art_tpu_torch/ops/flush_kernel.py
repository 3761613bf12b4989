"""Windowed scatter-add (K4) and table lookup (K8), with their plain twins.

* K4 ``flush_accumulate`` (``csrc/flush_accumulate.cu``), replacing
  ``art_tpu/ops/flush_kernel.py:flush_accumulate`` (:196): for every lane
  ``r`` with ``died[r]`` whose framebuffer row ``(pix[r] >> 7) - base``
  (a logical shift) lies in ``[0, n_hi)``,
  ``fb[row, c * 128 + pix[r] % 128] += values[c][r]`` for each of the 1 to
  6 channels; other lanes add nothing.  The TPU rounds every value to bf16
  for its one-hot MXU product; here the adds are float32, so integer
  payloads below 2^24 pass exactly.
* K8 ``table_gather_u24`` (``csrc/table_gather.cu``), replacing
  ``art_tpu/ops/flush_kernel.py:table_gather_u24`` (:147):
  ``out[i] = table[idx[i]]``, 0 where ``idx[i]`` is out of range, over an
  int32 table (the TPU's byte split for bf16 exactness is gone).
* K8's fetch form ``atlas_fetch`` (``csrc/table_gather.cu``
  ``art_atlas_fetch``), replacing the compacted image fetch of ``art_tpu``
  (``art_tpu/ops/compact_fetch.py:87`` ``compact_gather`` over
  ``flush_kernel.py:147`` and ``:196``) with ``ImageAtlas.sample``'s texel
  index and unpack: the (3, R) float32 texel planes, 0 off the needy lanes,
  in one launch.  ``art_tpu`` compacts only on the TPU (its gather is a
  one-hot MXU product there); off the TPU it gathers densely, as this does.
  Its twin's texel index and unpack (``texel_index``, ``unpack_rgb``) are
  the ones ``utils/images.py ImageAtlas`` samples with.

K8 serves the compacted fetch (``ops/compact_fetch.py``).  K4's flush form
is the scatter of the plain twin of K4's compaction form
(``compact_fetch.compact``, ``csrc/compact.cu``), which the split sphere
pass and ``compact_gather`` launch, so no render launches the flush form.
Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors; any R works (the TPU's ``R % 8192`` rule is its layout's).
"""

from __future__ import annotations

import numpy as np
import torch

from art_tpu_torch.ops import _build

FLUSH = "flush_accumulate"
GATHER = "table_gather_u24"
FETCH = "atlas_fetch"
LANES = 128  # framebuffer row width per channel (the TPU's lane count)
MAX_CHAN = 6
UNPACK_SCALE = float(np.float32(1.0 / 255.0))  # texel / 255 (src/texture.cuh:56-59)


def _check_flush(values, fb):
    if not 1 <= len(values) <= MAX_CHAN:
        raise ValueError(f"flush_accumulate takes 1..{MAX_CHAN} channels, got {len(values)}")
    if fb.dim() != 2 or fb.shape[1] != len(values) * LANES or fb.dtype != torch.float32:
        raise ValueError(f"fb: need an (n_hi, {len(values) * LANES}) float32 tensor, got "
                         f"{tuple(fb.shape)} {fb.dtype}")


def flush_accumulate_plain(pix, died, values, fb, base=None) -> torch.Tensor:
    """Plain PyTorch K4: one ``index_put_(accumulate=True)`` on ``fb``'s
    flat view, in place; returns ``fb``.  Lanes that add nothing add 0.0 to
    element 0, so nothing here reads the device."""
    _check_flush(values, fb)
    n_hi, width = fb.shape
    p = pix.to(torch.int64) & 0xFFFFFFFF  # the kernel's logical shift
    hi = p >> 7
    if base is not None:
        hi = hi - base.to(torch.int64)
    ok = died & (hi >= 0) & (hi < n_hi)
    cell = hi * width + (p & (LANES - 1))
    idx = torch.cat([torch.where(ok, cell + c * LANES, 0) for c in range(len(values))])
    vals = torch.cat([torch.where(ok, v, torch.zeros_like(v)) for v in values])
    fb.view(-1).index_put_((idx,), vals, accumulate=True)
    return fb


def flush_accumulate(pix, died, values, fb, base=None) -> torch.Tensor:
    """K4, in place on ``fb``; returns ``fb``.

    ``pix`` (R,) int32, ``died`` (R,) bool, ``values`` 1 to 6 (R,) float32
    channels, ``fb`` (n_hi, C * 128) float32, ``base`` None (row 0) or a (1,)
    int32 tensor on the same device.  The CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    dev = pix.device
    if dev.type == "cpu":
        return flush_accumulate_plain(pix, died, values, fb, base)
    _check_flush(values, fb)
    R = pix.shape[0]
    _build.check_planes(("pix",), (pix,), R, torch.int32, dev)
    _build.check_planes(("died",), (died,), R, torch.bool, dev)
    _build.check_planes([f"values[{c}]" for c in range(len(values))], values, R,
                        torch.float32, dev)
    if fb.device != dev or not fb.is_contiguous():
        raise ValueError(f"fb: need a contiguous tensor on {dev}")
    if base is not None:
        _build.check_planes(("base",), (base,), 1, torch.int32, dev)
    vals = _build.pointers(values)
    rc = _build.library().art_flush_accumulate(
        pix.data_ptr(), died.data_ptr(), vals, len(values), fb.data_ptr(), fb.shape[0],
        None if base is None else base.data_ptr(), R, _build.stream_handle(dev))
    _build.check(rc, FLUSH)
    _build.launch(FLUSH)
    return fb


def table_gather_u24_plain(table, idx) -> torch.Tensor:
    """Plain PyTorch K8: ``table[idx]`` where ``0 <= idx < T``, else 0."""
    T = table.shape[0]
    if T == 0:
        return torch.zeros_like(idx)
    in_range = (idx >= 0) & (idx < T)
    return torch.where(in_range, table.index_select(0, idx.clamp(0, T - 1)), 0)


def table_gather_u24(table, idx) -> torch.Tensor:
    """K8 -> (R,) int32, from a (T,) int32 ``table`` and (R,) int32 ``idx``.
    The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    dev = idx.device
    if dev.type == "cpu":
        return table_gather_u24_plain(table, idx)
    R, T = idx.shape[0], table.shape[0]
    _build.check_planes(("idx",), (idx,), R, torch.int32, dev)
    _build.check_planes(("table",), (table,), T, torch.int32, dev)
    out = torch.empty_like(idx)
    rc = _build.library().art_table_gather(table.data_ptr(), T, idx.data_ptr(),
                                           out.data_ptr(), R, _build.stream_handle(dev))
    _build.check(rc, GATHER)
    _build.launch(GATHER)
    return out


def texel_index(widths, heights, hmax: int, wmax: int, img_id, u, v) -> torch.Tensor:
    """(R,) int32 flat index of the nearest texel in an image atlas of (n,)
    int32 ``widths`` and ``heights`` padded to ``hmax`` x ``wmax``:
    ``img_id`` and (u, v) clamped, ``u w`` and ``(1 - v) h`` truncated
    toward zero, the row v-flipped (src/texture.cuh:51-59)."""
    img_id = torch.clamp(img_id, 0, heights.shape[0] - 1)
    w = widths.index_select(0, img_id)
    h = heights.index_select(0, img_id)
    uu = torch.clamp(u, 0.0, 1.0)
    vv = torch.clamp(v, 0.0, 1.0)
    i = torch.minimum((uu * w.to(torch.float32)).to(torch.int32), w - 1)
    j = torch.minimum(((1.0 - vv) * h.to(torch.float32)).to(torch.int32), h - 1)
    return (img_id * hmax + j) * wmax + i


def unpack_rgb(px: torch.Tensor) -> torch.Tensor:
    """(3, R) float32 channels of (R,) packed ``R | G<<8 | B<<16`` texels,
    each byte times float32(1/255)."""
    return torch.stack([((px >> s) & 0xFF).to(torch.float32) * UNPACK_SCALE
                        for s in (0, 8, 16)])


def atlas_fetch_plain(data, widths, heights, hmax: int, wmax: int, img_id, u, v,
                      needy) -> torch.Tensor:
    """Plain PyTorch K8 fetch form: ``texel_index``, then
    ``where(needy, data.index_select(0, clamp(flat, 0, T - 1)), 0)``, then
    ``unpack_rgb``; (3, R) float32."""
    flat = texel_index(widths, heights, hmax, wmax, img_id, u, v)
    px = torch.where(needy, data.index_select(0, flat.clamp(0, data.shape[0] - 1)), 0)
    return unpack_rgb(px)


def atlas_fetch(data, widths, heights, hmax: int, wmax: int, img_id, u, v,
                needy) -> torch.Tensor:
    """K8's fetch form -> (3, R) float32 texel planes of an image atlas
    ((T,) int32 packed texels ``data``, (n,) int32 ``widths`` and
    ``heights``, padded to ``hmax`` x ``wmax``) at (R,) int32 ``img_id``,
    (R,) float32 ``u`` and ``v``; 0 where the (R,) bool ``needy`` is False.
    The CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    dev = u.device
    if dev.type == "cpu":
        return atlas_fetch_plain(data, widths, heights, hmax, wmax, img_id, u, v, needy)
    R, n, T = u.shape[0], heights.shape[0], data.shape[0]
    _build.check_planes(("img_id",), (img_id,), R, torch.int32, dev)
    _build.check_planes(("u", "v"), (u, v), R, torch.float32, dev)
    _build.check_planes(("needy",), (needy,), R, torch.bool, dev)
    _build.check_planes(("widths", "heights"), (widths, heights), n, torch.int32, dev)
    _build.check_planes(("data",), (data,), T, torch.int32, dev)
    out = torch.empty((3, R), dtype=torch.float32, device=dev)
    rc = _build.library().art_atlas_fetch(
        data.data_ptr(), T, widths.data_ptr(), heights.data_ptr(), n, hmax, wmax,
        img_id.data_ptr(), u.data_ptr(), v.data_ptr(), needy.data_ptr(), out.data_ptr(), R,
        _build.stream_handle(dev))
    _build.check(rc, FETCH)
    _build.launch(FETCH)
    return out
