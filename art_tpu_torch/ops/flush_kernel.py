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

Both serve the compacted image fetch (``ops/compact_fetch.py``).  Each
wrapper launches its kernel for CUDA tensors and runs its plain twin for
CPU tensors; any R works (the TPU's ``R % 8192`` rule is its layout's).
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops import _build

FLUSH = "flush_accumulate"
GATHER = "table_gather_u24"
LANES = 128  # framebuffer row width per channel (the TPU's lane count)
MAX_CHAN = 6


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
    _build.launches[FLUSH] += 1
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
    _build.launches[GATHER] += 1
    return out
