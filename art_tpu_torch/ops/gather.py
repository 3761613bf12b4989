"""Per-ray table row fetch (``art_tpu/ops/gather.py:take_rows``).

``art_tpu`` fetches small tables as a one-hot MXU matmul because XLA's TPU
gather is a serial loop; on a GPU a row gather is an ordinary indexed load,
so this is ``index_select``.  Both return ``table[idx]`` exactly.
"""

from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Fetch table[idx] rows: (N, K), (R,) -> (R, K)."""
    return table.index_select(0, idx.to(torch.int64))
