"""Uniform sources for the wavefront integrator.

Each pool iteration consumes one ``(ncols, R)`` float32 block of U[0,1)
values in the column layout of ``art_tpu/render/integrator.py:43-54``
(``render/integrator.py`` here holds the column constants).  Two sources:

* **Philox** (production): Philox4x32-10 (Salmon et al., "Parallel random
  numbers: as easy as 1, 2, 3", SC 2011) keyed by ``(seed, tile)`` with the
  counter ``(slot, iteration, chunk, k)``; call ``k`` yields columns
  ``4k..4k+3``.  So no (slot, iteration, column) triple of a render is ever
  drawn twice — the rule of ``art_tpu/render/integrator.py:23-25``.  The
  refill kernel (``csrc/refill.cu``) evaluates the same function in-kernel;
  :func:`philox_block` is its plain PyTorch twin and yields the same bits.
* **Injected**: any callable ``(tile, chunk, it) -> (ncols, R)`` array.  The
  tests feed ``art_tpu``'s own threefry stream through it
  (``artrng.uniform(artrng.fold(artrng.fold(PRNGKey(seed), tile, chunk),
  it), (ncols, R))``).

A 32-bit draw ``x`` maps to ``(x >> 8) * 2^-24``, a float32 in [0, 1).
"""

from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for int64 tensors holding uint32.

    The product can reach 2^64, past int64, so ``m`` is split into 16-bit
    halves; every partial stays below 2^49."""
    t1 = x * (m & 0xFFFF)
    t2 = x * (m >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & _MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 words.

    ``ctr`` is a 4-tuple of tensors (or ints), ``key`` a 2-tuple of ints.
    Returns a 4-tuple of int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> float32 U[0,1) with 24 random bits."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def philox_block(seed: int, tile: int, chunk: int, it: int, ncols: int, n: int,
                 device) -> torch.Tensor:
    """The ``(ncols, n)`` uniform block of one pool iteration."""
    slot = torch.arange(n, dtype=torch.int64, device=device)
    key = (seed & _MASK32, tile & _MASK32)
    cols = []
    for k in range(-(-ncols // 4)):
        cols.extend(philox4x32((slot, it & _MASK32, chunk & _MASK32, k), key))
    return torch.stack([to_unit(c) for c in cols[:ncols]])
