"""Hash-gradient Perlin noise and turbulence of the reference repository
(slbouknight/accelerated-ray-tracer ``src/perlin.cuh``): Wang's integer hash
of a spatial lattice hash gives each lattice point a unit gradient; noise is
the smoothstep-weighted sum of the eight corners' dot products, turbulence
``|sum_i 0.5^i noise(2^i p)|``.  Written from that description; integers are
uint32 held in int64 tensors.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def wanghash(x):
    x = x & M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & M32
    return x ^ (x >> 15)


def _to_m11(h, dtype):
    """24 high bits of a hash onto [-1, 1]."""
    return ((h >> 8) & 0xFFFFFF).to(torch.float64).mul(1.0 / 8388607.5).sub(1.0).to(dtype)


def _gradient(i, j, k, dtype):
    h = wanghash(((i & M32) * 73856093 & M32) ^ ((j & M32) * 19349663 & M32)
                 ^ ((k & M32) * 83492791 & M32))
    g = torch.stack([_to_m11(h, dtype), _to_m11(wanghash(h), dtype),
                     _to_m11(wanghash(h ^ 0x9E3779B9), dtype)], dim=-1)
    return g / torch.sqrt((g * g).sum(-1, keepdim=True).clamp_min(1e-30))


def noise(p: torch.Tensor) -> torch.Tensor:
    """(n, 3) points -> (n,) gradient noise, the eight corners at once."""
    f = torch.floor(p)
    frac = p - f
    cell = f.to(torch.float64).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)
    s = frac * frac * (3.0 - 2.0 * frac)
    off = torch.tensor([[i >> 2, (i >> 1) & 1, i & 1] for i in range(8)], device=p.device)
    c = cell[:, None, :] + off  # (n, 8, 3)
    g = _gradient(c[..., 0], c[..., 1], c[..., 2], p.dtype)
    w = torch.where(off == 1, s[:, None, :], 1.0 - s[:, None, :]).prod(-1)
    return (w * (g * (frac[:, None, :] - off.to(p.dtype))).sum(-1)).sum(-1)


def turbulence(p: torch.Tensor, depth: int = 7) -> torch.Tensor:
    acc = torch.zeros_like(p[:, 0])
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise(p)
        weight *= 0.5
        p = p * 2.0
    return acc.abs()
