"""cuRAND's XORWOW as ``curand_init(seed, 0, 0)`` / ``curand_uniform`` define
it (Marsaglia's xorshift with a Weyl counter; cuRAND's seed scramble and
float32 output scaling).  The reference repository draws its random scenes
from one such stream seeded 1984, so the reference replays it to place the
same spheres.  A frozen copy of the published algorithm, independent of the
program's own replay.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


class Xorwow:
    def __init__(self, seed: int):
        s0 = (seed & M32) ^ 0xAAD26B49
        s1 = ((seed >> 32) & M32) ^ 0xF7DCEFDD
        t0 = (1099087573 * s0) & M32
        t1 = (2591861531 * s1) & M32
        self.d = (6615241 + t1 + t0) & M32
        self.v = [(123456789 + t0) & M32, (362436069 ^ t0) & M32, (521288629 + t1) & M32,
                  (88675123 ^ t1) & M32, (5783321 + t0) & M32]

    def u32(self) -> int:
        v = self.v
        t = v[0] ^ (v[0] >> 2)
        v[0], v[1], v[2], v[3] = v[1], v[2], v[3], v[4]
        v[4] = (v[4] ^ ((v[4] << 4) & M32)) ^ (t ^ ((t << 1) & M32))
        self.d = (self.d + 362437) & M32
        return (v[4] + self.d) & M32

    def uniform(self) -> float:
        """curand_uniform: x * 2^-32 + 2^-33, in float32, in (0, 1]."""
        scale = np.float32(2.3283064e-10)
        return float(np.float32(self.u32()) * scale + scale * np.float32(0.5))
