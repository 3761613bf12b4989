"""Host-side cuRAND XORWOW port — exact scene-layout reproduction.

The reference seeds ONE device XORWOW state with ``curand_init(1984, 0,
0)`` (src/main.cu:89-94) and draws the bouncing-spheres grid's
materials, centers and velocities from it in a fixed order
(src/main.cu:185-222).  Reproducing the *values* (not just the
distribution) is required for pixel-statistics parity with the
reference golden (images/utk.png): every ball otherwise lands
elsewhere.

This is the documented XORWOW generator (Marsaglia, "Xorshift RNGs",
JSS 2003, sec. 3.1) with cuRAND's published initialization scramble and
output scaling (CUDA curand_kernel.h / curand_uniform.h semantics):

* ``curand_init(seed, 0, 0)``: split the 64-bit seed into two salted
  32-bit words, scale by two odd constants, and mix into the five-word
  xorshift state + Weyl counter ``d``.  Subsequence/offset skip-ahead is
  a no-op at 0 — the only form the reference uses.
* ``curand()``: one xorshift step over v[0..4] plus the Weyl increment
  362437; output ``v[4] + d``.
* ``curand_uniform()``: ``u32 * 2^-32f + 2^-33f`` evaluated in float32,
  yielding (0, 1].

Pure integer arithmetic — bit-reproducible on any host.  Layout
validation is end-to-end: tests/test_parity.py correlates the rendered
bouncing scene against the reference golden.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_2POW32_INV = np.float32(2.3283064e-10)


class XorwowState:
    """One cuRAND XORWOW stream (curand_init(seed, 0, 0) semantics)."""

    __slots__ = ("v", "d")

    def __init__(self, seed: int):
        s0 = (seed & _M32) ^ 0xAAD26B49
        s1 = ((seed >> 32) & _M32) ^ 0xF7DCEFDD
        t0 = (1099087573 * s0) & _M32
        t1 = (2591861531 * s1) & _M32
        self.d = (6615241 + t1 + t0) & _M32
        self.v = [
            (123456789 + t0) & _M32,
            (362436069 ^ t0) & _M32,
            (521288629 + t1) & _M32,
            (88675123 ^ t1) & _M32,
            (5783321 + t0) & _M32,
        ]

    def next_u32(self) -> int:
        """One curand() draw: xorshift step + Weyl counter."""
        v = self.v
        t = (v[0] ^ (v[0] >> 2)) & _M32
        v[0], v[1], v[2], v[3] = v[1], v[2], v[3], v[4]
        v[4] = ((v[4] ^ ((v[4] << 4) & _M32)) ^ (t ^ ((t << 1) & _M32))) & _M32
        self.d = (self.d + 362437) & _M32
        return (v[4] + self.d) & _M32

    def uniform(self) -> float:
        """curand_uniform(): float32 in (0, 1]."""
        x = self.next_u32()
        return float(
            np.float32(x) * _2POW32_INV + _2POW32_INV * np.float32(0.5)
        )
