"""PPM P3 output with the reference's contract (``art_tpu/utils/ppm.py:1-9``).

The image goes out as ASCII PPM, rows top-down (j = ny-1 .. 0), each channel
as ``int(255.99 * c)`` with no clamping by default (reference
src/main.cu:715-727), so emissive scenes can write values above 255.
numpy only.
"""

from __future__ import annotations

import numpy as np


def format_ppm(fb: np.ndarray, clamp: bool = False) -> str:
    """Format a (ny, nx, 3) float framebuffer (row 0 = bottom scanline)."""
    fb = np.asarray(fb, np.float64)
    ny, nx, _ = fb.shape
    vals = fb * 255.99
    if clamp:
        vals = np.clip(vals, 0.0, 255.0)
    # int() in C++ truncates toward zero; NaN casts to INT64_MIN as in C++
    with np.errstate(invalid="ignore"):
        ints = np.trunc(vals).astype(np.int64)
    rows = ints[::-1].reshape(ny * nx, 3)
    body = "\n".join(f"{r} {g} {b}" for r, g, b in rows.tolist())
    return f"P3\n{nx} {ny}\n255\n{body}\n"


def write_ppm(fb: np.ndarray, stream, clamp: bool = False) -> None:
    stream.write(format_ppm(fb, clamp=clamp))


def read_ppm(text: str) -> np.ndarray:
    """Parse a P3 PPM back into a (ny, nx, 3) int array (row 0 = bottom)."""
    tokens = []
    for line in text.splitlines():
        tokens.extend(line.split("#", 1)[0].split())
    if tokens[0] != "P3":
        raise ValueError("not a P3 PPM")
    nx, ny = int(tokens[1]), int(tokens[2])
    data = np.array(tokens[4:], dtype=np.int64).reshape(ny, nx, 3)
    return data[::-1]
