"""PPM P3 output with the reference's contract (``art_tpu/utils/ppm.py:1-9``).

The image goes out as ASCII PPM, rows top-down (j = ny-1 .. 0), each channel
as ``int(255.99 * c)`` with no clamping by default (reference
src/main.cu:715-727), so emissive scenes can write values above 255.

``format_ppm`` formats with numpy alone: each channel's text and separator
comes from a table over the frame's range of values, padded with NULs to
one width, and the NULs are dropped from the joined bytes; the values past
+-65536 (a NaN or an infinite channel, a very bright emitter) are formatted
one by one.  ``format_ppm_plain`` is the Python join, byte for byte the
same text (``scripts/time_ppm.py`` times both on a 1200x800 frame; PERF.md
has the times).
"""

from __future__ import annotations

import numpy as np

SPAN = 1 << 16  # the table covers at most [-SPAN, SPAN]


def _ints(fb: np.ndarray, clamp: bool) -> np.ndarray:
    """(ny, nx, 3) int64 ``int(255.99 * c)``, clamped to [0, 255] on request."""
    vals = np.multiply(fb, 255.99, dtype=np.float64, order="C")
    if clamp:
        np.clip(vals, 0.0, 255.0, out=vals)
    # the cast truncates toward zero as int() in C++ does; NaN casts to
    # INT64_MIN as in C++
    with np.errstate(invalid="ignore"):
        return vals.astype(np.int64)


def format_ppm(fb: np.ndarray, clamp: bool = False) -> str:
    """Format a (ny, nx, 3) float framebuffer (row 0 = bottom scanline)."""
    ints = _ints(np.asarray(fb)[::-1], clamp)  # rows top-down, contiguous
    ny, nx, _ = ints.shape
    vmin, vmax = int(ints.min(initial=0)), int(ints.max(initial=255))
    lo, hi = max(vmin, -SPAN), min(vmax, SPAN)
    odd = (ints < lo) | (ints > hi) if (lo, hi) != (vmin, vmax) else None
    wide = [] if odd is None else ints[odd].tolist()
    width = max(len(str(v)) for v in (lo, hi, *wide)) + 1
    idx = ints - lo if lo else ints
    if odd is not None:
        idx = np.where(odd, 0, idx)
    # "v " for the red and green channels, "v\n" for the blue
    tok = np.take(np.array([b"%d " % v for v in range(lo, hi + 1)], f"S{width}"), idx)
    tok[..., 2] = np.take(np.array([b"%d\n" % v for v in range(lo, hi + 1)], f"S{width}"),
                          idx[..., 2])
    if odd is not None:
        last = np.nonzero(odd)[2] == 2
        tok[odd] = [b"%d%s" % (v, b"\n" if nl else b" ") for v, nl in zip(wide, last)]
    body = tok.tobytes().translate(None, b"\0").decode("ascii")
    return f"P3\n{nx} {ny}\n255\n{body}"


def format_ppm_plain(fb: np.ndarray, clamp: bool = False) -> str:
    """``format_ppm`` as a Python join (the formatter's twin)."""
    ints = _ints(fb, clamp)
    ny, nx, _ = ints.shape
    rows = ints[::-1].reshape(ny * nx, 3)
    body = "".join(f"{r} {g} {b}\n" for r, g, b in rows.tolist())
    return f"P3\n{nx} {ny}\n255\n{body}"


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
