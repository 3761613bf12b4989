#!/usr/bin/env python3
"""Time the port's PPM formatting of one frame: the Python join
(``format_ppm_plain``) against the numpy formatter (``format_ppm``), and
check that both give the same text.

Usage:  python3 scripts/time_ppm.py [nx ny [reps]]   (default 1200 800 5)

The frame is uniform in [0, 1.2) from a fixed numpy seed, so some values
pass 255 as in an emissive scene.  Prints one line per form with the seconds of
each call and their median.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from art_tpu_torch.utils import ppm  # noqa: E402


def main(argv) -> int:
    nx, ny = (int(a) for a in argv[:2]) if len(argv) >= 2 else (1200, 800)
    reps = int(argv[2]) if len(argv) > 2 else 5
    fb = np.random.default_rng(0).uniform(0.0, 1.2, (ny, nx, 3)).astype(np.float32)
    texts = {}
    for name, fn in (("python join", ppm.format_ppm_plain), ("numpy", ppm.format_ppm)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            texts[name] = fn(fb)
            times.append(time.perf_counter() - t0)
        print(f"{name:12s} {nx}x{ny}: median {statistics.median(times):.4f} s "
              f"(each {[round(t, 4) for t in times]})")
    same = texts["python join"] == texts["numpy"]
    print(f"same text: {same} ({len(texts["numpy"])} characters)")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
