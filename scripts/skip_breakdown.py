#!/usr/bin/env python3
"""Where K16's time goes: its launch on chip_smoke.py's final_scene pool,
whole and with parts of its work taken away.

Run on a machine with a CUDA device, from the repository root:

    python3 scripts/skip_breakdown.py [--label NAME] [--reps N]

On phase 2f's final_scene 800x800 @ 16 pool 20 staged iterations in (R =
2^17), it times (CUDA events behind a device spin, chip_smoke._timed_ms) the
skip kernel (``intersect_kernels._culled_launch``) as the standalone call
makes it (``full``), the tail-only call on the compacted tail slots with
n_live (``tail_only``), and the same launch with: only the head (``seg``'s
first row: ``head_only``), no head (``bins_only``), the tail's union box
moved out of every ray's reach with and without the head (``no_bin_head``,
``empty``: every bin block finds no lane and leaves), and the compacted
slots without n_live (``compacted_all_live``).  Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.append(str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as csph
    from art_tpu_torch.ops import intersect_kernels as K

    if not torch.cuda.is_available():
        print("skip_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ft, fo, fd, ftm = cs._route_pools(dev)["final_scene"]
    rows, seg, n_head = ft.sph_skip_rows, ft.sph_skip_seg, ft.sph_skip_bins[0]
    far = seg.clone()
    far[0, 2:5], far[0, 5:8] = 1e6, 1e6 + 1.0
    needy = csph.tail_box_needy(ft.sph_tail_box, fo, fd, T_MIN)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    rays = torch.stack([*fo, *fd]).index_select(1, cf.compact_ray_ids(needy))
    ko, kd, kz = tuple(rays[0:3]), tuple(rays[3:6]), torch.zeros_like(rays[0])

    def launch(*a, **kw):
        return K._culled_launch(K.SKIP, *a, **kw)

    cases = {
        "full": lambda: launch(rows, seg, n_head, fo, fd, ftm, T_MIN),
        "tail_only": lambda: launch(rows, seg, 0, ko, kd, kz, T_MIN, n_live=cnt),
        "head_only": lambda: launch(rows, seg[:1].contiguous(), n_head, fo, fd, ftm, T_MIN),
        "bins_only": lambda: launch(rows, seg, 0, fo, fd, ftm, T_MIN),
        "no_bin_head": lambda: launch(rows, far, n_head, fo, fd, ftm, T_MIN),
        "empty": lambda: launch(rows, far, 0, fo, fd, ftm, T_MIN),
        "compacted_all_live": lambda: launch(rows, seg, 0, ko, kd, kz, T_MIN)}
    out = {"label": args.label, "R": fo[0].shape[0], "needy": int(cnt),
           "ms": {name: cs._timed_ms(fn, args.reps) for name, fn in cases.items()}}
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
