#!/usr/bin/env python3
"""Where K17's time goes: its launch on chip_smoke.py's bouncing_spheres and
final_scene pools, whole and with parts of its work taken away, and how
unevenly its warps share the work.

Run on a machine with a CUDA device, from the repository root:

    python3 scripts/cellbin_breakdown.py [--label NAME] [--reps N]

On phase 2f's pools (20 staged iterations in, R = 2^17) it times (CUDA
events behind a device spin, chip_smoke._timed_ms) the cell-bin kernel
(``intersect_kernels._culled_launch``) on the scene's table (``full``) and
on altered metadata: every cell's box moved out of every ray's reach, so a
lane that passes the union box's gate tests every cell's slab and scans
none (``slabs``); the union box moved out of reach too, so the block stages
the table and scans the head and no lane tests a cell (``stage_head``); no
cell and no head, so the rays are read and the misses written
(``rays``).  It also walks the twin's order (``culled_plain``'s admission)
and reports the rows each warp of 32 lanes scans: mean, 50th, 90th and
99th percentile, largest, and a block's (8 warps') largest over its mean.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def warp_rows(rows_meta, o, d, tm):
    """(R / 32,) float64: the rows each warp scans in K17's order (the head
    for a warp with a live lane, each cell's rows for a warp with a lane
    that crosses it at t_near <= its running best)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import slab_interval

    rows, (n_head, segs, box) = rows_meta
    t = K.sphere_hit_attrs_plain(None, o, d, tm, T_MIN, rows=rows[:n_head])[0]
    ok, t_near = slab_interval(box, o, d, T_MIN)
    needy = ok & (t_near <= t)
    out = torch.full((t.shape[0] // 32,), float(n_head), dtype=torch.float64, device=t.device)
    for r0, r1, seg_box in segs:
        ok, t_near = slab_interval(seg_box, o, d, T_MIN)
        cross = needy & ok & (t_near <= t)
        out += cross.view(-1, 32).any(dim=1).double() * (r1 - r0)
        t_s = K.sphere_hit_attrs_plain(None, o, d, tm, T_MIN, rows=rows[r0:r1])[0]
        t = torch.where(cross & (t_s < t), t_s, t)
    return out


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
    from art_tpu_torch.ops import intersect_kernels as K

    if not torch.cuda.is_available():
        print("cellbin_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {"label": args.label}
    for name, (tables, o, d, tm) in cs._route_pools(dev).items():
        rows, seg, n_head = tables.sph_cellbin_rows, tables.sph_cellbin_seg, \
            tables.sph_cellbin_meta[0]
        cells_far, all_far = seg.clone(), seg.clone()
        cells_far[1:, 2:5], cells_far[1:, 5:8] = 1e6, 1e6 + 1.0
        all_far[:, 2:5], all_far[:, 5:8] = 1e6, 1e6 + 1.0

        def launch(s, h):
            return K._culled_launch(K.CELLBIN, rows, s, h, o, d, tm, T_MIN)

        cases = {"full": lambda: launch(seg, n_head),
                 "slabs": lambda: launch(cells_far, n_head),
                 "stage_head": lambda: launch(all_far, n_head),
                 "rays": lambda: launch(seg[:1].contiguous(), 0)}
        w = warp_rows((rows, tables.sph_cellbin_meta), o, d, tm)
        blocks = w.view(-1, 8)
        q = torch.quantile(w, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=dev))
        out[name] = dict(
            ms={k: cs._timed_ms(fn, args.reps) for k, fn in cases.items()},
            warp_rows=dict(mean=float(w.mean()), p50=float(q[0]), p90=float(q[1]),
                           p99=float(q[2]), max=float(w.max()),
                           block_max_over_mean=float(
                               (blocks.max(dim=1).values / blocks.mean(dim=1)).mean())))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
