#!/usr/bin/env python3
"""Where K10's time goes (``csrc/box_grid.cu art_box_grid``), and K9's
machinery over K10's table as a form to compare.

Run on a machine with a CUDA device, from the repository root:

    python3 scripts/grid_breakdown.py [--label NAME] [--reps N]

On the 40x40 box field's pool one staged iteration in (R = 57,600; K10's
own path) and on final_scene's 20x20 table with its cell list dropped
(phase 2f's pool, R = 2^17) it times (CUDA events behind a device spin,
``chip_smoke._timed_ms``):

* ``full``: K10 as the renders call it;
* ``rays``: K10 at t_min = 1e30, where no ray's y window lies above t_min,
  so a block reduces the table's tops, reads its rays and writes misses and
  walks no cell;
* ``k9_form``: K9's kernel (``art_box_grid_cells``: the slabs hoisted per
  column and row where kx + kz fits its limit, two parts a block, the warp
  skip) over every cell of K10's table in row-major order
  (``ops/intersect.py grid_cells``), no cull; its form and whether it equals
  K10's twin bit for bit.  With PYTHONPATH naming a copy of the port whose
  ``kMaxSlabCols`` takes kx + kz, K9 hoists the box field's 80 columns too.

It also reports the walk's work a ray and a warp of 32 lanes: the cells
tested and the columns visited (``chip_smoke._grid_tests``), mean and 50th,
90th, 99th percentile and largest of the warps' most.  Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.append(str(ROOT))  # after PYTHONPATH: a given checkout's port comes first
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _warp_stats(per_ray) -> dict:
    import torch

    n = per_ray.shape[0] // 32 * 32
    warp = per_ray[:n].reshape(-1, 32).max(dim=1).values.double()
    q = torch.quantile(warp, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                                          device=warp.device))
    return dict(ray_mean=float(per_ray.double().mean()), warp_mean=float(warp.mean()),
                warp_p50=float(q[0]), warp_p90=float(q[1]), warp_p99=float(q[2]),
                warp_max=float(warp.max()))


def k9_form(tables, o, d, t_min):
    """K9's kernel over every cell of K10's table in row-major order."""
    import ctypes

    import torch

    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops.intersect import grid_cells

    cells = grid_cells(tables, False).contiguous()
    R = o[0].shape[0]
    t = torch.empty(R, dtype=torch.float32, device=o[0].device)
    nx, ny, nz, u, v = (torch.empty_like(t) for _ in range(5))
    mat = torch.empty(R, dtype=torch.int32, device=o[0].device)
    ptrs = _build.pointers((*o, *d, t, nx, ny, nz, u, v, mat))
    lattice = (ctypes.c_float * 4)(tables.box_grid_x0, tables.box_grid_z0, tables.box_grid_w,
                                   tables.box_grid_y0)
    rc = _build.library().art_box_grid_cells(cells.data_ptr(), cells.shape[0],
                                             tables.box_grid_kx, tables.box_grid_kz, lattice,
                                             R, float(t_min), ptrs,
                                             _build.stream_handle(o[0].device))
    _build.check(rc, "box_grid_cells")
    return t, (nx, ny, nz), u, v, mat


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    cs = _chip_smoke()
    import torch

    import art_tpu_torch
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import intersect_kernels as K

    if not torch.cuda.is_available():
        print("grid_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {"label": args.label, "package": str(Path(art_tpu_torch.__file__).parent),
           "pools": {}}
    field = cs._box_field(160, 90).to(dev)
    pool = cs._staged_pool(field, 160, 90, 4, dev, 1)["pool"]
    ft, fo, fd, _ = cs._route_pools(dev)["final_scene"]
    pools = {"box field": (field.tables, (pool["ox"], pool["oy"], pool["oz"]),
                           (pool["dx"], pool["dy"], pool["dz"])),
             "final_scene table": (dataclasses.replace(ft, box_grid_cells=None,
                                                       box_grid_cell_rows=None), fo, fd)}
    for name, (t, o, d) in pools.items():
        want = K.box_grid_hit_attrs_plain(t, o, d, T_MIN)
        k9 = k9_form(t, o, d, T_MIN)
        torch.cuda.synchronize()
        out["pools"][name] = dict(
            R=o[0].shape[0], cells=t.box_grid_kx * t.box_grid_kz,
            full_ms=cs._timed_ms(lambda: K.box_grid_hit_attrs(t, o, d, T_MIN), args.reps),
            rays_ms=cs._timed_ms(lambda: K.box_grid_hit_attrs(t, o, d, 1e30), args.reps),
            k9_form_ms=cs._timed_ms(lambda: k9_form(t, o, d, T_MIN), args.reps),
            k9_form=("hoisted" if _k9_hoisted(t) else "per-cell"),
            k9_form_differ=cs._equal(k9, want),
            tests=_warp_stats(cs._grid_tests(t, o, d)),
            columns=_warp_stats(cs._grid_tests(t, o, d, columns=True)))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


def _k9_hoisted(tables) -> bool:
    from art_tpu_torch.ops import _build

    return bool(_build.library().art_box_grid_cells_form(tables.box_grid_kx,
                                                         tables.box_grid_kz))


if __name__ == "__main__":
    sys.exit(main())
