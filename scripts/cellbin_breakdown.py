#!/usr/bin/env python3
"""Where K17's time goes, or K15's (its spheres, run by K17's kernel with no
head, or its boxes): the kernel on chip_smoke.py's pools, whole and with
parts of its work taken away, and how unevenly its warps share the work.

Run on a machine with a CUDA device, from the repository root:

    python3 scripts/cellbin_breakdown.py [--kernel cellbin|sphere_cluster|box_cluster]
                                         [--label NAME] [--reps N]

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
``--kernel sphere_cluster`` does the same for K15's spheres on their
cluster table (no head: ``stage_head`` stages the table and tests no
cluster).  ``--kernel box_cluster`` takes K15's boxes on phase 2g's
final_scene, box field and rotated field pools (``chip_smoke._cluster_pools``):
``full``; ``slabs`` (every cluster's box out of reach, the union box in it:
the rows staged, every cluster tested, none scanned); ``rays`` (the union
box out of reach too: no lane passes its test, so the block stages
nothing); and the rows each warp scans in the twin's order (a warp with a
lane that passes a cluster's test against the running best).  Prints one
JSON line with the card's name and power limit.
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


def box_warp_rows(tables, o, d):
    """(R / 32,) float64: the rows each warp scans in K15b's order (each
    cluster's rows for a warp with a lane whose bounded test of the union box
    and of the cluster passes against its running best)."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN, safe_dir
    from art_tpu_torch.ops.intersect import box_candidates_rows, cluster_slab

    rows, (_, segs, union) = tables.box_cl_rows, tables.box_cl_meta
    inv = tuple(1.0 / safe_dir(c) for c in d)
    t = torch.full_like(o[0], BIG)
    needy = cluster_slab(union, o, inv, T_MIN, t)
    out = torch.zeros((-(-t.shape[0] // 32),), dtype=torch.float64, device=t.device)
    for r0, r1, box in segs:
        cross = needy & cluster_slab(box, o, inv, T_MIN, t)
        pad = torch.cat([cross, cross.new_zeros((-cross.shape[0]) % 32)])
        out += pad.view(-1, 32).any(dim=1).double() * (r1 - r0)
        t_c = box_candidates_rows(rows[r0:r1], tables.has_rotated_boxes, o, d, T_MIN)[0]
        t = torch.where(cross & (t_c < t), t_c, t)
    return out


def _far(seg, first: int):
    """``seg`` with the boxes of rows ``first``.. moved out of every ray's
    reach."""
    far = seg.clone()
    far[first:, 2:5], far[first:, 5:8] = 1e6, 1e6 + 1.0
    return far


def _warp_stats(w, dev):
    import torch

    blocks = torch.cat([w, w.new_zeros((-w.shape[0]) % 8)]).view(-1, 8)
    q = torch.quantile(w, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=dev))
    return dict(mean=float(w.mean()), p50=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                max=float(w.max()),
                block_max_over_mean=float((blocks.max(dim=1).values
                                           / blocks.mean(dim=1).clamp_min(1e-9)).mean()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("cellbin", "sphere_cluster", "box_cluster"),
                    default="cellbin")
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
    out = {"label": args.label, "kernel": args.kernel}
    if args.kernel == "box_cluster":
        import dataclasses

        for name in ("final_scene", "box field", "rotated field"):
            tables, o, d, _ = cs._cluster_pools(dev)[name]
            seg = tables.box_cl_seg

            def launch(s, t=tables, o=o, d=d):
                return K.box_cluster_hit_attrs(dataclasses.replace(t, box_cl_seg=s), o, d)

            cases = {"full": lambda: launch(seg), "slabs": lambda: launch(_far(seg, 1)),
                     "rays": lambda: launch(_far(seg, 0))}
            out[name] = dict(ms={k: cs._timed_ms(fn, args.reps) for k, fn in cases.items()},
                             warp_rows=_warp_stats(box_warp_rows(tables, o, d), dev))
    for name, (tables, o, d, tm) in (cs._route_pools(dev).items()
                                     if args.kernel != "box_cluster" else ()):
        if args.kernel == "cellbin":
            kind, rows, seg, meta = (K.CELLBIN, tables.sph_cellbin_rows, tables.sph_cellbin_seg,
                                     tables.sph_cellbin_meta)
        else:
            kind, rows, seg, meta = (K.CLUSTER, tables.sph_cl_rows, tables.sph_cl_seg,
                                     tables.sph_cl_meta)
        n_head = meta[0]

        def launch(s, h, kind=kind, rows=rows, o=o, d=d, tm=tm):
            return K._culled_launch(kind, rows, s, h, o, d, tm, T_MIN)

        cases = {"full": lambda: launch(seg, n_head),
                 "slabs": lambda: launch(_far(seg, 1), n_head),
                 "stage_head": lambda: launch(_far(seg, 0), n_head),
                 "rays": lambda: launch(seg[:1].contiguous(), 0)}
        out[name] = dict(ms={k: cs._timed_ms(fn, args.reps) for k, fn in cases.items()},
                         warp_rows=_warp_stats(warp_rows((rows, meta), o, d, tm), dev))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
