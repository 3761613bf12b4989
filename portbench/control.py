"""Readings that set the limits of the comparison (``portbench/judge.py``).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds <s> \\
        --mode program|control|unchanged|half|altered

For each seed, in one process, it runs the cell's set-up and a window of
``--seconds`` (the benchmark's own drivers) and prints one JSON line:

* ``program``: the program as the benchmark runs it, a sound reading;
* ``control``: the reference in bfloat16, the precision below the float32 the
  configuration states, put in the program's place: on the window's sampled
  pixels with as many samples each as the window gave the program, judged
  against the float32 reference as the program is;
* a fault of ``portbench/faults.py`` planted under the timed path.

The benchmark's runs never run it.  Needs a card (``--device cpu`` for a
rehearsal at ``--shrink`` sizes).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def control_readings(cell, size, w, seed: int, dev) -> dict:
    import torch

    from portbench import judge

    js = cell.settings["judge"]
    pix = judge.sample_pixels(w.counts, js["pixels"], seed)
    scene = judge.reference_scene(cell, size)
    m_r, v_r = judge.trace_pixels(scene, pix, js["ref_spp"], seed, dev)
    n_p = w.counts[pix]
    m_c = np.zeros((pix.size, 3))
    for n in np.unique(n_p):
        sel = n_p == n
        m_c[sel] = judge.trace_pixels(scene, pix[sel], int(n), seed + 1, dev,
                                      dtype=torch.bfloat16)[0][:, :3]
    return judge.compare(m_c, n_p, m_r, v_r, js["ref_spp"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shrink", default=None, help="JSON of sizes for a rehearsal")
    args = ap.parse_args(argv)
    from portbench import cells, run

    cell = cells.load_cell(args.workload)
    run.set_routes(cell.settings.get("env", {}))
    import torch

    from portbench import drivers, judge

    shrink = json.loads(args.shrink) if args.shrink else None
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.control: needs a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    size = drivers.scene_size(cell, shrink)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.mode == "control":
            w = drivers.KINDS[cell.traffic["kind"]](cell, seed, args.seconds, dev, None, shrink)
            readings = control_readings(cell, size, w, seed, dev)
            correct = judge.verdict(readings, cell.settings["limits"])
        else:
            line = run.measure(cell, seed, args.seconds, False, args.device, shrink=shrink,
                               fault=None if args.mode == "program" else args.mode, t_start=t0)
            readings = {k: v["value"] for k, v in line["checks"].items()}
            correct = line["correct"]
        print(json.dumps({"workload": cell.name, "mode": args.mode, "seed": seed,
                          "readings": readings, "correct": correct,
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
