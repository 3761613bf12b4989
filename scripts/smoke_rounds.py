#!/usr/bin/env python3
"""chip_smoke.py's kernel phases (2a-2i and 3) in rounds in one process,
to find checks that fail now and then: which check failed in which round.

Run on a machine with a CUDA device, from the repository root:

    python3 scripts/smoke_rounds.py [--seconds S] [--windows N]

It builds the kernels and K13's per-scene libraries (phases 1 and 1b) once,
then runs the phases in rounds until S seconds (default 480) have passed,
the results of a round shared by its phases as in chip_smoke.py.  With
``--windows N`` each round also counts the device launches of one
``ImageAtlas.sample(..., needy)`` call on phase 2d's final_scene pool N
times in each of three ways: a profiler window opened by a spin of 1000
cycles, one with spins of SPIN_CYCLES at both edges, and chip_smoke's
graph capture (``_captured_launches``); the call is one launch, so every
other reading is wrong.  The phases' log goes to stdout; one line a failed
check or a round's counts, then one JSON line (rounds, failures), to stderr.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("kernel_checks", "quad_box_checks", "turb_sp_checks", "compact_checks",
          "grid_split_checks", "cull_checks", "cluster_checks", "slice8_checks",
          "refill_scan_checks")


def _chip_smoke():
    sys.path.append(str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _results(cs) -> dict:
    return {name: {"launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
                   "bound_ms": None, "bound_by": None, "library_ms": None}
            for name in cs.KERNELS}


def _profiled_launches(fn, edge_cycles: int, close: bool) -> int:
    """Device launches of one call of ``fn`` as a profiler window reads
    them: a spin of ``edge_cycles`` before the call (and after it when
    ``close``), the spins not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(edge_cycles)
        fn()
        if close:
            torch.cuda._sleep(edge_cycles)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name)


def _windows(cs, dev, n: int) -> dict:
    """Readings of one ``sample`` call's launches that are not 1, of n a way."""
    q = cs._fetch_pools(dev)["final_scene"]
    atlas, args = q["scene"].tables.atlas, (q["img"], q["u"], q["v"], q["needy"])

    def call():
        return atlas.sample(*args)

    ways = {"profiler, 1000-cycle spin before": lambda: _profiled_launches(call, 1000, False),
            "profiler, spins at both edges": lambda: _profiled_launches(
                call, cs.SPIN_CYCLES, True),
            "graph capture": lambda: cs._captured_launches(call)}
    return {way: sum(1 for _ in range(n) if count() != 1) for way, count in ways.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=480.0)
    ap.add_argument("--windows", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("smoke_rounds: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    setup = cs.Checks()
    cs.card_info(setup, dev)
    cs.sass_report(setup, _results(cs))
    t0, rounds, fails = time.perf_counter(), 0, []
    while time.perf_counter() - t0 < args.seconds:
        rounds += 1
        results = _results(cs)
        for name in PHASES:
            checks = cs.Checks()
            checks.phase(name, getattr(cs, name), checks, dev, results)
            fails += [(rounds, name, what) for what in checks.failed]
        checks = cs.Checks()
        checks.phase("philox_checks", cs.philox_checks, checks, dev)
        fails += [(rounds, "philox_checks", what) for what in checks.failed]
        for f in fails:
            if f[0] == rounds:
                print("failed", *f, file=sys.stderr, flush=True)
        if args.windows:
            print("round", rounds, "wrong readings of", args.windows, "a way:",
                  _windows(cs, dev, args.windows), file=sys.stderr, flush=True)
    print(json.dumps({"rounds": rounds, "setup_failed": setup.failed, "fails": fails}),
          file=sys.stderr)
    return 1 if fails or setup.failed else 0


if __name__ == "__main__":
    sys.exit(main())
