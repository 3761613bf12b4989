"""One run of a benchmark cell of ``art_tpu_torch``.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name (``portbench/cells.py``).  The run clears
every ``ART_TPU_*`` switch and sets the cell's own before ``art_tpu_torch``
is imported (``ops/routes.py`` reads them once), builds the scene, moves its
tables to the card and makes one small warm-up dispatch of the cell's scene
and pool (set-up), then measures for ``--seconds`` (``portbench/drivers.py``)
and compares the window's estimate with the plain reference
(``portbench/judge.py``).  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, from spans and a profiler over
a bounded stretch of the window (``portbench/trace.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, each compared number beside its limit; the same
numbers end standard error.  Without enough cards, or where a JAX module is
loaded when the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.time()  # the process's start, as near as the harness can take it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from portbench import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "art_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``art_tpu_torch`` is not ``art_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_routes(env: dict) -> None:
    for key in [k for k in os.environ if k.startswith("ART_TPU_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in env.items()})


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", *,
            shrink: dict | None = None, fault: str | None = None,
            t_start: float = T_START) -> dict:
    """Set-up, window, metrics and comparison of one run; returns the result
    line as a dict (``checks`` last)."""
    import torch

    from portbench import drivers, faults, judge
    from portbench.trace import Stretch

    dev = torch.device(device if device == "cpu" else "cuda:0")
    metric_defs = cell.per_layer if trace else cell.end_to_end
    size = drivers.scene_size(cell, shrink)
    stretch = None
    if trace:
        spans = [s for m in metric_defs for s in getattr(cell.metric_module(m["name"]),
                                                         "SPANS", ())]
        stretch = Stretch(spans, **cell.traffic["profile"])
    with faults.planted(fault):
        w = drivers.KINDS[cell.traffic["kind"]](
            cell, seed, seconds, dev, stretch, shrink,
            want_launches=trace and dev.type == "cuda"
            and any(m["name"] == "launches_per_iter" for m in metric_defs))
    if stretch is not None:
        w.stretch = stretch.summary()
    counts = judge.reference_scene(cell, size).counts()
    values = {}
    for m in metric_defs:
        got = cell.metric_module(m["name"]).read(types.SimpleNamespace(
            window=w, stretch=w.stretch, counts=counts, setup_s=w.start_wall - t_start))
        if got is not None:
            values[m["name"]] = {"value": got, "unit": m["unit"]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = judge.judge(cell, size, w.sums, w.counts, seed, dev)
    steal = "unknown" if w.steal_s is None else f"{w.steal_s:.2f}"
    print(f"portbench: {cell.name} seed {seed}: {w.attempted} dispatches in {w.passes} passes, "
          f"{w.samples} samples in {w.seconds:.3f} s (CPU {w.cpu_s:.2f} s, steal {steal} s); "
          f"reference {time.perf_counter() - t_ref:.1f} s; each: "
          + " ".join(f"{d:.3f}" for d in w.dispatch_s), file=sys.stderr)
    if w.stretch:
        print("portbench: stretch " + json.dumps(w.stretch), file=sys.stderr)
    limits = cell.settings["limits"]
    correct = w.attempted > 0 and w.failed == 0 and judge.verdict(readings, limits)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": w.memory_peak}
    if dev.type == "cuda":
        dev_info["power_limit"] = _power_limit()
    line = {"correct": bool(correct), "attempted": w.attempted, "failed": w.failed,
            "metrics": values, "device": dev_info}
    if trace:
        dev_info["busy_s"] = w.stretch["busy_s"] if w.stretch else 0.0
        dev_info["window_s"] = w.stretch["wall_s"] if w.stretch else 0.0
        if w.stretch:
            line["breakdown"] = {"device_ops": w.stretch["device_ops"],
                                 "idle_gaps": w.stretch["idle_gaps"]}
    line["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    set_routes(cell.settings.get("env", {}))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 1
    line = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 1
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
