"""Profile one tile of an art_tpu_torch render on the card.

    python3 scripts/profile_torch_tile.py [scene [nx ny spp [staged|short]]]

Renders the first (tile, chunk) dispatch that ``render_scene`` would make
for ``scene`` at ``nx`` x ``ny`` @ ``spp`` (default cornell_box 600x600 @ 64)
on the path ``render_scene`` picks, or on the staged or the short path
(K11) when the fifth argument asks: once to warm up, once timed without
the profiler, once under ``torch.profiler`` (CPU + CUDA activity).  Prints one JSON line: the card,
the wall seconds of both timed runs, the device busy time (the union of
the device activity intervals), the idle share of the profiled wall time,
the loop's iterations, device launches per iteration, the device time
and launch count of the top kernels, and the host (self CPU) time and call
count of the top operators.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render.integrator import render_wavefront, use_short_path
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    if not torch.cuda.is_available():
        print("profile_torch_tile: needs a CUDA device", file=sys.stderr)
        return 1
    name = sys.argv[1] if len(sys.argv) > 1 else "cornell_box"
    nx, ny, spp = (int(a) for a in sys.argv[2:5]) if len(sys.argv) > 4 else (600, 600, 64)
    short_path = {"staged": False, "short": True}[sys.argv[5]] if len(sys.argv) > 5 else None
    dev = torch.device("cuda", 0)
    scene = build_scene(name, nx, ny)
    tables = scene.tables.to(dev)
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp)
    n_prims = max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1)
    tile_pixels, spp_chunk, R = plan_batches(nx * ny, spp, n_prims, cfg, dev)

    def run():
        out = render_wavefront(
            tables, scene.camera, 0, spp_chunk, scene.background, tile_pixels=tile_pixels,
            total_pixels=nx * ny, nx=nx, ny=ny, max_depth=cfg.max_depth,
            gradient_bg=scene.gradient_bg, n_slots=R, tile=0, chunk=0, seed=cfg.seed,
            short_path=short_path)
        torch.cuda.synchronize()
        return out

    run()  # builds the kernels, warms the allocator
    t0 = time.perf_counter()
    _, rays, iters = run()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in dev_events]) / 1e3
    by_name: dict = {}
    for e in dev_events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    # one refill_apply (staged) or sp_step_kernel (short path) per iteration
    loops = sum(n for k, (_, n) in by_name.items()
                if "refill_apply" in k or "sp_step_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({
        "card": smi.stdout.strip(), "scene": f"{name} {nx}x{ny} @ {spp}",
        "short_path": use_short_path(tables, short_path),
        "tile_pixels": tile_pixels, "spp_chunk": spp_chunk, "n_slots": R,
        "rays": rays, "iterations": iters, "loop_iterations": loops,
        "wall_s": wall_plain, "wall_profiled_s": wall, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_launches": len(dev_events),
        "launches_per_iteration": len(dev_events) / max(loops, 1),
        "top": [{"name": k[:90], "ms": ms, "launches": n} for k, (ms, n) in top],
        "top_host": [{"name": a.key[:60], "self_cpu_ms": a.self_cpu_time_total / 1e3,
                      "calls": a.count} for a in host],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
