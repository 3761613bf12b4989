"""What the program's recorder (``art_tpu_torch/utils/tracing.py``) costs.

    python3 scripts/time_tracing.py [--render SCENE [--spp N] [--reps K]]

On the host: nanoseconds a span with the recorder off and on (``begin``
and ``end`` around nothing, the best of five runs of 200,000), and a model
iteration of final_scene's staged loop as ``staged_step`` spans it (a
``loop`` span; ``refill``, then ``switch`` to ``intersect``, ``media`` and
``shade``, with ``textures`` inside ``shade``; a quarter of a ``sync``; seven
kernel launches counted: one in refill, three in intersect, two in textures,
one in shade).  With ``--render`` on a card: one dispatch of
SCENE's first tile (up to 65,536 pixels at ``--spp``) through
``render_wavefront`` on the CLI's pool, with the recorder off, on, on, off
(``--reps`` rounds), and its wall milliseconds an iteration each time,
with the nanoseconds of a step's capture check (``tracing.capturing``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from art_tpu_torch.utils import tracing  # noqa: E402

N = 200_000


def _best_ns(fn, n: int = N) -> float:
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _spans(n: int) -> None:
    begin, end, probe = tracing.begin, tracing.end, tracing.layer("probe")
    for _ in range(n):
        begin(probe)
        end()


def _empty(n: int) -> None:
    for _ in range(n):
        pass


REFILL, INTERSECT, MEDIA, TEXTURES, SHADE = map(tracing.layer, (
    "refill", "intersect", "media", "textures", "shade"))


def _iterations(n: int) -> None:
    tr = tracing
    with tr.dispatch(0, 0):
        for it in range(n):
            tr.begin_iteration(it)
            tr.begin(REFILL)
            tr.launch("refill")
            tr.switch(INTERSECT)
            tr.launch("quad_hit")
            tr.launch("box_grid")
            tr.launch("sphere_hit")
            tr.switch(MEDIA)
            tr.switch(SHADE)
            tr.begin(TEXTURES)
            tr.launch("turb")
            tr.launch("atlas_fetch")
            tr.end()
            tr.launch("shade_flush")
            tr.end()
            if it % 4 == 0:
                tr.begin_sync()
                tr.end()
            tr.end_iteration()


def host_costs() -> dict:
    out = {}
    for mode in ("off", "on"):
        tracing.reset()
        if mode == "on":
            tracing.enable()
        base = _best_ns(_empty)
        out[f"span_ns_{mode}"] = _best_ns(_spans) - base
        tracing.reset()
        if mode == "on":
            tracing.enable()
        out[f"iteration_ns_{mode}"] = _best_ns(_iterations, N // 10) - base
        tracing.disable()
        tracing.reset()
    return out


def render_costs(scene_name: str, spp: int, reps: int) -> dict:
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render import integrator

    dev = torch.device("cuda")
    scene = build_scene(scene_name)
    tables = scene.tables.to(dev)
    nx, ny = scene_defaults_of(scene_name)
    P = min(nx * ny, 65536)
    kw = dict(tile_pixels=P, total_pixels=nx * ny, nx=nx, ny=ny, max_depth=50,
              gradient_bg=scene.gradient_bg, n_slots=1 << 17, tile=0, chunk=0, seed=1)

    def one() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, iters = integrator.render_wavefront(tables, scene.camera, 0, spp,
                                                  scene.background, **kw)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / iters

    integrator.render_wavefront(tables, scene.camera, 0, 2, scene.background, **kw)
    t = tables.mat_packed
    check_ns = _best_ns(lambda n: [tracing.capturing(t) for _ in range(n)], N // 10)
    runs = {"off": [], "on": []}
    for _ in range(reps):
        for mode in ("off", "on", "on", "off"):
            tracing.reset()
            if mode == "on":
                tracing.enable()
            runs[mode].append(one())
            tracing.disable()
    return {"scene": scene_name, "spp": spp, "tile_pixels": P,
            "device": torch.cuda.get_device_name(0), "capture_check_ns": check_ns,
            "iter_ms": runs}


def scene_defaults_of(name: str):
    from art_tpu_torch.models import scene_defaults

    d = scene_defaults(name)
    return d["nx"], d["ny"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--render", default=None, metavar="SCENE")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    out = {"host": host_costs()}
    if args.render:
        out["render"] = render_costs(args.render, args.spp, args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
