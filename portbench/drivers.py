"""The one traffic generator and the window it drives.

A traffic mix (``portbench/traffic/<name>.json``) names its ``kind``:

* ``job``: the configuration's published job (``nx`` x ``ny`` at ``spp``),
  planned by the program's own ``plan_batches`` into (tile, chunk)
  dispatches, run pass by pass (a pass: one chunk of every tile, chunk 0
  first) through ``render_wavefront`` with the arguments ``render_scene``
  passes it, each tile's sum copied to the host as ``render_scene`` does.

It is a closed loop with one client: the next dispatch starts when the last
has come back.  The window runs whole passes, so that every tile of the
image is in it as often as every other, and closes at the end of the pass
nearest to ``seconds`` by the mean pass so far (at least one pass); its rate
is then the job's, whatever the tiles' costs.  Every run of a seed does the
same work in the same order.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from portbench import trace as tr


@dataclasses.dataclass
class Window:
    seconds: float = 0.0  # the window's wall time
    samples: int = 0  # camera samples (pixel-samples) completed
    attempted: int = 0  # dispatches started
    failed: int = 0  # ... whose radiance came back non-finite
    rays: int = 0  # path segments traced
    iterations: int = 0  # pool iterations
    passes: int = 0  # whole passes over the tiles
    n_slots: int = 0
    start_wall: float = 0.0  # time.time() at the window's start
    cpu_s: float = 0.0  # the process's CPU time in the window
    steal_s: float | None = None  # the machine's steal time in the window, all CPUs
    dispatch_s: list = dataclasses.field(default_factory=list)  # each one's wall seconds
    memory_peak: int = 0
    launches: float | None = None
    stretch: dict | None = None
    # per pixel: summed radiance (float64) and samples, for the comparison
    sums: np.ndarray | None = None
    counts: np.ndarray | None = None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scene_size(cell, shrink: dict | None) -> dict:
    """The configuration's sizes, with a dry run's ``shrink`` applied."""
    size = {k: cell.config[k] for k in ("nx", "ny", "spp", "max_depth", "cuda_slots")}
    size.update(shrink or {})
    return size


def plan(cell, size: dict, tables, dev, spp: int):
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    rc = RenderConfig(nx=size["nx"], ny=size["ny"], spp=spp, max_depth=size["max_depth"],
                      cuda_slots=size["cuda_slots"])
    n_prims = max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1)
    return rc, plan_batches(size["nx"] * size["ny"], spp, n_prims, rc, dev)


def steal_s() -> float | None:
    """Seconds the hypervisor ran others on this machine's CPUs, summed over
    them (``/proc/stat``), or None where the file is not there."""
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def close_after(elapsed: float, passes: int, seconds: float) -> bool:
    """Whether the window closes after ``passes`` whole passes in
    ``elapsed`` seconds: at the pass end nearest to ``seconds``."""
    return elapsed + 0.5 * elapsed / passes >= seconds


def warm_up(scene, tables, size, n_slots: int, dev, seed: int) -> None:
    """One small dispatch of the cell's scene through its pool: every kernel
    of the route builds (the first run of a checkout) or loads, and runs once."""
    from art_tpu_torch.render import integrator

    P = size["nx"] * size["ny"]
    integrator.render_wavefront(
        tables, scene.camera, 0, 2, scene.background, tile_pixels=min(P, 2048),
        total_pixels=P, nx=size["nx"], ny=size["ny"], max_depth=size["max_depth"],
        gradient_bg=scene.gradient_bg, n_slots=n_slots, tile=0, chunk=0, seed=seed)
    _sync(dev)


def staged_launches(scene, tables, size, n_slots: int, dev, seed: int):
    """Launches of one staged iteration on a pool that has run 8 iterations of
    tile 0 (``launches_per_iter``)."""
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render import integrator

    P = size["nx"] * size["ny"]
    tp = min(P, 65536)
    scal = rk.RefillScal(size["spp"], tp, 0, P, size["nx"], size["ny"])
    pool = rk.new_pool(n_slots, dev)
    q = torch.zeros(2, dtype=torch.int64, device=dev)
    hist = torch.zeros(64, dtype=torch.int64, device=dev)
    fb = torch.zeros((tp, 3), dtype=torch.float32, device=dev)
    lost = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(key=(seed, 0, 0), ncols=integrator.n_uniform_cols(tables),
              max_depth=size["max_depth"], gradient=scene.gradient_bg)
    for it in range(8):
        integrator.staged_step(pool, scene.camera, q, it % 2, hist, it, scal, tables,
                               scene.background, fb, lost, **kw)
    args = (pool, scene.camera, q, 0, hist, 8, scal, tables, scene.background, fb, lost)
    return tr.step_launches(integrator.staged_step, args, kw)


def _memory_peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def run_job(cell, seed: int, seconds: float, dev, stretch=None, shrink=None,
            want_launches: bool = False) -> Window:
    """Set-up and window of a one-chip ``job`` cell."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render import integrator

    size = scene_size(cell, shrink)
    scene = build_scene(cell.config["scene"], size["nx"], size["ny"])
    tables = scene.tables.to(dev)
    _, (tile_pixels, spp_chunk, n_slots) = plan(cell, size, tables, dev, size["spp"])
    P = size["nx"] * size["ny"]
    n_tiles = -(-P // tile_pixels)
    n_chunks = -(-size["spp"] // spp_chunk)
    warm_up(scene, tables, size, n_slots, dev, seed)
    w = Window(n_slots=n_slots)
    if want_launches:
        w.launches = staged_launches(scene, tables, size, n_slots, dev, seed)
    if stretch is not None:
        stretch.install()
    w.sums = np.zeros((P, 3), np.float64)
    w.counts = np.zeros(P, np.int64)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    w.start_wall = time.time()
    steal0, cpu0 = steal_s(), time.process_time()
    t0 = time.perf_counter()
    for tile, chunk in ((t, c) for c in range(n_chunks) for t in range(n_tiles)):
        lo, hi = tile * tile_pixels, min((tile + 1) * tile_pixels, P)
        t_d = time.perf_counter()
        batch, rays, iters = integrator.render_wavefront(
            tables, scene.camera, lo, spp_chunk, scene.background, tile_pixels=tile_pixels,
            total_pixels=P, nx=size["nx"], ny=size["ny"], max_depth=size["max_depth"],
            gradient_bg=scene.gradient_bg, n_slots=n_slots, tile=tile, chunk=chunk, seed=seed)
        host = batch.cpu().numpy()[: hi - lo]
        w.dispatch_s.append(time.perf_counter() - t_d)
        w.attempted += 1
        w.failed += int(not np.isfinite(host).all())
        w.sums[lo:hi] += host
        w.counts[lo:hi] += spp_chunk
        w.samples += (hi - lo) * spp_chunk
        w.rays += rays
        w.iterations += iters
        if tile == n_tiles - 1:
            w.passes += 1
            if close_after(time.perf_counter() - t0, w.passes, seconds):
                break
    w.seconds = time.perf_counter() - t0
    w.cpu_s = time.process_time() - cpu0
    steal1 = steal_s()
    w.steal_s = None if steal0 is None or steal1 is None else steal1 - steal0
    if stretch is not None:
        stretch.stop()
        stretch.uninstall()
    w.memory_peak = _memory_peak(dev)
    return w


KINDS = {"job": run_job}
