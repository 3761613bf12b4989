"""Command-line renderer (port of ``art_tpu/cli.py``).

Same flags and I/O contract — PPM P3 on stdout, diagnostics on stderr — so
``python -m art_tpu_torch.cli --scene bouncing_spheres > out.ppm`` behaves
like the reference binary; ``--device`` picks the card (default) or the
CPU.  ``--checkpoint PATH`` saves the render after every (tile, chunk)
dispatch and resumes a matching file (``render_scene``'s
``checkpoint_path``).

``--sharded`` renders across devices (``parallel.render_scene_sharded``),
one process a rank, on a ``(world, 1)`` mesh.  Under a launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them) the process joins that world,
on ``cuda:LOCAL_RANK`` or the CPU; otherwise the CLI starts one rank per
visible card itself (``parallel.spawn_ranks``), or one rank with
``--device cpu``.  The backend is NCCL on the card and gloo on the CPU;
rank 0 alone writes the outputs.

``--trace PATH`` keeps every span of the program's recorder
(``utils/tracing.py``) and profiles the device alone (no host operators)
over iterations 20-219 of the first dispatch; it writes the spans and that
stretch's device activity as one Chrome trace on one clock to ``PATH``
and prints the device's idle seconds by the host layer open in each gap
(``tracing.idle_by_span``).  ``ART_TPU_TRACE=PATH`` keeps and writes the
spans alone, at exit, in any process.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="art-render-torch", description="wavefront path tracer (PyTorch/CUDA)")
    parser.add_argument("--scene", default="three_spheres")
    parser.add_argument("--list-scenes", action="store_true")
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--spp", type=int, default=None)
    parser.add_argument("--max-depth", type=int, default=50)
    parser.add_argument("--gamma", type=float, default=2.2)
    parser.add_argument("--seed", type=int, default=1984)
    parser.add_argument("--out", default="-", help="output path ('-' = stdout)")
    parser.add_argument("--clamp", action="store_true",
                        help="clamp PPM values to [0,255] (reference default: no clamp)")
    parser.add_argument("--png", default=None, help="also write a PNG copy to this path")
    parser.add_argument("--checkpoint", default=None,
                        help="save after every dispatch to this .npz path and resume "
                             "from it")
    parser.add_argument("--sharded", action="store_true",
                        help="render across all visible devices (one process a rank; "
                             "joins a torchrun world when launched by one)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write the program's spans and a profiled stretch of the "
                             "device as a Chrome trace to PATH, and print idle seconds "
                             "by layer")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    from art_tpu_torch.models import SCENES

    if args.list_scenes:
        print("\n".join(sorted(SCENES)))
        return 0
    if args.scene not in SCENES:
        print(f"error: unknown scene {args.scene!r}; use --list-scenes",
              file=sys.stderr)
        return 2
    for flag, val in (("--nx", args.nx), ("--ny", args.ny), ("--spp", args.spp)):
        if val is not None and val <= 0:
            print(f"error: {flag} must be a positive integer", file=sys.stderr)
            return 2

    if args.trace and args.sharded:
        print("error: --trace traces one process; use ART_TPU_TRACE=PATH for the ranks "
              "of --sharded", file=sys.stderr)
        return 2

    if not args.sharded:
        from art_tpu_torch.render.renderer import render_scene

        stretch = _start_trace(args) if args.trace else None
        scene, cfg = _scene_cfg(args)
        print(f"Rendering {args.scene} at {cfg.nx}x{cfg.ny} spp={cfg.spp} "
              f"depth={cfg.max_depth} on {args.device}", file=sys.stderr)
        fb, stats = render_scene(scene, cfg, verbose=args.verbose,
                                 checkpoint_path=args.checkpoint, device=args.device)
        print(f"took {stats['seconds']:.3f} seconds. {stats['mrays_per_sec']:.2f} "
              f"Mrays/s on {stats['device']}", file=sys.stderr)
        if args.trace:
            _write_trace(args.trace, stretch)
        _write(args, fb)
        return 0
    from art_tpu_torch.parallel.sharding import TIMEOUT_S, spawn_ranks

    backend = "nccl" if args.device == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # a launcher's rank
        import torch.distributed as dist

        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            fb = _sharded_rank(dist.get_rank(), dist.get_world_size(), args)
        finally:
            dist.destroy_process_group()
    else:
        if args.device == "cpu":
            world = 1
        else:
            import torch

            world = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if world == 0:
                raise RuntimeError("--sharded --device cuda: no visible CUDA device")
        fb = spawn_ranks(_sharded_rank, world, (args,), backend=backend)[0]
    if fb is not None:
        _write(args, fb)
    return 0


def _start_trace(args):
    """Turn the recorder on; on the card, arm a profiled stretch of the first
    dispatch (``tracing.ProfiledStretch``) and return it."""
    from art_tpu_torch.utils import tracing

    tracing.enable()
    if args.device != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return None  # render_scene raises
    stretch = tracing.ProfiledStretch()
    stretch.arm()
    return stretch


def _write_trace(path: str, stretch) -> None:
    """Export the spans and the stretch's device activity to ``path`` and
    print the idle seconds by layer."""
    from art_tpu_torch.utils import tracing

    device = []
    if stretch is not None:
        stretch.stop()
        device = stretch.intervals()
    tracing.export(path, device)
    print(f"trace: {len(tracing.spans())} spans and {len(device)} device events to {path}",
          file=sys.stderr)
    if device:
        busy = sum(e - s for s, e, _ in device) * 1e-9
        idle = tracing.idle_by_span(device)
        print(f"profiled stretch: {(device[-1][1] - device[0][0]) * 1e-9:.4f} s, device "
              f"busy {busy:.4f} s; idle s by layer: "
              + " ".join(f"{k} {v:.4f}" for k, v in idle.items()), file=sys.stderr)


def _scene_cfg(args):
    """The scene and the RenderConfig that ``args`` ask for."""
    from art_tpu_torch.models import build_scene, scene_defaults
    from art_tpu_torch.render.renderer import RenderConfig

    defaults = scene_defaults(args.scene)
    nx = args.nx if args.nx is not None else defaults["nx"]
    ny = args.ny if args.ny is not None else defaults["ny"]
    spp = args.spp if args.spp is not None else defaults["spp"]
    return build_scene(args.scene, nx, ny), RenderConfig(
        nx=nx, ny=ny, spp=spp, max_depth=args.max_depth, gamma=args.gamma, seed=args.seed)


def _sharded_rank(rank: int, world: int, args):
    """One rank of ``--sharded`` on a ``(world, 1)`` mesh: the image on rank
    0, None elsewhere."""
    from art_tpu_torch.parallel import make_mesh, render_scene_sharded

    scene, cfg = _scene_cfg(args)
    mesh = make_mesh(device=args.device)
    if rank == 0:
        print(f"Rendering {args.scene} at {cfg.nx}x{cfg.ny} spp={cfg.spp} "
              f"depth={cfg.max_depth} on {world} ranks ({mesh.backend})", file=sys.stderr)
    fb, stats = render_scene_sharded(scene, cfg, mesh, checkpoint_path=args.checkpoint,
                                     verbose=args.verbose)
    if rank != 0:
        return None
    print(f"took {stats['seconds']:.3f} seconds. {stats['mrays_per_sec']:.2f} "
          f"Mrays/s on {world} x {stats['device']}", file=sys.stderr)
    return fb


def _write(args, fb) -> None:
    """The PPM (and the PNG copy) of ``args``."""
    from art_tpu_torch.utils.ppm import write_ppm

    if args.out == "-":
        write_ppm(fb, sys.stdout, clamp=args.clamp)
    else:
        with open(args.out, "w") as f:
            write_ppm(fb, f, clamp=args.clamp)
    if args.png:
        import numpy as np
        from PIL import Image

        img = (np.clip(fb[::-1], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        Image.fromarray(img).save(args.png)


if __name__ == "__main__":
    raise SystemExit(main())
