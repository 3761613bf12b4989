"""Command-line renderer (port of ``art_tpu/cli.py``).

Same flags and I/O contract — PPM P3 on stdout, diagnostics on stderr — so
``python -m art_tpu_torch.cli --scene bouncing_spheres > out.ppm`` behaves
like the reference binary; ``--device`` picks the card (default) or the
CPU.  ``--checkpoint PATH`` saves the render after every (tile, chunk)
dispatch and resumes a matching file (``render_scene``'s
``checkpoint_path``).  ``--sharded`` (multi-device rendering) is not ported
yet.
"""

from __future__ import annotations

import argparse
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
                        help="multi-device rendering (not ported yet)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    from art_tpu_torch.models import SCENES, build_scene, scene_defaults
    from art_tpu_torch.render.renderer import RenderConfig, render_scene
    from art_tpu_torch.utils.ppm import write_ppm

    if args.list_scenes:
        print("\n".join(sorted(SCENES)))
        return 0
    if args.sharded:
        raise NotImplementedError(
            "--sharded: multi-device rendering (M14) is not ported to art_tpu_torch yet")
    if args.scene not in SCENES:
        print(f"error: unknown scene {args.scene!r}; use --list-scenes",
              file=sys.stderr)
        return 2
    for flag, val in (("--nx", args.nx), ("--ny", args.ny), ("--spp", args.spp)):
        if val is not None and val <= 0:
            print(f"error: {flag} must be a positive integer", file=sys.stderr)
            return 2

    defaults = scene_defaults(args.scene)
    nx = args.nx if args.nx is not None else defaults["nx"]
    ny = args.ny if args.ny is not None else defaults["ny"]
    spp = args.spp if args.spp is not None else defaults["spp"]
    scene = build_scene(args.scene, nx, ny)
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=args.max_depth,
                       gamma=args.gamma, seed=args.seed)
    print(f"Rendering {args.scene} at {nx}x{ny} spp={spp} depth={args.max_depth} "
          f"on {args.device}", file=sys.stderr)
    fb, stats = render_scene(scene, cfg, verbose=args.verbose,
                             checkpoint_path=args.checkpoint, device=args.device)
    print(f"took {stats['seconds']:.3f} seconds. {stats['mrays_per_sec']:.2f} "
          f"Mrays/s on {stats['device']}", file=sys.stderr)

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
