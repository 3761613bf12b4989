"""Decode the scene textures once into lossless copies for art_tpu_torch.

    python3 scripts/decode_textures.py [--check]

art_tpu decodes its JPEG textures with PIL at scene build time
(``art_tpu/utils/images.py:load_image_rgb``).  The port does not decode
JPEG at all: another libjpeg build can decode other texels, and a machine
without PIL could not decode them at all.  This script decodes each texture
that the scene registry uses, as ``art_tpu`` does (PIL, forced to RGB), and
writes it as an (H, W, 3) uint8 array ``rgb`` in
``art_tpu_torch/assets/textures/<name>.npz`` (``np.savez_compressed``), which
``art_tpu_torch.utils.images.load_image_rgb`` reads.  ``--check`` writes
nothing and exits 1 if a copy is missing or differs from a fresh decode.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE_DIR = REPO / "assets" / "textures"
TARGET_DIR = REPO / "art_tpu_torch" / "assets" / "textures"
# the image files named by the scene registry (art_tpu/models/scenes.py)
NAMES = ("earthmap.jpg", "poolball.jpg", "8ball.jpg")


def decode(name: str) -> np.ndarray:
    from PIL import Image

    with Image.open(SOURCE_DIR / name) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the copies with a fresh decode; write nothing")
    args = parser.parse_args(argv)
    TARGET_DIR.mkdir(parents=True, exist_ok=True)
    bad = 0
    for name in NAMES:
        rgb = decode(name)
        out = TARGET_DIR / f"{name}.npz"
        if args.check:
            same = out.exists() and np.array_equal(np.load(out)["rgb"], rgb)
            print(f"{out.relative_to(REPO)}: {'ok' if same else 'MISSING OR DIFFERENT'}")
            bad += not same
            continue
        np.savez_compressed(out, rgb=rgb)
        print(f"{out.relative_to(REPO)}: {rgb.shape[0]}x{rgb.shape[1]}, "
              f"{out.stat().st_size} bytes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
