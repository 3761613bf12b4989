"""Texture images and the image atlas (``art_tpu/utils/images.py``).

``art_tpu`` decodes its JPEG textures with PIL at scene build time.  The
port reads lossless copies instead, decoded once by
``scripts/decode_textures.py`` into ``art_tpu_torch/assets/textures/
<name>.npz``: the card's machine has no PIL, and another libjpeg build may
decode other texels.  An image given as an (H, W, 3) uint8 array is taken as
it is (``scene/builder.py``).

``ImageAtlas`` keeps ``art_tpu``'s packing — every image padded into one
flat table of ``R | G<<8 | B<<16`` texels — as int32, since PyTorch's
uint32 has almost no CUDA ops; every value is below 2^24.  ``sample`` is
nearest-texel with clamp and v-flip in ``art_tpu``'s order, in float32, and
unpacks by multiplying with float32(1/255), so it rounds as ``art_tpu``
does on every device.  With ``needy`` the texel fetch goes through the
compacted fetch (``ops/compact_fetch.py``, kernels K4 and K8).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

TEXTURE_DIR = Path(__file__).resolve().parents[1] / "assets" / "textures"
_DECODE = "scripts/decode_textures.py"
UNPACK_SCALE = float(np.float32(1.0 / 255.0))  # texel / 255 (src/texture.cuh:56-59)


def asset_path(name: str) -> Path:
    """The decoded copy of the scene asset ``name`` (e.g. ``earthmap.jpg``)."""
    return TEXTURE_DIR / f"{name}.npz"


def load_image_rgb(path) -> np.ndarray:
    """An (H, W, 3) uint8 image from a decoded copy (``asset_path``); any
    other file raises, naming the script that writes the copies."""
    path = Path(path)
    if path.suffix != ".npz" or not path.exists():
        raise FileNotFoundError(
            f"{path}: art_tpu_torch reads textures only as decoded copies "
            f"under {TEXTURE_DIR}; write them with `python3 {_DECODE}` "
            "(it decodes the scene registry's images)")
    with np.load(path) as z:
        rgb = z["rgb"]
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"{path}: need an (H, W, 3) uint8 array 'rgb', got "
                         f"{rgb.shape} {rgb.dtype}")
    return rgb


@dataclasses.dataclass(frozen=True)
class ImageAtlas:
    """Padded stack of images and per-image sizes, sampled nearest-texel."""

    data: torch.Tensor  # (n*hmax*wmax,) int32 packed RGB8
    heights: torch.Tensor  # (n,) int32
    widths: torch.Tensor  # (n,) int32
    hmax: int = 1
    wmax: int = 1

    @staticmethod
    def empty() -> "ImageAtlas":
        return ImageAtlas(data=torch.zeros(1, dtype=torch.int32),
                          heights=torch.ones(1, dtype=torch.int32),
                          widths=torch.ones(1, dtype=torch.int32))

    @staticmethod
    def pack(images: list) -> "ImageAtlas":
        if not images:
            return ImageAtlas.empty()
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        if len(images) * hmax * wmax >= 1 << 31:
            # sample() computes the flat texel index in int32
            raise ValueError(f"image atlas too large: {len(images)}x{hmax}x{wmax} texels "
                             "overflows the int32 flat index (>= 2^31)")
        data = np.zeros((len(images), hmax, wmax), np.int32)
        for i, im in enumerate(images):
            px = np.asarray(im).astype(np.int32)
            data[i, :px.shape[0], :px.shape[1]] = (
                px[:, :, 0] | (px[:, :, 1] << 8) | (px[:, :, 2] << 16))
        return ImageAtlas.from_numpy(data.reshape(-1), [im.shape[0] for im in images],
                                     [im.shape[1] for im in images], hmax, wmax)

    @staticmethod
    def from_numpy(data, heights, widths, hmax: int, wmax: int) -> "ImageAtlas":
        """An atlas from ``art_tpu``'s fields (its uint32 texels fit int32)."""
        data = np.asarray(data)
        if data.size and int(data.max()) >= 1 << 24:
            raise ValueError("atlas texels must be packed RGB8, below 2^24")
        return ImageAtlas(data=torch.from_numpy(data.astype(np.int32)),
                          heights=torch.from_numpy(np.array(heights, np.int32)),
                          widths=torch.from_numpy(np.array(widths, np.int32)),
                          hmax=int(hmax), wmax=int(wmax))

    def to(self, device) -> "ImageAtlas":
        return dataclasses.replace(self, data=self.data.to(device),
                                   heights=self.heights.to(device),
                                   widths=self.widths.to(device))

    def texel_index(self, img_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        """(R,) int32 flat texel index of the nearest texel: ``img_id`` and
        (u, v) clamped, ``u w`` and ``(1 - v) h`` truncated toward zero, the
        row v-flipped (src/texture.cuh:51-59)."""
        img_id = torch.clamp(img_id, 0, self.heights.shape[0] - 1)
        w = self.widths.index_select(0, img_id)
        h = self.heights.index_select(0, img_id)
        uu = torch.clamp(u, 0.0, 1.0)
        vv = torch.clamp(v, 0.0, 1.0)
        i = torch.minimum((uu * w.to(torch.float32)).to(torch.int32), w - 1)
        j = torch.minimum(((1.0 - vv) * h.to(torch.float32)).to(torch.int32), h - 1)
        return (img_id * self.hmax + j) * self.wmax + i

    def sample(self, img_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               needy: torch.Tensor | None = None, *, plain: bool = False) -> torch.Tensor:
        """(R, 3) float32 texel colors (src/texture.cuh:51-59).

        With ``needy`` (a bool mask of the lanes that want a texel) the
        fetch is the compacted one — exact on needy lanes, 0 elsewhere;
        ``plain`` takes its kernels' twins on any device.  Without it, one
        dense gather."""
        flat = self.texel_index(img_id, u, v)
        if needy is not None:
            from art_tpu_torch.ops.compact_fetch import compact_gather

            px = compact_gather(self.data, flat, needy, plain=plain)
        else:
            px = self.data.index_select(0, torch.clamp(flat, 0, self.data.shape[0] - 1))
        return torch.stack([((px >> s) & 0xFF).to(torch.float32) * UNPACK_SCALE
                            for s in (0, 8, 16)], dim=-1)
