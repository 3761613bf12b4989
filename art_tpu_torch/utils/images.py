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
does on every device.  With ``needy`` the whole fetch — texel index, texel
and unpack — is one kernel, K8's fetch form (``ops/flush_kernel.py``
``atlas_fetch``), 0 off the needy lanes.  ``art_tpu`` compacts the needy
lanes only on the TPU (``art_tpu/ops/texture_eval.py`` gates
``compact_gather`` on ``tpu_paths()``), where a gather is a one-hot MXU
product; off the TPU it gathers densely, and so does the port, whose
masked lanes load nothing.  ``ops/compact_fetch.py`` keeps the compacted
form as a port of ``art_tpu``'s, called by no render.  The texel index and
the unpack live beside the fetch kernel's wrapper and twin
(``ops/flush_kernel.py``), which take the atlas's tensors and sizes; this
module imports that one, never the other way round.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from art_tpu_torch.ops import flush_kernel as fk

TEXTURE_DIR = Path(__file__).resolve().parents[1] / "assets" / "textures"
_DECODE = "scripts/decode_textures.py"


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
        """(R,) int32 flat texel index of the nearest texel
        (``ops/flush_kernel.py texel_index``, src/texture.cuh:51-59)."""
        return fk.texel_index(self.widths, self.heights, self.hmax, self.wmax, img_id, u, v)

    def sample(self, img_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               needy: torch.Tensor | None = None, *, plain: bool = False) -> torch.Tensor:
        """(R, 3) float32 texel colors (src/texture.cuh:51-59).

        With ``needy`` (a bool mask of the lanes that want a texel) the fetch
        is K8's fetch form — exact on needy lanes, 0 elsewhere — whose (3, R)
        planes this returns transposed (``unbind(1)`` gives them back
        contiguous); ``plain`` takes its twin on any device.  Without it,
        one dense gather."""
        if needy is not None:
            fetch = fk.atlas_fetch_plain if plain else fk.atlas_fetch
            return fetch(self.data, self.widths, self.heights, self.hmax, self.wmax, img_id, u,
                         v, needy).T
        flat = torch.clamp(self.texel_index(img_id, u, v), 0, self.data.shape[0] - 1)
        return fk.unpack_rgb(self.data.index_select(0, flat)).T
