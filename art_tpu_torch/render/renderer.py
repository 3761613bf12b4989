"""Renderer: tiling, queue batching, gamma (``art_tpu/render/renderer.py``).

Each (pixel tile x sample chunk) dispatch renders its queue through the
persistent wavefront pool of ``render/integrator.py``.  On the CPU the pool
is sized exactly as ``art_tpu``'s CPU path (``renderer.py:61-63,90-91``), so
a CPU render of this package uses the same R, tiles and chunks as
``art_tpu``'s CPU render.  On CUDA the pool starts from ``cuda_slots`` =
2^17 (as the TPU's ``tpu_slots``) and is a multiple of the kernels' 256-ray
block.

With ``checkpoint_path`` the render is saved after every (tile, chunk)
dispatch and a matching render resumes after the last one saved
(``art_tpu/render/renderer.py:208-247``): an ``.npz`` of ``sig`` (nx, ny,
spp, max_depth, seed, tile_pixels, spp_chunk, n_slots), ``scene`` (the
scene's name, ``:``, ``scene_digest``), ``fb`` (the raw radiance sums),
``done`` (the last dispatch) and ``rays``, written to ``<path>.tmp`` and
renamed.  A dispatch draws its own streams whatever ran before it (Philox
keyed by (seed, tile) with (slot, it, chunk, k) in its counter; an injected
``uniforms`` source keyed by (tile, chunk, it)), so a resumed render is the
uninterrupted one: bit for bit with the plain twins, and on the card within
the order of the float32 atomic adds of the flush.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import time as _time
import zipfile

import numpy as np
import torch

from art_tpu_torch.ops._build import BLOCK
from art_tpu_torch.render.integrator import render_wavefront, use_short_path
from art_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    nx: int = 400
    ny: int = 225
    spp: int = 16
    max_depth: int = 50  # reference hardcodes 50 (src/main.cu:54)
    gamma: float = 2.2
    seed: int = 1984  # reference seed (src/main.cu:92)
    # CPU path: max (R x N) intersection elements per iteration
    batch_budget: int = 1 << 23
    # CUDA path: slot-pool size (rounded to the kernels' block)
    cuda_slots: int = 1 << 17
    max_slots: int = 1 << 16
    # max pixels per tile
    max_tile_pixels: int = 1 << 16
    # max queue elements (pixel-samples) per dispatch
    queue_budget: int = 1 << 25


def plan_batches(n_pixels: int, spp: int, n_prims_max: int, cfg: RenderConfig,
                 device="cpu"):
    """Choose (tile_pixels, spp_chunk, n_slots) for the wavefront pool."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        n_slots = max(BLOCK, cfg.cuda_slots // BLOCK * BLOCK)
    else:
        n_prims_max = max(n_prims_max, 1)
        n_slots = max(1024, min(cfg.max_slots, cfg.batch_budget // n_prims_max))
    tile_pixels = min(n_pixels, cfg.max_tile_pixels)
    # balance tiles (128-aligned) instead of padding the last one
    n_tiles = -(-n_pixels // tile_pixels)
    even = (n_pixels + n_tiles - 1) // n_tiles
    tile_pixels = min(tile_pixels, (even + 127) // 128 * 128)
    spp_chunk = min(spp, max(1, cfg.queue_budget // tile_pixels))
    n_chunks = -(-spp // spp_chunk)
    spp_chunk = -(-spp // n_chunks)
    # never make the pool larger than the queue
    n_q = tile_pixels * spp_chunk
    if n_slots > n_q:
        n_slots = -(-n_q // BLOCK) * BLOCK if cuda else max(256, n_q)
    return tile_pixels, spp_chunk, n_slots


def sample_counts(tile_pixels: int, spp: int, n_slots: int) -> np.ndarray:
    """Per-pixel sample count of one dispatch: the queue hands every pixel
    exactly ``spp`` samples."""
    del n_slots
    return np.full(tile_pixels, spp, np.int64)


def apply_gamma(fb: np.ndarray, gamma: float) -> np.ndarray:
    """Per-channel gamma (reference src/main.cu:37-42)."""
    if gamma == 1.0:
        return fb
    return np.power(np.maximum(fb, 0.0), 1.0 / gamma)


def _feed(h, x) -> None:
    """Add ``x`` to the sha1 ``h``: a tensor or array by its dtype, shape and
    bytes on the host, a dataclass field by field, a sequence item by item,
    anything else by its repr."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        x = np.ascontiguousarray(x)
        h.update(f"array {x.dtype.str} {x.shape}".encode())
        h.update(x.tobytes())
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            h.update(f.name.encode())
            _feed(h, getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        h.update(f"seq {len(x)}".encode())
        for item in x:
            _feed(h, item)
    else:
        h.update(f"{type(x).__name__} {x!r}".encode())


def scene_digest(scene) -> str:
    """The checkpoint's scene identity (``art_tpu``'s ``_scene_digest``
    reworked for this package's tables): sha1[:16] over every field of
    ``SceneTables`` in dataclass order (the ``ImageAtlas`` included), the
    camera, the background as float32 and the gradient flag.  A tensor adds
    its dtype, shape and bytes on the host, so a scene has one digest on
    any device."""
    h = hashlib.sha1()
    _feed(h, scene.tables)
    _feed(h, scene.camera)
    h.update(np.asarray(scene.background, np.float32).tobytes())
    h.update(bytes([int(bool(scene.gradient_bg))]))
    return h.hexdigest()[:16]


def save_checkpoint(path: str, sig, scene_id: str, fb, done: int, rays: float) -> None:
    """Write the checkpoint to ``path + ".tmp"``, then rename it to ``path``,
    so a kill mid-save never leaves a truncated archive at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, sig=sig, scene=scene_id, fb=fb, done=done, rays=rays)
    os.replace(tmp, path)


def load_checkpoint(path: str, sig, scene_id: str):
    """``(fb, done, rays)`` of the checkpoint at ``path`` if it matches
    ``sig`` and ``scene_id``; None for a missing, truncated, foreign or
    mismatched file (a fresh start)."""
    try:
        with np.load(path) as ck:
            if np.array_equal(ck["sig"], sig) and str(ck["scene"]) == scene_id:
                return ck["fb"], int(ck["done"]), float(ck["rays"])
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
        pass
    return None


def render_scene(scene, cfg: RenderConfig, verbose: bool = False,
                 checkpoint_path: str | None = None, *, device="cuda", uniforms=None,
                 plain: bool = False, short_path: bool | None = None):
    """Render a CompiledScene; returns (framebuffer (ny,nx,3), stats dict).

    Row 0 of the framebuffer is the bottom scanline (pixel = j*nx + i).
    ``checkpoint_path``: an ``.npz`` path (``.npz`` is added to a path
    without it); the render saves there after every (tile, chunk) dispatch
    and resumes a matching file after its last dispatch (module docstring).
    ``uniforms`` injects a ``(tile, chunk, it) -> (ncols, R)`` source (tests);
    ``None`` uses Philox seeded by ``cfg.seed``.  ``plain`` runs the plain
    PyTorch twins of the kernels (on any device).  ``short_path``: None takes
    the short path (K11) where ``art_tpu``'s gate does, False never, True
    also for dielectric scenes (``integrator.use_short_path``).  ``stats``
    holds ``layers``, the recorder's sums over this render's dispatches
    (``utils/tracing.summary``: self ms an iteration by layer, host reads
    and their wait, launches by layer and kernel)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False")
    tables = scene.tables.to(device)
    short = use_short_path(tables, short_path)
    n_pixels = cfg.nx * cfg.ny
    n_prims_max = max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1)
    tile_pixels, spp_chunk, n_slots = plan_batches(
        n_pixels, cfg.spp, n_prims_max, cfg, device)
    n_tiles = -(-n_pixels // tile_pixels)
    n_chunks = -(-cfg.spp // spp_chunk)
    if verbose:
        print(f"render {cfg.nx}x{cfg.ny} spp={cfg.spp} depth={cfg.max_depth} "
              f"tiles={n_tiles}x{tile_pixels}px chunks={n_chunks}x{spp_chunk}spp "
              f"slots={n_slots} device={device} short_path={short}", file=sys.stderr)

    fb = np.zeros((n_pixels, 3), np.float32)
    counts_chunk = sample_counts(tile_pixels, spp_chunk, n_slots)
    total_rays = 0.0
    total_iters = 0
    records = []
    start = _time.perf_counter()

    done = -1  # the last dispatch (tile * n_chunks + chunk) completed
    if checkpoint_path:
        if not checkpoint_path.endswith(".npz"):
            checkpoint_path += ".npz"  # np.savez's name for an extension-less path
        sig = np.array([cfg.nx, cfg.ny, cfg.spp, cfg.max_depth, cfg.seed, tile_pixels,
                        spp_chunk, n_slots])
        scene_id = f"{getattr(scene, 'name', 'scene')}:{scene_digest(scene)}"
        resumed = load_checkpoint(checkpoint_path, sig, scene_id)
        if resumed is not None:
            fb, done, total_rays = resumed
            if verbose:
                print(f"resuming from checkpoint: {done + 1} dispatches done",
                      file=sys.stderr)
    for tile in range(n_tiles):
        lo = tile * tile_pixels
        hi = min(lo + tile_pixels, n_pixels)
        for chunk in range(n_chunks):
            dispatch = tile * n_chunks + chunk
            if dispatch <= done:
                continue
            batch, rays, iters = render_wavefront(
                tables, scene.camera, lo, spp_chunk, scene.background,
                tile_pixels=tile_pixels, total_pixels=n_pixels, nx=cfg.nx,
                ny=cfg.ny, max_depth=cfg.max_depth, gradient_bg=scene.gradient_bg,
                n_slots=n_slots, tile=tile, chunk=chunk, seed=cfg.seed,
                uniforms=uniforms, plain=plain, short_path=short,
            )
            records.append(tracing.last_record())
            # raw radiance sums until the final normalization
            fb[lo:hi] += batch.cpu().numpy()[: hi - lo]
            total_rays += rays
            total_iters += iters
            if checkpoint_path:
                save_checkpoint(checkpoint_path, sig, scene_id, fb, dispatch, total_rays)
    elapsed = _time.perf_counter() - start

    counts = counts_chunk[0] * n_chunks
    fb = apply_gamma(fb / counts, cfg.gamma).reshape(cfg.ny, cfg.nx, 3)
    stats = {
        "seconds": elapsed,
        "rays": float(total_rays),
        "mrays_per_sec": total_rays / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": n_chunks * spp_chunk,
        "tile_pixels": tile_pixels,
        "spp_chunk": spp_chunk,
        "n_slots": n_slots,
        "iterations": total_iters,
        "occupancy": total_rays / (total_iters * n_slots) if total_iters else 0.0,
        "short_path": short,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "layers": tracing.summary(records),
    }
    if verbose:
        print(f"took {elapsed:.3f} seconds. rays={total_rays:.3g} "
              f"({stats['mrays_per_sec']:.2f} Mrays/s)", file=sys.stderr)
        print(tracing.summary_line(stats["layers"]), file=sys.stderr)
    return fb, stats
