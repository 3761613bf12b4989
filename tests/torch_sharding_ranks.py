"""The ranks of ``tests/test_torch_sharding.py``: module-level functions that
``art_tpu_torch.parallel.spawn_ranks`` runs in child processes.

This module imports neither ``jax`` nor ``art_tpu`` (a child never does):
the parent computes ``art_tpu``'s threefry blocks and hands them over in an
``.npz`` file."""

from __future__ import annotations

import shutil
import time

import numpy as np
import torch

from art_tpu_torch.models import build_scene
from art_tpu_torch.parallel import make_mesh, render_scene_sharded
from art_tpu_torch.parallel import sharding
from art_tpu_torch.render import renderer
from art_tpu_torch.render.renderer import RenderConfig

# the ranks share the test workers' cores: one intra-op thread each
torch.set_num_threads(1)


def block_key(tile: int, chunk: int, ip: int, isp: int, it: int) -> str:
    return f"{tile}_{chunk}_{ip}_{isp}_{it}"


def shard_source(path: str, n_px: int, n_spp: int):
    """An injected uniform source ``(tile', chunk', it) -> block`` reading
    the parent's threefry blocks, keyed by the ``divmod`` of the shard's
    ``tile'`` and ``chunk'``."""
    blocks = np.load(path)

    def source(tile_, chunk_, it):
        tile, ip = divmod(tile_, n_px)
        chunk, isp = divmod(chunk_, n_spp)
        return blocks[block_key(tile, chunk, ip, isp, it)]

    return source


def mesh_layouts(rank: int, world: int):
    """Coordinates of this rank on the default and on 2-D meshes, the
    errors of an oversized mesh and of a missing card, and a mesh smaller
    than the world."""
    out = {"default": (make_mesh(device="cpu").shape, make_mesh(device="cpu").coords)}
    for shape in ((2, 2), (1, 4), (4, 1)):
        out[shape] = make_mesh(shape, device="cpu").coords
    try:
        make_mesh((16, 2), device="cpu")
    except ValueError as exc:
        out["oversized"] = str(exc)
    try:
        make_mesh(device="cuda:7")
    except RuntimeError as exc:
        out["no card"] = str(exc)
    small = make_mesh((1, 2), device="cpu")
    out["small"] = small.rank
    if small.rank is not None:
        cfg = RenderConfig(nx=16, ny=8, spp=2, max_depth=3)
        out["small render"] = render_scene_sharded(build_scene("three_spheres", 16, 8), cfg,
                                                   small)[0]
    else:
        try:
            render_scene_sharded(build_scene("three_spheres", 16, 8), RenderConfig(), small)
        except ValueError as exc:
            out["small render"] = str(exc)
    return out


def render(rank: int, world: int, name: str, nx: int, ny: int, cfg: dict, shape,
           blocks: str | None = None, plain: bool = False):
    """``render_scene_sharded`` on the CPU: ``(fb, stats)``; ``blocks`` the
    parent's threefry blocks (else Philox)."""
    mesh = make_mesh(shape, device="cpu")
    source = shard_source(blocks, *shape) if blocks else None
    return render_scene_sharded(build_scene(name, nx, ny), RenderConfig(**cfg), mesh,
                                uniforms=source, plain=plain)


class _Recorder:
    """Wraps ``sharding.render_wavefront``: records each call's stream
    arguments and radiance, and raises ``Stop`` from call ``stop_after``."""

    class Stop(Exception):
        pass

    def __init__(self, module):
        self.module, self.wrapped = module, module.render_wavefront
        self.calls, self.stop_after = [], None
        module.render_wavefront = self

    def __call__(self, *a, **kw):
        if self.stop_after is not None and len(self.calls) >= self.stop_after:
            raise self.Stop()
        out = self.wrapped(*a, **kw)
        self.calls.append((kw["tile"], kw["chunk"], out[0].clone()))
        return out


def streams(rank: int, world: int, name: str, nx: int, ny: int, cfg: dict):
    """A 2x2 render's (tile', chunk') pairs on this rank, then a 1x2 render
    (the first two ranks) and this rank's partial radiance sums in it."""
    rec = _Recorder(sharding)
    scene = build_scene(name, nx, ny)
    render_scene_sharded(scene, RenderConfig(**cfg), make_mesh((2, 2), device="cpu"))
    out = {"pairs": [(t, c) for t, c, _ in rec.calls], "coords": divmod(rank, 2)}
    rec.calls = []
    mesh = make_mesh((1, 2), device="cpu")
    if mesh.rank is not None:
        fb, stats = render_scene_sharded(scene, RenderConfig(**cfg), mesh)
        out["partial"] = [r.numpy() for _, _, r in rec.calls]
        out["fb"], out["spp"] = fb, stats["spp"]
    return out


def checkpoint(rank: int, world: int, name: str, nx: int, ny: int, cfg: dict, path: str,
               stop_after: int):
    """On a 1x2 mesh: an uninterrupted render, one interrupted after
    ``stop_after`` dispatches and resumed (the dispatches each ran), a
    single-device file offered to the sharded render, and the sharded file
    offered to ``render_scene`` (rank 0)."""
    scene, cfg = build_scene(name, nx, ny), RenderConfig(**cfg)
    mesh = make_mesh((1, 2), device="cpu")
    full = render_scene_sharded(scene, cfg, mesh)
    rec = _Recorder(sharding)
    rec.stop_after = stop_after
    try:
        render_scene_sharded(scene, cfg, mesh, checkpoint_path=path + "/sharded")
        stopped = False
    except _Recorder.Stop:
        stopped = True
    first = len(rec.calls)
    rec.calls, rec.stop_after = [], None
    resumed = render_scene_sharded(scene, cfg, mesh, checkpoint_path=path + "/sharded")
    out = {"full": full, "resumed": resumed, "stopped": stopped, "first": first,
           "second": len(rec.calls)}
    if rank == 0:  # a single-device file: a fresh sharded render
        renderer.render_scene(scene, cfg, checkpoint_path=path + "/single", device="cpu")
    rec.calls = []
    out["from_single"] = render_scene_sharded(scene, cfg, mesh,
                                              checkpoint_path=path + "/single")[0]
    out["from_single_calls"] = len(rec.calls)
    if rank == 0:  # a copy of the sharded file offered to render_scene: a fresh render
        shutil.copy(path + "/sharded.npz", path + "/reverse.npz")
        single = _Recorder(renderer)
        fb, _ = renderer.render_scene(scene, cfg, checkpoint_path=path + "/reverse",
                                      device="cpu")
        out["single_calls"], out["single_fb"] = len(single.calls), fb
        renderer.render_wavefront = single.wrapped
    return out


def sleep(rank: int, world: int, seconds: float) -> None:
    """A rank that outlives its world's timeout."""
    time.sleep(seconds)
