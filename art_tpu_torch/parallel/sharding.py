"""Multi-device rendering over ``torch.distributed`` (port of
``art_tpu/parallel/sharding.py``).

``art_tpu`` renders on a ``Mesh(('px', 'spp'))`` of devices from one
program: pixels are sharded over ``px``, and each ``spp`` shard renders its
own sample chunk of the same pixels, the partial sums combined by one
``psum``.  The port runs PyTorch's way: one process per device, joined in a
``torch.distributed`` process group (NCCL for CUDA tensors, gloo for the
CPU), each process a rank of the mesh.

* ``make_mesh`` lays the ranks of the group out as the ('px', 'spp') mesh:
  rank r sits at ``(ip, isp) = divmod(r, n_spp)``, ``art_tpu``'s
  ``np.reshape`` order.
* ``sharded_render_step`` is one (tile, chunk) dispatch: each rank renders
  its block of ``tile_pixels / n_px`` pixels with ``spp_chunk`` samples
  through ``render_wavefront``, writes it at its ``px`` offset in a
  zero-filled ``(tile_pixels, 3)`` float32 buffer, and one ``all_reduce``
  (SUM) of that buffer sums the samples over ``spp`` and puts every ``px``
  block in place (adding zeros leaves a block exact), so every rank holds
  the whole tile.  The rays are summed in int64 by a second, one-element
  ``all_reduce``.
* The streams.  ``art_tpu`` folds the shard into the key,
  ``fold(fold(fold(master, tile, chunk), ip, isp), it)``.  In the port
  ``tile`` and ``chunk`` feed only the streams (Philox keyed by
  ``(seed, tile)`` with ``chunk`` in its counter, or an injected source's
  arguments) and the pixels come from ``pix_offset``, so a shard renders
  with ``tile' = tile * n_px + ip`` and ``chunk' = chunk * n_spp + isp``:
  every (shard, dispatch) draws its own stream, and a 1x1 mesh draws
  ``render_scene``'s.  An injected ``uniforms`` source is called with
  ``(tile', chunk', it)``; ``divmod`` recovers ``(tile, ip)`` and
  ``(chunk, isp)``.
* ``render_scene_sharded`` has ``render_scene``'s output contract and
  ``art_tpu``'s arithmetic (the planner on the per-device pixels and
  samples, the global tile ``n_px`` times the per-device one, the counts and
  the gamma); every rank returns the same image.  With ``checkpoint_path``
  rank 0 reads the file and broadcasts the last dispatch done, the
  radiance sums and the rays, so every rank skips the same dispatches; rank
  0 alone saves, after each dispatch's collective.  The signature holds
  ``art_tpu``'s ten ints (``render_scene``'s eight and the mesh shape), so a
  single-device file is foreign to a sharded render and the reverse.
* ``spawn_ranks`` starts one process per rank on one machine, joined
  through a ``file://`` store in a temporary directory; the CLI's
  ``--sharded`` uses it when no launcher (``torchrun``) started the ranks.

Nothing falls back quietly: a rank that does not join, a collective that
fails and a missing device raise, and every rendezvous and collective has
a timeout (``TIMEOUT_S`` seconds; ``spawn_ranks`` takes its own).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys
import tempfile
import time as _time

import numpy as np
import torch
import torch.distributed as dist

from art_tpu_torch.render.integrator import render_wavefront, use_short_path
from art_tpu_torch.render.renderer import (
    RenderConfig,
    apply_gamma,
    load_checkpoint,
    plan_batches,
    sample_counts,
    save_checkpoint,
    scene_digest,
)
from art_tpu_torch.utils import tracing

# seconds a rendezvous, a collective or a spawned world may take
TIMEOUT_S = 600.0
COLLECTIVE = tracing.span("collective")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's view of the ('px', 'spp') mesh.

    ``rank`` is its rank in the mesh (None: a rank of the world outside a
    mesh smaller than the world), ``group`` the process group of the mesh's
    ranks (None: the default group), ``root`` the global rank of the
    mesh's rank 0, ``device`` the device this rank renders on."""

    n_px: int
    n_spp: int
    rank: int | None
    group: object
    root: int
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {"px": self.n_px, "spp": self.n_spp}

    @property
    def size(self) -> int:
        return self.n_px * self.n_spp

    @property
    def coords(self) -> tuple[int, int]:
        """``(ip, isp)`` of this rank."""
        if self.rank is None:
            raise ValueError(f"this process is outside the {self.n_px}x{self.n_spp} mesh")
        return divmod(self.rank, self.n_spp)

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the rank's card under NCCL,
        the host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` as given, with a CUDA device
    without an index (and ``None``) meaning ``cuda:LOCAL_RANK`` (the
    launcher's local rank, else the global rank).  Raises if there is no
    card or the index is at or past ``torch.cuda.device_count()``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but torch.cuda.is_available() is "
                           "False; pass device='cpu' to render on the host")
    index = dev.index
    if index is None:
        index = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                   else 0))
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise RuntimeError(f"this rank's device cuda:{index} does not exist: "
                           f"torch.cuda.device_count() is {count}")
    return torch.device("cuda", index)


def make_mesh(shape: tuple[int, int] | None = None, *, group=None, device=None) -> Mesh:
    """Build the ('px', 'spp') mesh over the ranks of the initialized
    process ``group`` (None: the default group); every rank of the world
    calls it.  The default shape is ``(world, 1)``; a shape that needs more
    ranks than the group has raises ``ValueError``; a smaller one takes the
    group's first ranks through ``dist.new_group`` and the other ranks get
    a mesh with ``rank`` None, which renders nothing.  ``device`` is this
    rank's device (``rank_device``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no initialized torch.distributed process group; "
                           "start the ranks with torchrun or spawn_ranks, or call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if shape is None:
        shape = (world, 1)
    n_px, n_spp = (int(s) for s in shape)
    if n_px < 1 or n_spp < 1:
        raise ValueError(f"mesh {tuple(shape)}: both axes need at least one device")
    n = n_px * n_spp
    if n > world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, have {world}")
    globals_ = [r if group is None else dist.get_global_rank(group, r) for r in range(n)]
    if n < world:
        group = dist.new_group(globals_)
        rank = rank if rank < n else None
    backend = str(dist.get_backend(group if rank is not None else None))
    dev = rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}; use gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(n_px, n_spp, rank, group, globals_[0], dev, backend)


def _all_reduce(mesh: Mesh, tensor: torch.Tensor) -> None:
    work = dist.all_reduce(tensor, group=mesh.group, async_op=True)
    if not work.wait(datetime.timedelta(seconds=TIMEOUT_S)):
        raise RuntimeError("all_reduce did not complete")


def sharded_render_step(mesh: Mesh, tables, cam, pix_offset: int, background, *,
                        tile_pixels: int, nx: int, ny: int, spp_chunk: int,
                        max_depth: int, gradient_bg: bool, seed: int, tile: int = 0,
                        chunk: int = 0, n_slots: int | None = None, uniforms=None,
                        plain: bool = False, short_path: bool | None = None):
    """One sharded (tile, chunk) dispatch of the ``tile_pixels`` pixels from
    ``pix_offset`` (module docstring).

    Returns ``(radiance_sum, rays, info)``: ``radiance_sum`` the
    ``(tile_pixels, 3)`` float32 host tensor summed over ``spp_chunk *
    n_spp`` samples a pixel, the same on every rank; ``rays`` the int
    count over the whole mesh; ``info`` this rank's ``iterations`` and the
    seconds of its collectives (``collective_s``, the wait for the slowest
    rank included: the recorder's ``collective`` span).  ``n_slots=None`` takes the planner's pool, as
    ``art_tpu`` does (``sharding.py:70-79``)."""
    ip, isp = mesh.coords
    if tile_pixels % mesh.n_px:
        raise ValueError(f"tile_pixels={tile_pixels} is not a multiple of the px axis "
                         f"({mesh.n_px})")
    per_px = tile_pixels // mesh.n_px
    if n_slots is None:
        n_prims = max(tables.n_spheres + tables.n_quads + tables.n_boxes, 1)
        _, _, n_slots = plan_batches(per_px, spp_chunk, n_prims,
                                     RenderConfig(nx=nx, ny=ny, spp=spp_chunk), mesh.device)
    rad, rays, iters = render_wavefront(
        tables, cam, pix_offset + ip * per_px, spp_chunk, background,
        tile_pixels=per_px, total_pixels=nx * ny, nx=nx, ny=ny, max_depth=max_depth,
        gradient_bg=gradient_bg, n_slots=n_slots, tile=tile * mesh.n_px + ip,
        chunk=chunk * mesh.n_spp + isp, seed=seed, uniforms=uniforms, plain=plain,
        short_path=short_path)
    comm = mesh.comm_device
    buf = torch.zeros((tile_pixels, 3), dtype=torch.float32, device=comm)
    buf[ip * per_px:(ip + 1) * per_px] = rad.to(comm)
    count = torch.tensor([rays], dtype=torch.int64, device=comm)
    with COLLECTIVE:
        _all_reduce(mesh, buf)
        _all_reduce(mesh, count)
        buf, rays = buf.cpu(), int(count.cpu()[0])
    return buf, rays, {"iterations": iters, "collective_s": COLLECTIVE.ns * 1e-9}


def _share_resume(mesh: Mesh, resumed, fb: np.ndarray):
    """Rank 0's ``load_checkpoint`` result ``(fb, done, rays)`` (or None)
    broadcast to every rank of the mesh."""
    comm = mesh.comm_device
    meta = torch.zeros(3, dtype=torch.float64, device=comm)  # found, done, rays
    if resumed is not None:
        meta[0], meta[1], meta[2] = 1.0, resumed[1], resumed[2]
    dist.broadcast(meta, src=mesh.root, group=mesh.group)
    found, done, rays = meta.cpu().tolist()
    if not found:
        return fb, -1, 0
    buf = (torch.from_numpy(np.ascontiguousarray(resumed[0], np.float32)).to(comm)
           if resumed is not None else torch.empty(fb.shape, dtype=torch.float32,
                                                   device=comm))
    dist.broadcast(buf, src=mesh.root, group=mesh.group)
    return buf.cpu().numpy(), int(done), int(rays)


def render_scene_sharded(scene, cfg: RenderConfig, mesh: Mesh | None = None,
                         checkpoint_path: str | None = None, *, device=None,
                         uniforms=None, plain: bool = False,
                         short_path: bool | None = None, verbose: bool = False):
    """Multi-device ``render_scene`` on ``mesh`` (default: ``make_mesh()``);
    returns ``(framebuffer (ny, nx, 3), stats)`` on every rank.

    ``device`` overrides the mesh's device for this render.
    ``checkpoint_path``, ``uniforms``, ``plain`` and ``short_path`` are
    ``render_scene``'s (module docstring for the checkpoint and the
    streams).  ``stats`` has ``art_tpu``'s keys (``seconds``, ``rays``,
    ``mrays_per_sec``, ``spp``, ``mesh``), the plan (``tile_pixels``,
    ``spp_chunk``, ``n_slots``), ``short_path``, ``device``, this rank's
    ``iterations``, and ``backend``, ``world`` (the mesh's ranks),
    ``dispatches`` (run here) and ``collective_ms`` (a dispatch's
    collectives, mean)."""
    if mesh is None:
        mesh = make_mesh(device=device)
    elif device is not None:
        mesh = dataclasses.replace(mesh, device=rank_device(device))
    if mesh.rank is None:
        raise ValueError(f"this rank is outside the {mesh.n_px}x{mesh.n_spp} mesh and "
                         "renders nothing")
    dev = mesh.device
    tables = scene.tables.to(dev)
    short = use_short_path(tables, short_path)
    n_px, n_spp = mesh.n_px, mesh.n_spp
    n_pixels = cfg.nx * cfg.ny
    n_prims_max = max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1)
    tile_pixels, spp_chunk, n_slots = plan_batches(
        -(-n_pixels // n_px), -(-cfg.spp // n_spp), n_prims_max, cfg, dev)
    tile_pixels *= n_px  # the global tile: the per-device tile on each px shard
    n_tiles = -(-n_pixels // tile_pixels)
    n_chunks = max(1, -(-cfg.spp // (spp_chunk * n_spp)))
    if verbose and mesh.rank == 0:
        print(f"render {cfg.nx}x{cfg.ny} spp={cfg.spp} mesh={n_px}x{n_spp} "
              f"({mesh.backend}) tiles={n_tiles}x{tile_pixels}px "
              f"chunks={n_chunks}x{spp_chunk}x{n_spp}spp slots={n_slots} device={dev}",
              file=sys.stderr)

    fb = np.zeros((n_pixels, 3), np.float32)
    total_rays = 0
    done = -1  # the last dispatch (tile * n_chunks + chunk) completed
    if checkpoint_path:
        if not checkpoint_path.endswith(".npz"):
            checkpoint_path += ".npz"
        sig = np.array([cfg.nx, cfg.ny, cfg.spp, cfg.max_depth, cfg.seed, tile_pixels,
                        spp_chunk, n_slots, n_px, n_spp])
        scene_id = f"{getattr(scene, 'name', 'scene')}:{scene_digest(scene)}"
        resumed = load_checkpoint(checkpoint_path, sig, scene_id) if mesh.rank == 0 else None
        fb, done, total_rays = _share_resume(mesh, resumed, fb)
        if verbose and mesh.rank == 0 and done >= 0:
            print(f"resuming from checkpoint: {done + 1} dispatches done", file=sys.stderr)
    iters, collective_s, dispatches = 0, 0.0, 0
    start = _time.perf_counter()
    for tile in range(n_tiles):
        lo = tile * tile_pixels
        hi = min(lo + tile_pixels, n_pixels)
        for chunk in range(n_chunks):
            dispatch = tile * n_chunks + chunk
            if dispatch <= done:
                continue
            rad, rays, info = sharded_render_step(
                mesh, tables, scene.camera, lo, scene.background, tile_pixels=tile_pixels,
                nx=cfg.nx, ny=cfg.ny, spp_chunk=spp_chunk, max_depth=cfg.max_depth,
                gradient_bg=scene.gradient_bg, seed=cfg.seed, tile=tile, chunk=chunk,
                n_slots=n_slots, uniforms=uniforms, plain=plain, short_path=short)
            # raw radiance sums until the final normalization
            fb[lo:hi] += rad.numpy()[: hi - lo]
            total_rays += rays
            iters += info["iterations"]
            collective_s += info["collective_s"]
            dispatches += 1
            if checkpoint_path and mesh.rank == 0:
                save_checkpoint(checkpoint_path, sig, scene_id, fb, dispatch, total_rays)
    elapsed = _time.perf_counter() - start

    actual_spp = n_chunks * spp_chunk * n_spp
    # the count as art_tpu's (an int64 array's entry, so the division and
    # the gamma run in float64 as in render_scene)
    counts = sample_counts(tile_pixels // n_px, spp_chunk, n_slots)[0] * n_spp * n_chunks
    fb = apply_gamma(fb / counts, cfg.gamma).reshape(cfg.ny, cfg.nx, 3)
    stats = {
        "seconds": elapsed,
        "rays": float(total_rays),
        "mrays_per_sec": total_rays / elapsed / 1e6 if elapsed > 0 else 0.0,
        "spp": actual_spp,
        "mesh": mesh.shape,
        "tile_pixels": tile_pixels,
        "spp_chunk": spp_chunk,
        "n_slots": n_slots,
        "iterations": iters,
        "short_path": short,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": mesh.backend,
        "world": mesh.size,
        "dispatches": dispatches,
        "collective_ms": collective_s / dispatches * 1e3 if dispatches else 0.0,
    }
    if verbose and mesh.rank == 0:
        print(f"took {elapsed:.3f} seconds. rays={total_rays:.3g} "
              f"({stats['mrays_per_sec']:.2f} Mrays/s)", file=sys.stderr)
    return fb, stats


def _rank_main(rank: int, fn, world_size: int, backend: str, store: str, out_dir: str,
               timeout_s: float, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn``, leave its result in
    ``out_dir``."""
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
    sys.stdout.flush()


def spawn_ranks(fn, world_size: int, args: tuple = (), *, backend: str = "gloo",
                timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined in one process group on ``backend``, through a ``file://`` store
    in a temporary directory; returns each rank's return value, in rank
    order.  ``fn`` must be importable (a module-level function).  A rank
    that raises or dies fails the whole world (``RuntimeError``; the other
    ranks are stopped); a world that has not ended after ``timeout``
    seconds is killed (``TimeoutError``)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with tempfile.TemporaryDirectory(prefix="art_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, os.path.join(tmp, "store"), tmp,
                              timeout, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = _time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(1.0, deadline - _time.monotonic()))):
                if _time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
        except ProcessException as exc:
            raise RuntimeError(f"a rank of the {world_size}-rank world failed: {exc}") from exc
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results
