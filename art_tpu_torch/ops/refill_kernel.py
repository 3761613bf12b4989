"""Pool refill (K1): ``csrc/refill.cu`` and its plain twin.

Replaces ``art_tpu/ops/refill_kernel.py:fused_refill_rng`` and
``fused_refill`` (the refill stage of ``render_wavefront``, whose jnp form
is ``art_tpu/render/integrator.py:589-619``).  One call, for one pool
iteration ``it``:

* ranks the dead slots, hands them queue elements ``q[parity] + rank``
  (sample-major: ``p_row = q // spp``), makes their camera rays and resets
  their throughput, radiance, bounce, pix and act — in place on ``pool``;
* writes the advanced queue head to ``q[1 - parity]`` (device int64);
* adds the number of live slots after the refill to ``hist[it]``;
* returns the iteration's ball / choice / media uniform planes.

Uniforms come either from an injected ``(ncols, R)`` block (``block=``) or
from Philox keyed by ``key=(seed, tile, chunk)`` (``core/rng.py``).  The
camera's columns (4..8) feed only the slots that take a queue element;
the kernels draw or read them there alone.

The rank is one launch: a single-pass scan across the blocks by decoupled
look-back (``csrc/refill.cuh``).  Its scratch, ``scan_scratch(pool)``,
lives as long as the pool's ``act`` plane and is never cleared: each call
stamps its words with a fresh ``epoch``.  ``lookback_scan_p`` is a model
of that scan, for the tests.

K12 ``fused_refill_flush`` (``csrc/refill_flush.cu``), replacing
``fused_refill_flush_rng`` (:523) and ``fused_refill_flush`` (:588), is the
refill of the seam route (``render/integrator.seam_step``): first every
dead slot (``act`` False) adds its radiance to ``fb[pix]`` (the (P, 3)
framebuffer; a pix outside ``[0, P)`` counts into ``lost``, as K3's
flush) and has it zeroed, then K1's refill runs unchanged.
``flush_dead`` is its flush half alone, the render's last flush.  The
TPU's framebuffer window (``fmin``, ``base``, ``n_hi_win``) and its bf16
one-hot accumulate exist for VMEM and are left out.  Both kernels add a
warp's deaths of one pixel pairwise before one atomic add a channel
(``csrc/flush_warp.cuh``, modelled by ``sp_kernel.flush_warp_p``), so on the
card the framebuffer is within 1e-6 relative of the twins' per-slot adds;
every pool plane, the queue, ``hist``, ``lost`` and the uniforms are
bit-equal to them.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import numpy as np

import torch

from art_tpu_torch.core.camera import Camera, pack_camera, rays_from_uniforms_p
from art_tpu_torch.core.rng import philox_block
from art_tpu_torch.ops import _build
from art_tpu_torch.ops.shade_kernel import flush_plain

NAME = "refill"
FLUSH_NAME = "refill_flush"  # K12
FLUSH_DEAD_NAME = "flush_dead"  # K12's flush-only entry, a kernel of its own
POOL_F = ("ox", "oy", "oz", "dx", "dy", "dz", "tm",
          "t0", "t1", "t2", "r0", "r1", "r2")
POOL_I = ("bounce", "pix")
# uniform-block columns (art_tpu/render/integrator.py:43-54)
U_BALL = slice(0, 3)
U_CHOICE = 3
U_JITTER0, U_JITTER1, U_LENS0, U_LENS1, U_TIME = 4, 5, 6, 7, 8
U_MEDIA = 9  # columns 9.. are per-medium
# the look-back words (csrc/refill.cuh Scan): epoch << 32 | status | value
AGGREGATE, PREFIX = 1 << 30, 2 << 30
VALUE = (1 << 30) - 1
WINDOW = 32  # predecessors a look-back round reads: one a lane of a warp


class RefillScal(NamedTuple):
    """Static queue geometry of one (tile, chunk) dispatch."""

    spp: int
    P: int  # pixels in the tile
    pix_offset: int  # first pixel id of the tile
    total_pixels: int
    nx: int
    ny: int


def new_pool(R: int, device) -> dict:
    """An empty pool: every slot dead, d = (0, 0, 1), throughput 1."""
    z = torch.zeros(R, dtype=torch.float32, device=device)
    pool = {n: z.clone() for n in POOL_F}
    for n in ("dz", "t0", "t1", "t2"):
        pool[n].fill_(1.0)
    for n in POOL_I:
        pool[n] = torch.zeros(R, dtype=torch.int32, device=device)
    pool["act"] = torch.zeros(R, dtype=torch.bool, device=device)
    return pool


def _split(u: torch.Tensor, ball_row: int, choice_row: int, media_row: int):
    return (tuple(u[ball_row:ball_row + 3]), u[choice_row], tuple(u[media_row:]))


def fused_refill_plain(pool, cam: Camera, q, parity: int, hist, it: int,
                       scal: RefillScal, *, block=None, key=None, ncols: int):
    """Plain PyTorch K1 (the jnp refill of art_tpu's integrator)."""
    R = pool["act"].shape[0]
    dev = pool["act"].device
    if block is None:
        seed, tile, chunk = key
        block = philox_block(seed, tile, chunk, it, ncols, R, dev)
    act = pool["act"]
    dead_i = (~act).to(torch.int64)
    rank = torch.cumsum(dead_i, 0) - dead_i
    q0 = q[parity]
    qq = q0 + rank
    take = (~act) & (qq < scal.P * scal.spp)
    p_row = torch.div(qq, scal.spp, rounding_mode="floor")
    pixel = torch.clamp_max(scal.pix_offset + p_row, scal.total_pixels - 1)
    i = (pixel % scal.nx).to(torch.float32)
    j = torch.div(pixel, scal.nx, rounding_mode="floor").to(torch.float32)
    # divide by tensors: ATen on CUDA turns x / python_scalar into
    # x * (1 / scalar), one rounding off the kernel's (and art_tpu's) division
    s = (i + block[U_JITTER0]) / torch.tensor(float(scal.nx), device=dev)
    t = (j + block[U_JITTER1]) / torch.tensor(float(scal.ny), device=dev)
    o, d, tm = rays_from_uniforms_p(cam, s, t, block[U_LENS0], block[U_LENS1],
                                    block[U_TIME])
    new = dict(zip(("ox", "oy", "oz", "dx", "dy", "dz", "tm"), (*o, *d, tm)))
    for n in POOL_F:
        fresh = new.get(n, 1.0 if n in ("t0", "t1", "t2") else 0.0)
        pool[n].copy_(torch.where(take, fresh, pool[n]))
    pool["bounce"].masked_fill_(take, 0)
    pool["pix"].copy_(torch.where(take, p_row.to(torch.int32), pool["pix"]))
    act |= take
    q[1 - parity] = q0 + take.sum()
    hist[it] += act.sum()
    return _split(block, 0, U_CHOICE, U_MEDIA)


_EPOCHS = itertools.count()


def scan_scratch(pool) -> tuple[torch.Tensor, int]:
    """The look-back scratch of the refill kernels (K1, K11, K12) for
    ``pool`` and a fresh epoch for one call.

    The scratch, ``ceil(R / 256) + 1`` int64 words (a word a block, then
    the ticket counter), is zeroed once, when first asked for, and kept on
    the pool's ``act`` plane (an attribute of that tensor, so a clone of the
    pool gets its own); the kernel leaves the counter at 0.  The epoch
    is the next of a process-wide count (1 .. 2^32 - 1, then round again),
    so no call's words read as another's."""
    act = pool["act"]
    n = -(-act.shape[0] // _build.BLOCK) + 1
    scratch = getattr(act, "scan_scratch", None)
    if scratch is None or scratch.shape[0] != n or scratch.device != act.device:
        scratch = torch.zeros(n, dtype=torch.int64, device=act.device)
        act.scan_scratch = scratch
    return scratch, next(_EPOCHS) % 0xFFFFFFFF + 1


def lookback_scan_p(counts, schedule, flags=None, epoch: int = 1) -> tuple:
    """A model of the look-back scan (``csrc/refill.cuh``): the exclusive
    prefix of ``counts`` (a block's dead slots, in ticket order) as the
    blocks find it, and the queue-head total the last ticket writes.

    ``schedule`` is a sequence of tickets, the order in which blocks take
    their steps (cycled until every block is done): a block's first step
    publishes its count (the first block's as its prefix), each later step
    reads one window of ``WINDOW`` predecessors, nearest first, and sums it
    up to its nearest prefix, or whole without one, unless a word up to
    there is not yet this ``epoch``'s (then it reads again next step).
    ``flags`` (int64 words, e.g. left by an earlier call) is the scratch;
    returns (exclusive prefixes, total, flags)."""
    counts = [int(c) for c in counts]
    nb = len(counts)
    flags = np.zeros(nb, np.int64) if flags is None else np.array(flags, np.int64)
    before, state, window = [None] * nb, [0] * nb, [0] * nb
    total, sums = None, [0] * nb
    order = [int(b) for b in schedule]
    while any(x is None for x in before):
        for b in order:
            if before[b] is not None:
                continue
            if state[b] == 0:
                flags[b] = (epoch << 32) | (PREFIX if b == 0 else AGGREGATE) | counts[b]
                state[b] = 1
                if b == 0:
                    before[0] = 0
                continue
            k = [b - 1 - window[b] * WINDOW - lane for lane in range(WINDOW)]
            w = [int(flags[j]) if j >= 0 else (epoch << 32) | PREFIX for j in k]
            mine = [(x >> 32) == epoch and x & (3 << 30) != 0 for x in w]
            pre = [m and x & (3 << 30) == PREFIX for m, x in zip(mine, w)]
            last = pre.index(True) if any(pre) else WINDOW - 1
            if not all(mine[:last + 1]):
                continue
            sums[b] += sum(x & VALUE for x in w[:last + 1])
            window[b] += 1
            if any(pre):
                before[b] = sums[b]
                flags[b] = (epoch << 32) | PREFIX | (sums[b] + counts[b])
    if nb:
        total = before[nb - 1] + counts[nb - 1]
    return before, total, flags


def check_refill_args(pool, q, hist, it: int, block, ncols: int) -> None:
    """Raise unless the pool, the queue head ``q``, the live-count history
    ``hist`` and an injected ``block`` are what the refill code of the
    kernels (K1 and K11) takes."""
    dev = pool["act"].device
    R = pool["act"].shape[0]
    if not 10 <= ncols <= 16:
        raise ValueError(f"ncols={ncols}: the kernels take 1..7 media")
    if R >= 1 << 30:
        raise ValueError(f"R={R}: the look-back scan counts in 30 bits")
    _build.check_planes(POOL_F, [pool[n] for n in POOL_F], R, torch.float32, dev)
    _build.check_planes(POOL_I, [pool[n] for n in POOL_I], R, torch.int32, dev)
    _build.check_planes(("act",), (pool["act"],), R, torch.bool, dev)
    if q.dtype != torch.int64 or q.shape != (2,) or q.device != dev:
        raise ValueError("q: need a (2,) int64 tensor on the pool's device")
    if hist.dtype != torch.int64 or hist.dim() != 1 or hist.shape[0] <= it \
            or hist.device != dev or not hist.is_contiguous():
        raise ValueError(f"hist: need a contiguous int64 tensor with > {it} "
                         "entries on the pool's device")
    if block is not None and (block.shape != (ncols, R) or block.dtype != torch.float32
                              or block.device != dev or not block.is_contiguous()):
        raise ValueError(f"block: need a contiguous ({ncols}, {R}) float32 tensor "
                         f"on {dev}")


def _one_source(block, key) -> None:
    if (block is None) == (key is None):
        raise ValueError("pass exactly one of block= (injected) or key= (Philox)")


def _launch(pool, cam: Camera, q, parity: int, hist, it: int, scal: RefillScal, block,
            key, ncols: int, flush=None):
    """Launch K1, or K12 with ``flush`` = (fb, lost), on a CUDA pool."""
    dev = pool["act"].device
    R = pool["act"].shape[0]
    check_refill_args(pool, q, hist, it, block, ncols)
    if block is not None:
        u = block
        seed = tile = chunk = 0
    else:
        seed, tile, chunk = key
        u = torch.empty((ncols - 5, R), dtype=torch.float32, device=dev)
    scan, epoch = scan_scratch(pool)
    ptrs = _build.pointers([pool[n] for n in POOL_F + POOL_I]
                           + [pool["act"], u, scan, q, hist])
    scal_c = (ctypes.c_longlong * 6)(*scal)
    cam_c = (ctypes.c_float * 21)(*pack_camera(cam).tolist())
    args = (ptrs, R, parity, ncols, int(block is None), scal_c, cam_c,
            seed & 0xFFFFFFFF, tile & 0xFFFFFFFF, chunk & 0xFFFFFFFF, it, epoch)
    lib = _build.library()
    if flush is None:
        name = NAME
        rc = lib.art_refill(*args, _build.stream_handle(dev))
    else:
        name = FLUSH_NAME
        fb, lost = flush
        _build.check_flush(fb, lost, dev)
        rc = lib.art_refill_flush(*args, fb.data_ptr(), fb.shape[0], lost.data_ptr(),
                                  _build.stream_handle(dev))
    _build.check(rc, name)
    _build.launch(name)
    if block is not None:
        return _split(u, 0, U_CHOICE, U_MEDIA)
    return _split(u, 0, U_CHOICE, 4)


def fused_refill(pool, cam: Camera, q, parity: int, hist, it: int,
                 scal: RefillScal, *, block=None, key=None, ncols: int):
    """K1: the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    _one_source(block, key)
    if pool["act"].device.type == "cpu":
        return fused_refill_plain(pool, cam, q, parity, hist, it, scal,
                                  block=block, key=key, ncols=ncols)
    return _launch(pool, cam, q, parity, hist, it, scal, block, key, ncols)


def flush_dead_plain(pool, fb, lost) -> None:
    """Plain PyTorch flush half of K12: ``fb[pix] += radiance`` for every
    dead slot (``shade_kernel.flush_plain``), then its radiance zeroed."""
    dead = ~pool["act"]
    flush_plain(pool["pix"], dead, (pool["r0"], pool["r1"], pool["r2"]), fb, lost)
    for n in ("r0", "r1", "r2"):
        pool[n].masked_fill_(dead, 0.0)


def flush_dead(pool, fb, lost) -> None:
    """K12's flush half alone (``art_flush_dead``) for CUDA tensors, its
    twin for CPU tensors: every dead slot's radiance into ``fb``, then
    zeroed."""
    dev = pool["act"].device
    if dev.type == "cpu":
        return flush_dead_plain(pool, fb, lost)
    R = pool["act"].shape[0]
    _build.check_planes(POOL_F, [pool[n] for n in POOL_F], R, torch.float32, dev)
    _build.check_planes(POOL_I, [pool[n] for n in POOL_I], R, torch.int32, dev)
    _build.check_planes(("act",), (pool["act"],), R, torch.bool, dev)
    _build.check_flush(fb, lost, dev)
    ptrs = _build.pointers([pool[n] for n in POOL_F + POOL_I] + [pool["act"]])
    rc = _build.library().art_flush_dead(ptrs, R, fb.data_ptr(), fb.shape[0],
                                         lost.data_ptr(), _build.stream_handle(dev))
    _build.check(rc, FLUSH_DEAD_NAME)
    _build.launch(FLUSH_DEAD_NAME)


def fused_refill_flush_plain(pool, cam: Camera, q, parity: int, hist, it: int,
                             scal: RefillScal, fb, lost, *, block=None, key=None,
                             ncols: int):
    """Plain PyTorch K12: ``flush_dead_plain``, then K1's twin."""
    flush_dead_plain(pool, fb, lost)
    return fused_refill_plain(pool, cam, q, parity, hist, it, scal, block=block, key=key,
                              ncols=ncols)


def fused_refill_flush(pool, cam: Camera, q, parity: int, hist, it: int,
                       scal: RefillScal, fb, lost, *, block=None, key=None, ncols: int):
    """K12: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors; K1's arguments and returns, plus the (P, 3) float32
    framebuffer ``fb`` and the (1,) int32 ``lost`` counter it flushes into."""
    _one_source(block, key)
    if pool["act"].device.type == "cpu":
        return fused_refill_flush_plain(pool, cam, q, parity, hist, it, scal, fb, lost,
                                        block=block, key=key, ncols=ncols)
    return _launch(pool, cam, q, parity, hist, it, scal, block, key, ncols, (fb, lost))
