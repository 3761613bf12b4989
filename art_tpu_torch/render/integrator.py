"""Wavefront path-tracing integrators (port of ``art_tpu/render/integrator.py``).

* ``trace`` — trace a fixed ray batch to completion (the reference
  ``color()`` loop, src/main.cu:44-87); plain PyTorch, for tests and
  ad-hoc rays.
* ``render_wavefront`` — the production path: a persistent pool of R ray
  slots refilled from the sample-major (pixel, sample) queue.  The staged
  iteration is refill (K1) -> closest quad (K5, its attributes in PyTorch
  glue), box (K6, or K9/K10 on a box grid) and sphere (the full-table K2;
  on opt-in routes K16, K17 or the split pass, ``ops/routes.py``), merged
  -> constant media
  (``apply_media_p``: K18, one launch) -> shade + integrate
  + flush (K3).
  K3 runs baked when the scene has ``shade_consts`` (``art_tpu``'s default
  gate, ``integrator.py:139,655-676``): the parameters come from the
  material id, and a special material's value from ``eval_special_p``
  (noise, noodle and felt through the turbulence kernel K7, images through
  one launch of K8's fetch form, ``ops/texture_eval.py``).  Otherwise the
  material/texture planes are fetched first (PyTorch glue,
  ``shade_params_p``) and K3 runs plane-fed.
  The short path (``use_short_path``, ``art_tpu``'s gate at
  ``integrator.py:406-421``) runs the whole iteration as one kernel call
  (K11, ``ops/sp_kernel.py``) for the small static scenes that pass
  ``tables.sp_consts``.  The seam route (``ART_TPU_SEAM_FLUSH``,
  ``ops/routes.py``; ``art_tpu``'s ``use_seam``, ``integrator.py:393-405``)
  runs ``seam_step`` on every scene instead: K12 flushes the slots that
  died in the previous iteration into the framebuffer and refills, the
  shading is the plain PyTorch bounce (``_bounce_step``, as ``art_tpu``
  runs it with the shade kernel off), and one flush of every dead slot
  after the loop (``rk.flush_dead``) adds the last deaths.

Loop control.  ``lax.while_loop`` keeps its condition on the device; here
the host must read it.  K1 adds each iteration's live-slot count to
``hist[it]``, and an iteration that starts with no live slot after its
refill proves the queue and the pool empty for good — so the loop reads
``hist[it]`` every ``CHECK_EVERY`` iterations once the queue could have
drained (``ceil(n_q / R)`` iterations), and stops at the first zero.  The
iterations run past the end are exact no-ops.  Rays and iterations come
from ``hist`` at the end: rays = sum, iterations = count of nonzero
entries, which is ``art_tpu``'s count (its condition holds exactly when
the iteration has a live slot).

Spans (``utils/tracing.py``).  A ``render_wavefront`` call is a ``dispatch``
span and each iteration a ``loop`` span; inside them the stage spans
``refill``, ``intersect``, ``media``, ``textures`` and ``shade`` (on the
short path one ``short_path`` span), and each blocking host read a ``sync``
span.  The stages are the module attributes they call (``rk.fused_refill``,
``closest_surface_p``, ...), looked up at call time, so a wrapper set on
one of them runs inside its span.  Under a CUDA graph capture each stage
span counts the graph nodes its calls add (``tracing.capturing``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from art_tpu_torch.core.camera import Camera
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops import routes
from art_tpu_torch.ops.intersect import apply_media_p, closest_surface_p
from art_tpu_torch.ops.shade import bounce_p, shade_params_p
from art_tpu_torch.ops.shade_kernel import (
    REC_BAKED,
    REC_F,
    REC_SP,
    shade_flush,
    shade_flush_plain,
)
from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain
from art_tpu_torch.ops.texture_eval import eval_special_p
from art_tpu_torch.scene.tables import MatType, SceneTables
from art_tpu_torch.utils import tracing as tr

# Host reads of the loop condition: one 8-byte read every CHECK_EVERY
# iterations (PERF.md §3, the host loop).
CHECK_EVERY = 4
REFILL, INTERSECT, MEDIA, TEXTURES, SHADE, SHORT_PATH = map(tr.layer, (
    "refill", "intersect", "media", "textures", "shade", "short_path"))


def n_uniform_cols(tables: SceneTables) -> int:
    return rk.U_MEDIA + max(tables.n_media, 1)


def use_short_path(tables: SceneTables, short_path: bool | None = None) -> bool:
    """Whether a render takes the short path (K11), ``art_tpu``'s rule
    (``integrator.py:406-421``): the scene passes the scene compiler's
    gate (``tables.sp_consts``) and, by default, has no dielectric (measured
    slower fused on the TPU).  ``short_path`` mirrors ``art_tpu``'s two
    switches: False is ``ART_TPU_NO_SP`` (always staged), True is
    ``ART_TPU_SP`` (dielectric scenes too; a scene that fails the gate
    raises).  The seam route (``ART_TPU_SEAM_FLUSH``) excludes it, as in
    ``art_tpu``, even when forced."""
    if short_path is False or routes.ROUTES.seam_flush:
        return False
    if tables.sp_consts is None:
        if short_path:
            raise ValueError("short_path=True: the scene fails the short-path gate "
                             "(boxes, media, moving spheres, > 16 primitives, or a "
                             "material or texture the short path lacks)")
        return False
    return bool(short_path) or not any(m[0] == MatType.DIELECTRIC
                                       for m in tables.sp_consts[2])


def _bounce_step(tables, o, d, tm, throughput, radiance, active,
                 u_ball, u_choice, u_media, background, gradient_bg, *, plain=True):
    """One shared bounce: intersect -> media -> background/emission ->
    scatter (``art_tpu/render/integrator.py:162-186``); ``plain`` takes
    every kernel's plain twin.

    Returns (new_o, new_d, new_throughput, new_radiance, survived)."""
    tr.begin(INTERSECT)
    surf = closest_surface_p(tables, o, d, tm, T_MIN, plain=plain)
    tr.switch(MEDIA)
    rec = apply_media_p(tables, o, d, T_MIN, surf, u_media, time=tm, plain=plain)
    tr.switch(SHADE)
    params = shade_params_p(tables, rec, valid=active & rec.hit, plain=plain)
    out = bounce_p(o, d, throughput, radiance, active, rec.hit, rec.p, rec.normal,
                   params, u_ball, u_choice, background, gradient_bg)
    tr.end()
    return out


def _as_block(u, device) -> torch.Tensor:
    """An injected uniform block (numpy or torch) as a contiguous float32
    tensor on ``device``."""
    if not isinstance(u, torch.Tensor):
        u = torch.from_numpy(np.array(u, np.float32))
    return u.to(device=device, dtype=torch.float32).contiguous()


def trace(tables: SceneTables, origins, directions, times, uniforms, background,
          gradient_bg: bool, max_depth: int = 50):
    """Trace a ray batch to completion.

    ``origins``/``directions`` are (R,3); ``uniforms(bounce)`` returns that
    bounce's (ncols, R) block.  Returns (radiance (R,3), rays_traced)."""
    R = origins.shape[0]
    ones = torch.ones(R, dtype=torch.float32, device=origins.device)
    zeros = torch.zeros_like(ones)
    o = tuple(origins[:, c] for c in range(3))
    d = tuple(directions[:, c] for c in range(3))
    thr, rad = (ones, ones, ones), (zeros, zeros, zeros)
    alive = torch.ones(R, dtype=torch.bool, device=origins.device)
    rays = 0
    for bounce in range(max_depth):
        if not bool(alive.any()):
            break
        U = _as_block(uniforms(bounce), origins.device)
        rays += int(alive.sum())
        o, d, thr, rad, alive = _bounce_step(
            tables, o, d, times, thr, rad, alive,
            tuple(U[rk.U_BALL]), U[rk.U_CHOICE], U[rk.U_MEDIA:], background,
            gradient_bg)
    return torch.stack(rad, dim=1), rays


def render_wavefront(tables: SceneTables, cam: Camera, pix_offset: int, spp: int,
                     background, *, tile_pixels: int, total_pixels: int, nx: int,
                     ny: int, max_depth: int, gradient_bg: bool, n_slots: int,
                     tile: int, chunk: int, seed: int, uniforms=None,
                     plain: bool = False, short_path: bool | None = None):
    """Render ``tile_pixels x spp`` samples with a persistent ``n_slots`` pool.

    ``uniforms`` is an injected source ``(tile, chunk, it) -> (ncols, R)``;
    ``None`` draws Philox keyed by ``(seed, tile, chunk)``.  ``plain`` runs
    the plain PyTorch twins of the kernels on any device; ``short_path``
    picks the path (``use_short_path``).
    Returns (fb_sum (tile_pixels, 3) radiance summed over spp, rays,
    iterations)."""
    dev = tables.mat_packed.device  # every scene has a material row
    P, R = tile_pixels, n_slots
    n_q = P * spp
    ncols = n_uniform_cols(tables)
    max_iters = (n_q * max_depth) // R + max_depth + 2
    min_iters = -(-n_q // R)
    scal = rk.RefillScal(spp, P, pix_offset, total_pixels, nx, ny)
    seam = routes.ROUTES.seam_flush
    if use_short_path(tables, short_path):
        sp = sp_step_plain if plain else sp_step

        def step(*args, **kwargs):
            tr.begin(SHORT_PATH)
            sp(*args, **kwargs)
            tr.end()
    else:
        step = functools.partial(seam_step if seam else staged_step, plain=plain)

    with tr.dispatch(tile, chunk) as record:
        pool = rk.new_pool(R, dev)
        fb = torch.zeros((P, 3), dtype=torch.float32, device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        q = torch.zeros(2, dtype=torch.int64, device=dev)
        hist = torch.zeros(max_iters, dtype=torch.int64, device=dev)
        for it in range(max_iters):
            tr.begin_iteration(it)
            if uniforms is None:
                src = dict(key=(seed, tile, chunk))
            else:
                src = dict(block=_as_block(uniforms(tile, chunk, it), dev))
            step(pool, cam, q, it % 2, hist, it, scal, tables, background, fb, lost,
                 ncols=ncols, max_depth=max_depth, gradient=gradient_bg, **src)
            drained = False
            if it + 1 >= min_iters and (it + 1 - min_iters) % CHECK_EVERY == 0:
                tr.begin_sync()
                drained = int(hist[it]) == 0
                tr.end()
            tr.end_iteration()
            if drained:
                break
        if seam:
            # the slots that died in the last iteration run; every other dead
            # slot holds zero radiance, so one flush of all dead slots is exact
            (rk.flush_dead_plain if plain else rk.flush_dead)(pool, fb, lost)
        tr.begin_sync()
        counts = hist.cpu()
        tr.end()
        tr.begin_sync()
        n_lost = int(lost)
        tr.end()
        if n_lost:
            raise RuntimeError(f"{n_lost} dead slots had a pixel outside the tile")
        record.segments = int(counts.sum())
        record.iterations = int(torch.count_nonzero(counts))
    return fb, record.segments, record.iterations


def seam_step(pool, cam: Camera, q, parity: int, hist, it: int, scal: rk.RefillScal,
              tables: SceneTables, bg, fb, lost, *, block=None, key=None, ncols: int,
              max_depth: int, gradient: bool, plain: bool = False) -> None:
    """One iteration of the seam route (``art_tpu/render/integrator.py``
    ``use_seam``: ``:546-561``, ``:740-760``), in place: K12 flushes the
    previous iteration's deaths and refills; the closest hit, the media,
    the material parameters and the bounce in plain PyTorch with the
    kernels of ``closest_surface_p`` and ``shade_params_p`` (``_bounce_step``,
    no K3); then the depth rule, with no flush.  ``plain`` takes every
    kernel's plain twin."""
    act = pool["act"]
    capture = tr.capturing(act)
    refill = rk.fused_refill_flush_plain if plain else rk.fused_refill_flush
    tr.begin(REFILL)
    u_ball, u_choice, u_media = refill(pool, cam, q, parity, hist, it, scal, fb, lost,
                                       block=block, key=key, ncols=ncols)
    tr.end()
    planes = [tuple(pool[n] for n in names) for names in (
        ("ox", "oy", "oz"), ("dx", "dy", "dz"), ("t0", "t1", "t2"), ("r0", "r1", "r2"))]
    o, d, thr, rad, survived = _bounce_step(
        tables, planes[0], planes[1], pool["tm"], planes[2], planes[3], act, u_ball,
        u_choice, u_media, bg, gradient, plain=plain)
    tr.begin(SHADE)
    for names, new in zip(planes, (o, d, thr, rad)):
        for plane, value in zip(names, new):
            plane.copy_(value)
    pool["bounce"] += act.to(torch.int32)
    act.copy_(survived & (pool["bounce"] < max_depth))
    tr.end()
    if capture is not None:
        capture.close()


def staged_step(pool, cam: Camera, q, parity: int, hist, it: int, scal: rk.RefillScal,
                tables: SceneTables, bg, fb, lost, *, block=None, key=None, ncols: int,
                max_depth: int, gradient: bool, plain: bool = False) -> None:
    """One staged iteration, in place (the short path's ``sp_step`` in
    several calls): refill (K1), the closest hit (K5, K6 or K9/K10, K2 or
    an opt-in sphere route), the media, the special leaves of baked materials
    (turbulence through K7, image texels through K8's fetch form), shade +
    flush (K3).  ``plain`` takes every kernel's plain twin."""
    capture = tr.capturing(pool["act"])
    refill = rk.fused_refill_plain if plain else rk.fused_refill
    tr.begin(REFILL)
    u_ball, u_choice, u_media = refill(pool, cam, q, parity, hist, it, scal, block=block,
                                       key=key, ncols=ncols)
    tr.switch(INTERSECT)
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    surf = closest_surface_p(tables, o, d, pool["tm"], T_MIN, plain=plain)
    tr.switch(MEDIA)
    rec = apply_media_p(tables, o, d, T_MIN, surf, u_media, time=pool["tm"], plain=plain)
    tr.switch(SHADE)
    consts = tables.shade_rows  # None: plane-fed K3
    specials = consts is not None and tables.shade_consts[1]
    # the lanes whose texture value K3 reads (the image fetch and the
    # special leaves skip the rest): only plane-fed shading and special
    # leaves take them
    valid = rec.hit & pool["act"] if consts is None or specials else None
    if consts is None:
        mtype, fuzz, refidx, malb, texv = shade_params_p(tables, rec, valid, plain=plain)
        planes = dict(zip(REC_F, (
            *rec.p, *rec.normal, mtype, fuzz, refidx, *malb, *texv, *u_ball, u_choice)))
    else:
        planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u_ball, u_choice)))
        if specials:
            tr.begin(TEXTURES)
            planes.update(zip(REC_SP, eval_special_p(
                tables, specials, rec.mat, rec.u, rec.v, rec.p, valid=valid, plain=plain)))
            tr.end()
    (shade_flush_plain if plain else shade_flush)(
        pool, rec.hit, planes, bg, fb, lost, max_depth=max_depth, gradient=gradient,
        consts=consts)
    tr.end()
    if capture is not None:
        capture.close()
