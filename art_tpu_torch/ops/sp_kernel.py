"""The short path (K11): ``csrc/sp_step.cu`` and its plain twin.

Replaces ``art_tpu/ops/sp_kernel.py:sp_step_flush_rng`` (:571),
``sp_step_rng`` (:661) and ``sp_step`` (:701): one whole pool iteration for
the small static scenes of the short-path gate (``tables.sp_consts``,
``scene/builder.py:_sp_consts``).  One call, for iteration ``it``:

* the refill of K1 (``ops/refill_kernel.py``): dead slots take queue
  elements and camera rays, ``q[1 - parity]`` gets the next queue head,
  ``hist[it]`` the live-slot count; uniforms from an injected ``(ncols, R)``
  block (``block=``) or Philox (``key=(seed, tile, chunk)``), the same
  columns K1 draws;
* the bounce of ``_sp_bounce`` (``sp_kernel.py:85-402``) over the kernel
  tables ``sp_sph_rows`` / ``sp_quad_rows`` / ``sp_mat_rows``: closest hit
  with the TPU kernel's sphere-root form, background, marble turbulence,
  material by the winner's id, emission and scatter, the death rule;
* ``fb[pix] += radiance`` in float32 for every slot that died, a pixel
  outside ``[0, P)`` counted into ``lost``; the kernel sums a warp's deaths
  of one pixel before it adds (``csrc/flush_warp.cuh``, shared with K3;
  ``flush_warp_p`` models its order, ``flush_census`` counts its adds).

The pool is updated in place; the call returns ``died`` (R,) bool.  The
plain twin ``sp_step_plain`` is ``refill_kernel.fused_refill_plain``, then
``sp_bounce_p`` and an ``index_add_`` flush; the kernel rounds the same
operations in the same order.  As K3, the in-ball radius is a true cube
root (``shade.cbrt``), not the TPU kernel's ``exp(log(u)/3)``.
"""

from __future__ import annotations

import ctypes

import torch

from art_tpu_torch.core.camera import Camera, pack_camera
from art_tpu_torch.core.vecmath import BIG, PARALLEL_EPS, T_MIN, p_dot, p_where, sqrt
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import refill_kernel as rk
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.perlin import TURB_DEPTH, WARP, by_warp, turb_p
from art_tpu_torch.ops.shade import _ball_from_uniforms_p
from art_tpu_torch.ops.shade_kernel import STATE_F, flush_plain
from art_tpu_torch.ops.texture_eval import marble
from art_tpu_torch.scene.tables import MAX_SP_PRIMS, SceneTables

NAME = "sp_step"


def sp_bounce_p(tables: SceneTables, o, d, thr, rad, act, u_ball, u_choice, bg,
                gradient: bool):
    """``_sp_bounce`` less its death rule, on planes: returns (o, d,
    throughput, radiance, survived).  ``act`` is the live mask after the
    refill, ``bg`` the solid background as three floats."""
    sph, quads, mats = tables.sp_sph_rows, tables.sp_quad_rows, tables.sp_mat_rows
    kinds = {m[6] for m in tables.sp_consts[2]}
    a = p_dot(d, d)
    inv_dlen = torch.reciprocal(sqrt(a))
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)

    # ---- closest hit: t, A(3), S, Tn, material; normal = S (p - A) + Tn A ----
    best = (torch.full_like(a, BIG), zero, zero, zero, zero, zero, zero)

    def update(best, cand):
        better = (cand[0] > T_MIN) & (cand[0] < best[0])
        return tuple(torch.where(better, c, b) for c, b in zip(cand, best))

    if sph.shape[0]:
        neg_inv_a = torch.full_like(a, -1.0) / a
        ta2 = -T_MIN * a
        for r in sph:
            oc = (o[0] - r[0], o[1] - r[1], o[2] - r[2])
            b = p_dot(oc, d)
            c = p_dot(oc, oc) - r[3] * r[3]
            sq = sqrt(b * b - a * c)  # NaN on a miss: fails every compare
            s2 = torch.where(b + sq < ta2, sq, -sq)
            best = update(best, ((b + s2) * neg_inv_a, r[0], r[1], r[2], r[4], zero, r[5]))
    for q in quads:
        nd = q[0] * d[0] + q[1] * d[1] + q[2] * d[2]
        no = q[0] * o[0] + q[1] * o[1] + q[2] * o[2]
        t = (q[3] - no) / nd
        alpha = (q[4] * o[0] + q[5] * o[1] + q[6] * o[2]) + t * (
            q[4] * d[0] + q[5] * d[1] + q[6] * d[2]) - q[7]
        beta = (q[8] * o[0] + q[9] * o[1] + q[10] * o[2]) + t * (
            q[8] * d[0] + q[9] * d[1] + q[10] * d[2]) - q[11]
        valid = ((nd.abs() >= PARALLEL_EPS) & (t > T_MIN) & (alpha >= 0.0) & (alpha <= 1.0)
                 & (beta >= 0.0) & (beta <= 1.0))
        t = torch.where(valid, t, BIG)
        flip = torch.where(nd > 0.0, -1.0, 1.0)
        best = update(best, (t, q[0], q[1], q[2], zero, flip, q[12]))
    best_t, A0, A1, A2, S, Tn, best_m = best
    hit = best_t < BIG
    p = (o[0] + best_t * d[0], o[1] + best_t * d[1], o[2] + best_t * d[2])
    n = (S * (p[0] - A0) + Tn * A0, S * (p[1] - A1) + Tn * A1, S * (p[2] - A2) + Tn * A2)

    # ---- background (src/main.cu:58-67) ----
    if gradient:
        tbg = 0.5 * (d[1] * inv_dlen + 1.0)
        bgc = (1.0 - 0.5 * tbg, 1.0 - 0.3 * tbg, one)
    else:
        bgc = tuple(torch.full_like(a, float(bg[c])) for c in range(3))
    miss = act & ~hit
    rad = tuple(rad[c] + torch.where(miss, thr[c] * bgc[c], 0.0) for c in range(3))

    # ---- the winner's material row (the dense mtype blend selects it) ----
    m = take_rows(mats, best_m.to(torch.int64).clamp(0, mats.shape[0] - 1))
    mtype, kind = m[:, 0], m[:, 6]
    texv = (m[:, 7], m[:, 8], m[:, 9])
    if 1 in kinds:  # checker of solids (src/texture.cuh:35-42)
        xi, yi, zi = (torch.floor(m[:, 10] * c).to(torch.int32) for c in p)
        odd = (kind == 1.0) & (((xi + yi + zi) & 1) != 0)
        texv = tuple(torch.where(odd, m[:, 11 + c], texv[c]) for c in range(3))
    if 2 in kinds:  # marble: one turbulence, misses clamped to p = 0
        pt = tuple(torch.where(hit, c, 0.0) for c in p)
        t = marble(m[:, 10], p[2], turb_p(*pt, TURB_DEPTH))
        texv = tuple(torch.where(kind == 2.0, t, texv[c]) for c in range(3))
    is_metal, is_diel, is_light = mtype == 1.0, mtype == 2.0, mtype == 3.0

    # ---- emission (src/material.cuh:169-172) ----
    live_hit = act & hit
    emit = live_hit & is_light
    rad = tuple(rad[c] + torch.where(emit, thr[c] * texv[c], 0.0) for c in range(3))

    ball = _ball_from_uniforms_p(*u_ball)
    direction = (n[0] + ball[0], n[1] + ball[1], n[2] + ball[2])  # lambertian
    ud = (d[0] * inv_dlen, d[1] * inv_dlen, d[2] * inv_dlen)

    # ---- metal (src/material.cuh:90-110) ----
    udn = p_dot(ud, n)
    mdir = tuple((ud[c] - 2.0 * udn * n[c]) + m[:, 1] * ball[c] for c in range(3))
    metal_alive = p_dot(mdir, n) > 0.0

    # ---- dielectric (src/material.cuh:113-159, book-1 form) ----
    ri = m[:, 2]
    ddn = p_dot(d, n)
    inside = ddn > 0.0
    own = p_where(inside, (-n[0], -n[1], -n[2]), n)
    nio = torch.where(inside, ri, one / ri)
    cos_raw = ddn * inv_dlen
    cos_inside = sqrt(torch.clamp_min(1.0 - ri * ri * (1.0 - cos_raw * cos_raw), 0.0))
    cosine = torch.where(inside, cos_inside, -cos_raw)
    dt = p_dot(ud, own)
    disc = 1.0 - nio * nio * (1.0 - dt * dt)
    root = sqrt(torch.clamp_min(disc, 0.0))
    refr = tuple(nio * (ud[c] - own[c] * dt) - own[c] * root for c in range(3))
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    schl = r0 + (1.0 - r0) * (x2 * x2 * x)
    reflect = u_choice < torch.where(disc > 0.0, schl, 1.0)
    ddn2 = 2.0 * ddn
    drefl = tuple(d[c] - ddn2 * n[c] for c in range(3))
    ddir = p_where(reflect, drefl, refr)

    # ---- blend by type + integrate (src/main.cu:71-83) ----
    direction = p_where(is_diel, ddir, p_where(is_metal, mdir, direction))
    atten = p_where(is_diel, (one, one, one),
                    p_where(is_metal, (m[:, 3], m[:, 4], m[:, 5]), texv))
    survived = live_hit & ~is_light & (~is_metal | metal_alive)
    thr = p_where(survived, (thr[0] * atten[0], thr[1] * atten[1], thr[2] * atten[2]), thr)
    o = p_where(survived, p, o)
    d = p_where(survived, direction, d)
    return o, d, thr, rad, survived


def sp_step_plain(pool, cam: Camera, q, parity: int, hist, it: int, scal: rk.RefillScal,
                  tables: SceneTables, bg, fb, lost, *, block=None, key=None, ncols: int,
                  max_depth: int, gradient: bool) -> torch.Tensor:
    """Plain PyTorch K11: the refill twin, ``sp_bounce_p``, the death rule
    and the flush; returns died (R,) bool."""
    u_ball, u_choice, _ = rk.fused_refill_plain(pool, cam, q, parity, hist, it, scal,
                                                block=block, key=key, ncols=ncols)
    act = pool["act"]
    o, d, thr, rad, survived = sp_bounce_p(
        tables, *(tuple(pool[k] for k in STATE_F[i:i + 3]) for i in (0, 3, 6, 9)), act,
        u_ball, u_choice, bg, gradient)
    for name, plane in zip(STATE_F, (*o, *d, *thr, *rad)):
        pool[name].copy_(plane)
    pool["bounce"] += act.to(torch.int32)
    still = survived & (pool["bounce"] < max_depth)
    died = act & ~still
    flush_plain(pool["pix"], died, rad, fb, lost)
    act.copy_(still)
    return died


def _warp_groups(pix, died, P: int):
    """Per warp of 32 consecutive slots (W, 32): each slot's pixel, whether
    it flushes (it died on a pixel inside ``[0, P)``), the (W, 32, 32) mask
    of flushing slots on the same pixel, and the pixel's lowest flushing
    slot (the one that adds in ``flush_warp``)."""
    inside = died & (pix >= 0) & (pix < P)
    key, flush = by_warp(pix), by_warp(inside, False)
    lane = torch.arange(WARP, device=pix.device)
    same = (key[:, :, None] == key[:, None, :]) & flush[:, :, None] & flush[:, None, :]
    lowest = flush & (same.to(torch.int32).argmax(dim=-1) == lane)
    return key, flush, same, lowest


def flush_warp_p(pix, died, rad, fb, lost):
    """``flush_plain`` in the kernels' order (``csrc/flush_warp.cuh
    flush_warp``, the flush of K11 and K3), for tests: per warp of 32
    consecutive slots, the deaths of one pixel inside ``[0, P)`` are summed
    pairwise in slot order (after step k a slot holds the sum of itself and
    the next 2^k - 1 slots of its pixel), and the pixel's lowest slot adds
    the sum; a pixel outside counts into ``lost``."""
    lost += (died & ~((pix >= 0) & (pix < fb.shape[0]))).sum().to(torch.int32)
    key, flush, same, lowest = _warp_groups(pix, died, fb.shape[0])
    vals = by_warp(torch.stack(rad, dim=1))
    lane = torch.arange(WARP, device=pix.device)
    above = same & (lane[None, None, :] > lane[None, :, None])
    nxt = torch.where(above.any(dim=-1), above.to(torch.int32).argmax(dim=-1), -1)
    span = 1
    while span < int(same.sum(dim=-1).max()):
        src = torch.where(nxt >= 0, nxt, lane)
        on = (nxt >= 0)[..., None]
        vals = torch.where(on, vals + vals.gather(1, src[..., None].expand(-1, -1, 3)), vals)
        nxt = torch.where(nxt >= 0, nxt.gather(1, src), nxt)
        span *= 2
    fb.index_add_(0, key[lowest].to(torch.int64), vals[lowest])


def flush_census(pix, died, P: int) -> tuple:
    """How much ``flush_warp`` saves on a pool: (the deaths on pixels inside
    ``[0, P)``, a float32 atomicAdd a channel each in a per-slot flush; the
    pixels they fall on counted once a warp, an add a channel each in
    ``flush_warp``; the deaths whose pixel another death of their warp
    shares), summed over the warps of 32 consecutive slots."""
    _, flush, same, lowest = _warp_groups(pix, died, P)
    return (int(flush.sum()), int(lowest.sum()),
            int((flush & (same.sum(dim=-1) > 1)).sum()))


def sp_step(pool, cam: Camera, q, parity: int, hist, it: int, scal: rk.RefillScal,
            tables: SceneTables, bg, fb, lost, *, block=None, key=None, ncols: int,
            max_depth: int, gradient: bool) -> torch.Tensor:
    """K11: the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    if (block is None) == (key is None):
        raise ValueError("pass exactly one of block= (injected) or key= (Philox)")
    if tables.sp_consts is None:
        raise ValueError("the scene fails the short-path gate (tables.sp_consts is None)")
    dev = pool["act"].device
    if dev.type == "cpu":
        return sp_step_plain(pool, cam, q, parity, hist, it, scal, tables, bg, fb, lost,
                             block=block, key=key, ncols=ncols, max_depth=max_depth,
                             gradient=gradient)
    R = pool["act"].shape[0]
    rk.check_refill_args(pool, q, hist, it, block, ncols)
    _build.check_flush(fb, lost, dev)
    sph = _build.check_table("sp_sph_rows", tables.sp_sph_rows, 6, dev)
    quads = _build.check_table("sp_quad_rows", tables.sp_quad_rows, 13, dev)
    mats = _build.check_table("sp_mat_rows", tables.sp_mat_rows, 14, dev)
    if sph.shape[0] + quads.shape[0] > MAX_SP_PRIMS or not 1 <= mats.shape[0] <= MAX_SP_PRIMS:
        raise ValueError(f"the short-path kernel takes <= {MAX_SP_PRIMS} primitives and "
                         f"1..{MAX_SP_PRIMS} materials")
    seed, tile, chunk = key if key is not None else (0, 0, 0)
    died = torch.empty(R, dtype=torch.bool, device=dev)
    scan, epoch = rk.scan_scratch(pool)
    ptrs = _build.pointers([pool[n] for n in rk.POOL_F + rk.POOL_I]
                           + [pool["act"], block, scan, q, hist, died, fb, lost])
    rc = _build.library().art_sp_step(
        ptrs, R, parity, ncols, int(block is None), (ctypes.c_longlong * 6)(*scal),
        (ctypes.c_float * 21)(*pack_camera(cam).tolist()), seed & 0xFFFFFFFF,
        tile & 0xFFFFFFFF, chunk & 0xFFFFFFFF, it, epoch,
        (ctypes.c_float * 3)(*[float(c) for c in bg]), int(gradient), max_depth,
        fb.shape[0], sph.data_ptr(), sph.shape[0], quads.data_ptr(), quads.shape[0],
        mats.data_ptr(), mats.shape[0], _build.stream_handle(dev))
    _build.check(rc, NAME)
    _build.launch(NAME)
    return died
