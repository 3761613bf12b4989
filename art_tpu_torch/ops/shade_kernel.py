"""Shade + integrate + flush (K3): ``csrc/shade_flush.cu`` and its plain twin.

Replaces ``art_tpu/ops/shade_kernel.py:shade_flush`` in both its modes
(``_shade_math:132-293``) together with the framebuffer flush it runs
(``refill_kernel._flush_dead`` -> ``flush_kernel.one_hot_accumulate``).  One
call, for every slot of the pool:

* background (gradient or solid) radiance for live misses, emission for
  live hits on lights;
* lambertian / metal / dielectric / diffuse_light / isotropic scatter from
  the material parameters: per-ray planes in the plane-fed mode
  (``shade.shade_params_p`` fetches them, ``REC_F``), or, in the baked mode
  (``consts=`` the scene's ``shade_rows`` table, ``REC_BAKED``), looked up
  by the material id as ``art_tpu``'s consts form bakes them
  (``_baked_params:70-129``) — a special leaf's texture value (noise)
  from the ``REC_SP`` planes, which the hit record carries when the scene
  has special leaves (``texture_eval.eval_special_p`` fills them);
* the throughput / origin / direction update, ``bounce += act`` and death
  by absorption or at ``max_depth``;
* ``fb[pix] += radiance`` in float32 for every slot that died; a dying
  slot whose ``pix`` lies outside ``[0, P)`` adds nothing and counts into
  ``lost`` (a (1,) int32 tensor), which the caller checks.  The kernel sums
  a warp's deaths of one pixel before it adds (``csrc/flush_warp.cuh``,
  shared with K11; ``sp_kernel.flush_warp_p`` models its order).

The pool is updated in place and ``fb`` (P, 3) accumulates in place.  The
plain twin is ``ops/shade.py:bounce_p`` (``art_tpu``'s ``_bounce_step``
less its intersection, with a true cube root, ``shade.cbrt``, where the TPU
kernel uses ``exp(log(u)/3)``) plus the death rule and an ``index_add_``
flush — in the baked mode after ``baked_params_p``, a row gather from the
same table; ``csrc/shade_flush.cu`` rounds the same operations in the same
order.
"""

from __future__ import annotations

import ctypes

import torch

from art_tpu_torch.ops import _build
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.shade import bounce_p
from art_tpu_torch.scene.tables import MAX_BAKED_MATS  # csrc/shade_flush.cu kMaxMats

NAME = "shade_flush"
BAKED = "shade_flush_baked"
STATE_F = ("ox", "oy", "oz", "dx", "dy", "dz",
           "t0", "t1", "t2", "r0", "r1", "r2")
STATE_I = ("bounce", "pix")
# hit-record + per-ray material/texture planes (all float32)
REC_F = ("px", "py", "pz", "nx", "ny", "nz", "mtype", "fuzz", "refidx",
         "ma0", "ma1", "ma2", "tx0", "tx1", "tx2", "ub0", "ub1", "ub2", "uch")
# baked mode: hit record + material id (int32) + uniforms, and the special
# leaf values when the scene has special leaves
REC_BAKED = ("px", "py", "pz", "nx", "ny", "nz", "mat", "ub0", "ub1", "ub2", "uch")
REC_SP = ("sp0", "sp1", "sp2")


def baked_params_p(consts, mat, p, sp=None):
    """The plane-fed parameter planes (mtype, fuzz, ref_idx, metal albedo
    3-tuple, texture value 3-tuple) from the ``shade_rows`` table ``consts``
    by material id: a row gather; for a checker of solids the parity of
    ``floor(inv_scale * p)`` picks the even or odd color, and a special
    leaf takes its value from ``sp`` (3 planes) when given."""
    row = take_rows(consts, mat.clamp(0, consts.shape[0] - 1))
    isc = row[:, 7]
    xi, yi, zi = (torch.floor(isc * c).to(torch.int32) for c in p)
    even = ((xi + yi + zi) & 1) == 0
    checker = row[:, 6] == 1.0
    texv = tuple(torch.where(checker & ~even, row[:, 11 + c], row[:, 8 + c])
                 for c in range(3))
    if sp is not None:
        special = row[:, 6] == 2.0
        texv = tuple(torch.where(special, sp[c], texv[c]) for c in range(3))
    return row[:, 0], row[:, 1], row[:, 2], (row[:, 3], row[:, 4], row[:, 5]), texv


def shade_flush_plain(pool, hit, rec, bg, fb, lost, *, max_depth: int, gradient: bool,
                      consts=None):
    """Plain PyTorch K3; ``bg`` is the solid background as three floats;
    ``consts`` (the ``shade_rows`` table) selects the baked mode, whose
    ``rec`` holds the ``REC_SP`` planes too when the scene has special
    leaves."""
    act = pool["act"]
    if consts is None:
        params = (rec["mtype"], rec["fuzz"], rec["refidx"],
                  (rec["ma0"], rec["ma1"], rec["ma2"]), (rec["tx0"], rec["tx1"], rec["tx2"]))
    else:
        params = baked_params_p(consts, rec["mat"], (rec["px"], rec["py"], rec["pz"]),
                                tuple(rec[k] for k in REC_SP) if "sp0" in rec else None)
    o, d, thr, rad, survived = bounce_p(
        *(tuple(pool[k] for k in STATE_F[i:i + 3]) for i in (0, 3, 6, 9)), act, hit,
        (rec["px"], rec["py"], rec["pz"]), (rec["nx"], rec["ny"], rec["nz"]), params,
        (rec["ub0"], rec["ub1"], rec["ub2"]), rec["uch"], bg, gradient)
    for name, plane in zip(STATE_F, (*o, *d, *thr, *rad)):
        pool[name].copy_(plane)
    pool["bounce"] += act.to(torch.int32)
    still = survived & (pool["bounce"] < max_depth)
    flush_plain(pool["pix"], act & ~still, rad, fb, lost)
    act.copy_(still)


def flush_plain(pix, died, rad, fb, lost):
    """``fb[pix] += rad`` in float32 for the slots that died; a pixel
    outside ``[0, P)`` adds nothing and counts into ``lost``."""
    pix = pix[died]
    inside = (pix >= 0) & (pix < fb.shape[0])
    lost += (~inside).sum().to(torch.int32)
    fb.index_add_(0, pix[inside].to(torch.int64), torch.stack(rad, dim=1)[died][inside])


def shade_flush(pool, hit, rec, bg, fb, lost, *, max_depth: int, gradient: bool,
                consts=None):
    """K3: the CUDA kernel (plane-fed, or baked with ``consts``) for CUDA
    tensors, the plain twin for CPU tensors."""
    dev = pool["act"].device
    if dev.type == "cpu":
        return shade_flush_plain(pool, hit, rec, bg, fb, lost, max_depth=max_depth,
                                 gradient=gradient, consts=consts)
    R = pool["act"].shape[0]
    _build.check_planes(STATE_F, [pool[k] for k in STATE_F], R, torch.float32, dev)
    _build.check_planes(STATE_I, [pool[k] for k in STATE_I], R, torch.int32, dev)
    _build.check_planes(("act", "hit"), (pool["act"], hit), R, torch.bool, dev)
    names = REC_F if consts is None else REC_BAKED + (REC_SP if "sp0" in rec else ())
    for name in names:
        _build.check_planes((name,), (rec[name],), R,
                            torch.int32 if name == "mat" else torch.float32, dev)
    _build.check_flush(fb, lost, dev)
    rec_ptrs = [rec[k] for k in names]
    if consts is not None and "sp0" not in rec:
        rec_ptrs += [None] * len(REC_SP)
    ptrs = _build.pointers([pool[k] for k in STATE_F + STATE_I]
                           + [pool["act"], hit] + rec_ptrs + [fb, lost])
    bg_c = (ctypes.c_float * 3)(*[float(c) for c in bg])
    lib = _build.library()
    if consts is None:
        rc = lib.art_shade_flush(ptrs, R, bg_c, int(gradient), max_depth, fb.shape[0],
                                 _build.stream_handle(dev))
        name = NAME
    else:
        _build.check_table("consts", consts, 16, dev)
        if not 1 <= consts.shape[0] <= MAX_BAKED_MATS:
            raise ValueError(f"consts: the baked kernel takes 1..{MAX_BAKED_MATS} materials, "
                             f"got {consts.shape[0]}")
        rc = lib.art_shade_flush_baked(ptrs, R, consts.data_ptr(), consts.shape[0], bg_c,
                                       int(gradient), max_depth, fb.shape[0],
                                       _build.stream_handle(dev))
        name = BAKED
    _build.check(rc, name)
    _build.launch(name)
