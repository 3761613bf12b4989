#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card.

Run from the repository root, once per checkout to compare, all in one call
on one card (turns: parent, change, change, parent):

    PYTHONPATH=<checkout> python3 scripts/kernel_pair.py --label parent
    python3 scripts/kernel_pair.py --label change

The port (``art_tpu_torch``) is imported from PYTHONPATH when it is set, so
the same script times another checkout's kernels; the pools and the timer
are ``chip_smoke.py``'s (this checkout's).  ``--set noise`` times K7 and
K11 alone, ``--set intersect`` the sphere and box kernels alone,
``--set refill_quad`` the refill core's three kernels and K5's block,
``--set box_shade`` K6's block and K3 in both modes, ``--set fetch`` the
image fetch, ``--set mxu_skip`` K14, K16 (both calls), K17 and K15s,
``--set static_cellbin`` K13 and K17 with K2, K16 and K15s as controls,
``--set cluster`` K15's spheres and boxes and K17, ``--set seam_grid`` K12
(both entries) and K10 with K1, K11 and K9 as controls, ``--set compact``
the split's compaction (K4's compaction form, or in a checkout from before
it the pipeline it replaced) and the split sphere pass, with K2, K16 and K1
as controls, then the split's renders,
``--set renders`` whole renders (``--scenes``, each ``--render-reps``
times: wall seconds, rays and iterations from ``render_scene``'s stats; by
default RENDERS; a scene may carry route switches of ``ops/routes.py``
after a colon, ``+``-separated, e.g. ``final_scene:sph_skip+compact_sph+
compact_skip``, and another sample count after an ``@``, e.g.
``cornell_box:seam_flush@16``; ``box field`` is chip_smoke's 40x40 field);
the default, the first two.  Each kernel runs on the pools
``chip_smoke.py`` uses:

* noise: K7 at depth 7 on phase 2c's inputs (the hit points of perlin
  1200x600 @ 64 short-path pools 20 and 21 iterations in, of the final_scene
  staged pool of phase 2f, and random points, each lane its own cell); K11
  on the steps phase 2c times (perlin 20 and 21 iterations in, quads 20);
* intersect: K2 on phase 2a's refilled bouncing_spheres 1200x800 pool (also
  at t_min = 0.25) and on the 20-iteration bouncing_spheres and final_scene
  pools of phase 2f, with ``n_live`` on the final_scene pool's compacted
  tail slots; K9 and K10 on the final_scene pool (K10 also on the 40x40 box
  field's pool); K9 on a 72x8 field's pool (kx + kz = 80); K2 on a
  cornell_box 600x600 pool one staged iteration in (two spheres); K15s, K16
  and K17 on the 2f pools;
* refill_quad: K1 on bouncing_spheres 1200x800 pools (phase 2i's) with 0%,
  30% and 100% of the slots dead, every dead slot taking a queue element;
  K11 on phase 2c's timed steps; K12 on phase 2h's seam pool; K5's block of
  ``closest_surface_p`` (the kernel with its winner's attributes, or in a
  checkout from before it, the kernel and the PyTorch glue after it, timed
  as one function) on cornell_box 600x600's pool 20 staged iterations in
  and on final_scene's (phase 2f's); and the device launches of one staged
  cornell_box iteration;
* box_shade: K6's block of ``closest_surface_p`` after the quads (the
  merge form, or in a checkout from before it, K6 and ``_closer`` timed as
  one function) on cornell_box 600x600's pool 20 staged iterations in, on
  random rays over cornell_box and on the translated-box scene's (phase
  2b's); baked K3 on that staged pool (its real pixels), on phase 2b's
  random cornell_box pool and on it with its samples side by side; plane-fed
  K3 on phase 2a's refilled bouncing_spheres pool, on it side by side and on
  a bouncing_spheres 1200x800 @ 64 pool 20 staged iterations in; and the
  device launches of one staged cornell_box iteration, by kernel name;
* mxu_skip: K14 on phase 2f's bouncing_spheres 1200x800 @ 64 pool 20
  staged iterations in (its features) and on final_scene's MXU tail (the
  tail's recentered features over phase 2f's final_scene pool, phase 2h's
  call); K16 standalone on that final_scene pool and its tail-only call
  with ``n_live`` on the pool's compacted tail slots (phase 2f's); K17 and
  K15s on both pools;
* static_cellbin: K13 in both forms on phase 2f's bouncing_spheres and
  final_scene pools and phase 2h's cornell_box 600x600 @ 64 pool (20 staged
  iterations in), its six libraries built together first (``nvcc_s`` each,
  ``K13 builds`` the wall seconds), K2 on each pool; K17 on the
  bouncing_spheres and final_scene pools with the (ray, sphere) tests its
  rays need and its warps make (``chip_smoke._culled_tests``), K15s on
  both, K16 standalone on final_scene's;
* cluster: K15s (``sphere_cluster_hit_attrs``) on phase 2g's
  bouncing_spheres and final_scene pools and on its table of more than 64
  clusters (``chip_smoke._many_cluster_rays``), K15b
  (``box_cluster_hit_attrs``) on 2g's final_scene, box field and rotated
  field pools, and K17 on both lattices (bouncing_spheres and final_scene),
  each with the (ray, primitive) tests its rays need and its warps make
  (``chip_smoke._culled_tests``, ``_box_cluster_tests``);
* seam_grid: K12 on phase 2h's seam pool (bouncing_spheres 1200x800 @ 64,
  20 seam iterations in, every dead slot with radiance), its flush-only
  entry and K1 on that pool, with the census of its flush lanes
  (``sp_kernel.flush_census``); K1 and K11 as refill_quad times them; K10 on
  final_scene's table (phase 2f's pool, the cell list dropped) and on the
  40x40 box field's pool one staged iteration in, each with the tests its
  walk makes (``chip_smoke._grid_tests``); K9 on final_scene's pool and the
  72x8 field's;
* compact: the split's compaction of the six ray planes (``compact_fetch.
  compact``, or in a checkout from before it ``needy.sum``,
  ``compact_ray_ids`` and ``stack(planes).index_select``, as that split ran
  them) and ``chip_smoke._parent_compaction`` (K4's flush form with the
  rank, count and gather around it, in both checkouts) on phase 2d's earth
  pool (the image fetch's needy lanes) and final_scene pool (the split's),
  each with its device launches by kernel name (``differ``: values of the
  ids, count and payload below the count apart from
  ``_parent_compaction``'s); the split sphere pass with K2's tail and with
  K16's tail-only call on that final_scene pool, with its launches; K2
  with ``n_live`` and K16's tail-only call on the compacted slots and K1 as
  refill_quad times it, as controls; then the final_scene split and
  split-skip renders (``--render-reps`` each);
* fetch: ``ImageAtlas.sample(..., needy)`` (K8's fetch form) and
  ``eval_special_p``'s image leaf on phase 2d's earth 1200x600
  @ 64 and final_scene 800x800 @ 16 pools 20 staged iterations in, each
  with its device launches; and the device launches of one staged
  iteration on each, by kernel name.  The pools' image lanes come from the
  timed checkout's ``ops/texture_eval.py image_lanes``, so a checkout from
  before the fetch form, which lacks it, cannot be timed here.

For each: the mean device time of 20 calls (CUDA events behind a device
spin) and the count of output values that differ from its plain twin (K11:
pool planes, queue, live count, died and lost; its framebuffer's largest
relative difference beside).  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.append(str(ROOT))  # after PYTHONPATH: a given checkout's port comes first
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _refilled_pool(cs, dev, full=False):
    """Phase 2a's pool: a random bouncing_spheres 1200x800 pool refilled by
    K1 with Philox uniforms (tables, o, d, tm; with ``full`` also the pool,
    the tile's pixel count and the scene)."""
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    rng = np.random.default_rng(cs.SEED)
    scene = build_scene("bouncing_spheres", 1200, 800)
    tables = scene.tables.to(dev)
    tile_pixels, spp, R = plan_batches(1200 * 800, 64, tables.n_spheres, RenderConfig(), dev)
    scal = rk.RefillScal(spp, tile_pixels, 3 * tile_pixels, 1200 * 800, 1200, 800)
    pool = cs._random_pool(rng, R, dev)
    q = torch.tensor([1_234_567, 0], dtype=torch.int64, device=dev)
    hist = torch.zeros(8, dtype=torch.int64, device=dev)
    rk.fused_refill(pool, scene.camera, q, 0, hist, 3, scal, ncols=10, key=(1984, 3, 1))
    rays = (tables, (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"]),
            pool["tm"])
    return (*rays, cs._clone(pool), tile_pixels, scene) if full else rays


def _field_pool(cs, dev, kx, kz, nx, ny):
    """(tables, o, d) of a kx x kz box field's pool one staged iteration in."""
    scene = cs._box_field(nx, ny, kx, kz).to(dev)
    s = cs._staged_pool(scene, nx, ny, 4, dev, 1)
    pool = s["pool"]
    return scene.tables, (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"],
                                                                pool["dz"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--set", choices=("all", "noise", "intersect", "refill_quad", "box_shade",
                                      "fetch", "mxu_skip", "static_cellbin", "cluster",
                                      "seam_grid", "compact", "renders"),
                    default="all")
    ap.add_argument("--render-reps", type=int, default=3)
    ap.add_argument("--scenes", default=",".join(name for name, *_ in RENDERS),
                    help="comma-separated scenes of --set renders (sizes from SIZES)")
    args = ap.parse_args()
    cs = _chip_smoke()
    import torch

    import art_tpu_torch
    from art_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("kernel_pair: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.library()
    out = {"label": args.label, "package": str(Path(art_tpu_torch.__file__).parent),
           "build_s": lib.build_seconds, "kernels": {}}

    def case(name, kern, twin, differ=cs._equal):
        k, p = kern(), twin()
        torch.cuda.synchronize()
        out["kernels"][name] = dict(ms=cs._timed_ms(kern, args.reps), differ=differ(k, p))

    if args.set in ("all", "noise"):
        noise_cases(cs, dev, case, out["kernels"], args.reps)
    if args.set in ("all", "intersect"):
        intersect_cases(cs, dev, case)
    if args.set == "refill_quad":
        refill_quad_cases(cs, dev, case, out["kernels"], args.reps)
    if args.set == "box_shade":
        box_shade_cases(cs, dev, out["kernels"], args.reps)
    if args.set == "fetch":
        fetch_cases(cs, dev, out["kernels"], args.reps)
    if args.set == "mxu_skip":
        mxu_skip_cases(cs, dev, case)
    if args.set == "static_cellbin":
        static_cellbin_cases(cs, dev, case, out["kernels"])
    if args.set == "cluster":
        cluster_cases(cs, dev, case, out["kernels"])
    if args.set == "seam_grid":
        seam_grid_cases(cs, dev, case, out["kernels"], args.reps)
    if args.set == "compact":
        compact_cases(cs, dev, case, out["kernels"], args.reps)
        out["renders"] = render_cases(cs, dev, args.render_reps, SPLIT_RENDERS)
    if args.set == "renders":
        out["renders"] = render_cases(cs, dev, args.render_reps, args.scenes.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out["card"] = smi
    print(json.dumps(out))
    return 0


def noise_cases(cs, dev, case, kernels, reps):
    """K7 and K11 on phase 2c's inputs."""
    from art_tpu_torch.ops import perlin
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.perlin_kernel import turb
    from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain

    for label, p in cs._turb_pools(dev).items():
        case(f"K7 {label}", lambda: turb(*p, 7), lambda: perlin.turb_p(*p, 7), cs._bits_equal)
    s = cs._short_setup(dev)
    for _, name, iters in cs.SP_TIMED:
        scene, base, src = s["scenes"][name], s["rendered"][(name, iters)], dict(key=(1984, 2, 1))
        kp, kq, kh, kfb, kl, kd = cs._sp_run(s, sp_step, scene, base, src)
        pp, pq, ph, pfb, pl, pd = cs._sp_run(s, sp_step_plain, scene, base, src)
        differ = sum(cs._bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
        differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
        differ += int((kq != pq).sum() + (kh != ph).sum() + (kd != pd).sum() + (kl != pl).sum())
        kernels[f"K11 {name} {iters}"] = dict(
            ms=cs._sp_step_ms(s, sp_step, name, iters, reps), differ=differ,
            fb_rel=float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max()))


# (scene, nx, ny, spp) of --set renders by default: the short path (K11:
# quads, perlin), a staged quad scene (K1, K5) and bench.py's headline scene
# (K1)
RENDERS = (("quads", 1200, 600, 64), ("perlin", 1200, 600, 64), ("cornell_box", 600, 600, 64),
           ("bouncing_spheres", 1200, 800, 64))
# (nx, ny, spp) of each scene --scenes may name: chip_smoke.py's renders
SIZES = {**{name: size for name, *size in RENDERS}, "cornell_smoke": (600, 600, 64),
         "final_scene": (800, 800, 16), "original_scene": (800, 800, 16),
         "earth": (1200, 600, 64), "simple_light": (1200, 600, 16),
         "box field": (160, 90, 4)}


def render_cases(cs, dev, reps, scenes):
    """{scene: [{seconds, rays, iterations}] * reps} of ``scenes`` (each
    ``name``, ``name:switch+switch`` rendered under those routes, either
    with ``@spp`` after it for another sample count than SIZES'), after one
    small warm-up render each (the kernels built and loaded)."""
    from art_tpu_torch.ops import routes
    from art_tpu_torch.render.renderer import RenderConfig, render_scene

    out = {}
    for entry in scenes:
        entry, _, spp_arg = entry.partition("@")
        name, _, switches = entry.partition(":")
        on = {k: True for k in switches.split("+") if k}
        nx, ny, spp = SIZES[name]
        spp = int(spp_arg) if spp_arg else spp
        scene = cs._scene(name, nx, ny)
        with routes.using(**on):
            render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=1), device=dev)
            runs = []
            for _ in range(reps):
                _, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp), device=dev)
                runs.append({k: st[k] for k in ("seconds", "rays", "iterations")})
        out[f"{entry} {nx}x{ny} @ {spp}"] = runs
    return out


def _quad_block(tables, o, d):
    """closest_surface_p's quad block in this checkout's port: K5 with its
    winner's attributes, or K5's (t, idx) and the glue after it."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN, p_where
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import quad_attributes_p

    if hasattr(K, "quad_hit_attrs"):
        return K.quad_hit_attrs(tables, o, d, T_MIN)
    t, idx = K.quad_closest_hit(tables, o, d, T_MIN)
    normal, alpha, beta, mat = quad_attributes_p(tables, o, d, t, idx.clamp_min(0))
    hit = t < BIG
    zero = torch.zeros_like(t)
    return (t, p_where(hit, normal, (torch.ones_like(t), zero, zero)),
            torch.where(hit, alpha, zero), torch.where(hit, beta, zero),
            torch.where(hit, mat, torch.zeros_like(mat)))


def _quad_reference(tables, o, d):
    """The quad block in plain PyTorch (both checkouts have these)."""
    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.ops.intersect import miss_defaults, quad_attributes_p, quad_candidates_p

    t, idx = quad_candidates_p(tables, o, d, T_MIN)
    normal, alpha, beta, mat = quad_attributes_p(tables, o, d, t, idx.clamp_min(0))
    normal, (alpha, beta, mat) = miss_defaults(t < BIG, normal, (alpha, beta, mat))
    return t, normal, alpha, beta, mat


def k1_cases(cs, dev, kernels, reps):
    """K1 on 0%, 30% and 100% dead bouncing_spheres pools (module note)."""
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    scene = build_scene("bouncing_spheres", 1200, 800)
    tile_pixels, spp, R = plan_batches(1200 * 800, 64, scene.tables.n_spheres, RenderConfig(),
                                       dev)
    scal = rk.RefillScal(spp, tile_pixels, 3 * tile_pixels, 1200 * 800, 1200, 800)
    rng = np.random.default_rng(cs.SEED + 21)
    for dead in cs.SCAN_DEAD:
        base = cs._random_pool(rng, R, dev)
        base["act"] = torch.from_numpy(rng.random(R) >= dead).to(dev)
        runs = {}
        for fn in (rk.fused_refill, rk.fused_refill_plain):
            pool = cs._clone(base)
            q = torch.zeros(2, dtype=torch.int64, device=dev)
            hist = torch.zeros(8, dtype=torch.int64, device=dev)
            u = fn(pool, scene.camera, q, 0, hist, 3, scal, ncols=10, key=(1984, 3, 1))
            runs[fn] = (pool, q, hist, u)
        torch.cuda.synchronize()
        (kp, kq, kh, ku), (pp, pq, ph, pu) = runs.values()
        differ = sum(cs._bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
        differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
        differ += int((kq != pq).sum() + (kh != ph).sum())
        differ += sum(cs._bits_equal(a, b) for a, b in zip(ku[0] + (ku[1],) + ku[2],
                                                          pu[0] + (pu[1],) + pu[2]))
        work = cs._clone(base)
        q_t = torch.zeros(2, dtype=torch.int64, device=dev)
        hist_t = torch.zeros(8, dtype=torch.int64, device=dev)

        def reset():
            cs._restore(work, base)
            q_t.zero_()

        kernels[f"K1 {round(100 * dead)}% dead"] = dict(ms=cs._timed_ms(
            lambda: rk.fused_refill(work, scene.camera, q_t, 0, hist_t, 3, scal, ncols=10,
                                    key=(1984, 3, 1)), reps, reset=reset), differ=differ)


def k11_cases(cs, dev, kernels, reps):
    """K11 on phase 2c's timed steps."""
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain

    s = cs._short_setup(dev)
    for _, name, iters in cs.SP_TIMED:
        scene_, base, src = s["scenes"][name], s["rendered"][(name, iters)], dict(key=(1984, 2, 1))
        kp, kq, kh, kfb, kl, kd = cs._sp_run(s, sp_step, scene_, base, src)
        pp, pq, ph, pfb, pl, pd = cs._sp_run(s, sp_step_plain, scene_, base, src)
        differ = sum(cs._bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
        differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
        differ += int((kq != pq).sum() + (kh != ph).sum() + (kd != pd).sum() + (kl != pl).sum())
        kernels[f"K11 {name} {iters}"] = dict(
            ms=cs._sp_step_ms(s, sp_step, name, iters, reps), differ=differ,
            fb_rel=float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max()))


def k12_cases(cs, dev, kernels, reps, flush_only=False):
    """K12 on phase 2h's seam pool; with ``flush_only`` also its flush-only
    entry and K1 on that pool, and the census of the pool's flush lanes
    (``sp_kernel.flush_census``)."""
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.sp_kernel import flush_census

    bouncing = build_scene("bouncing_spheres", 1200, 800).to(dev)
    sp = cs._seam_pool(bouncing, 1200, 800, 64, dev, 20)
    base, next_q = sp["pool"], int(sp["q"][0])
    dead = ~base["act"]
    for n in ("r0", "r1", "r2"):
        extra = torch.from_numpy(np.random.default_rng(cs.SEED + 8).random(
            sp["R"], dtype=np.float32)).to(dev)
        base[n].copy_(torch.where(dead & (base[n] == 0), extra, base[n]))
    runs = []
    for fn in (rk.fused_refill_flush, rk.fused_refill_flush_plain):
        pool, fb = cs._clone(base), sp["fb"].clone()
        q = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
        hist = torch.zeros(24, dtype=torch.int64, device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(pool, bouncing.camera, q, 0, hist, 20, sp["scal"], fb, lost, ncols=sp["ncols"],
           key=(1984, 3, 1))
        runs.append((pool, q, hist, fb, lost))
    torch.cuda.synchronize()
    (kp, kq, kh, kfb, kl), (pp, pq, ph, pfb, pl) = runs
    differ = sum(cs._bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
    differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
    differ += int((kq != pq).sum() + (kh != ph).sum() + (kl != pl).sum())
    work, fb_t = cs._clone(base), sp["fb"].clone()
    q_t = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
    hist_t = torch.zeros(24, dtype=torch.int64, device=dev)
    lost_t = torch.zeros(1, dtype=torch.int32, device=dev)

    def reset12():
        cs._restore(work, base)
        fb_t.copy_(sp["fb"])
        q_t[0] = next_q

    def fb_rel(a, b):
        return float(((a - b).abs() / (b.abs() + 1e-6)).max())

    kernels["K12 seam pool"] = dict(ms=cs._timed_ms(lambda: rk.fused_refill_flush(
        work, bouncing.camera, q_t, 0, hist_t, 20, sp["scal"], fb_t, lost_t, ncols=sp["ncols"],
        key=(1984, 3, 1)), reps, reset=reset12), differ=differ, fb_rel=fb_rel(kfb, pfb))
    if not flush_only:
        return
    lit = dead & ((base["r0"] != 0) | (base["r1"] != 0) | (base["r2"] != 0))
    kernels["K12 seam pool"]["flush_census"] = dict(zip(
        ("deaths", "pixel_adds", "shared"), flush_census(base["pix"], lit, sp["fb"].shape[0])))
    kp, pp, kfb, pfb = cs._clone(base), cs._clone(base), sp["fb"].clone(), sp["fb"].clone()
    kl, pl = (torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2))
    rk.flush_dead(kp, kfb, kl)
    rk.flush_dead_plain(pp, pfb, pl)
    torch.cuda.synchronize()
    differ = sum(cs._bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
    differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
    differ += int((kl != pl).sum())
    kernels["flush_dead seam pool"] = dict(
        ms=cs._timed_ms(lambda: rk.flush_dead(work, fb_t, lost_t), reps, reset=reset12),
        differ=differ, fb_rel=fb_rel(kfb, pfb))
    kernels["K1 seam pool"] = dict(ms=cs._timed_ms(lambda: rk.fused_refill(
        work, bouncing.camera, q_t, 0, hist_t, 20, sp["scal"], ncols=sp["ncols"],
        key=(1984, 3, 1)), reps, reset=reset12))


def refill_quad_cases(cs, dev, case, kernels, reps):
    """K1, K11, K12 and K5's block (module note)."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render.integrator import staged_step

    k1_cases(cs, dev, kernels, reps)
    k11_cases(cs, dev, kernels, reps)
    k12_cases(cs, dev, kernels, reps)

    # ---- K5's block on cornell_box's and final_scene's pools ----
    cornell = build_scene("cornell_box", 600, 600).to(dev)
    staged = cs._staged_pool(cornell, 600, 600, 64, dev, 20)
    cp = staged["pool"]
    pools = {"cornell_box": (cornell.tables, (cp["ox"], cp["oy"], cp["oz"]),
                             (cp["dx"], cp["dy"], cp["dz"])),
             "final_scene": cs._route_pools(dev)["final_scene"][:3]}
    for name, (tables, o, d) in pools.items():
        case(f"K5 block {name}", lambda: _quad_block(tables, o, d),
             lambda: _quad_reference(tables, o, d), cs._attrs_differ)
    args = (cs._clone(cp), cornell.camera, staged["q"].clone(), 0, staged["hist"].clone(), 20,
            staged["scal"], cornell.tables, cornell.background, staged["fb"].clone(),
            staged["lost"].clone())
    kernels["staged cornell_box iteration"] = dict(launches=cs._captured_launches(
        lambda: staged_step(*args, key=(7, 0, 0), ncols=staged["ncols"], max_depth=50,
                            gradient=cornell.gradient_bg)))


def _box_block(tables, o, d, quad):
    """closest_surface_p's box block after the quads in this checkout's
    port: K6's merge form on ``quad`` (in place), or K6 and ``_closer``."""
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import _closer

    if hasattr(K, "box_hit_attrs_merge"):
        return K.box_hit_attrs_merge(tables, o, d, quad)
    return _closer(quad, K.box_hit_attrs(tables, o, d))


def box_shade_cases(cs, dev, kernels, reps):
    """K6's block and K3 in both modes (module note)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import _closer, closest_surface_p
    from art_tpu_torch.ops.shade import shade_params_p
    from art_tpu_torch.ops.shade_kernel import REC_F, STATE_F, shade_flush
    from art_tpu_torch.render.integrator import staged_step

    box = cs._box_cases(dev)
    staged = box["staged"]
    cp = staged["pool"]
    cornell = box["cases"]["cornell_box"][0]
    pools = {"cornell_box staged": (cornell.tables, (cp["ox"], cp["oy"], cp["oz"]),
                                    (cp["dx"], cp["dy"], cp["dz"]))}
    for label, (scene, (o, d)) in box["cases"].items():
        pools[f"{label} random"] = (scene.tables, o, d)
    for label, (tables, o, d) in pools.items():
        quad = K.quad_hit_attrs(tables, o, d)
        work = cs._clone_hit(quad)
        got = _box_block(tables, o, d, work)
        want = _closer(K.quad_hit_attrs_plain(tables, o, d), K.box_hit_attrs_plain(tables, o, d))
        torch.cuda.synchronize()
        kernels[f"K6 block {label}"] = dict(
            ms=cs._timed_ms(lambda: _box_block(tables, o, d, work), reps,
                            reset=lambda: cs._restore_hit(work, quad)),
            differ=cs._attrs_differ(got, want))

    def k3_case(name, state, hit, planes, scene, consts, tile_pixels):
        (kp, kfb, kl), (pp, pfb, pl) = cs._k3_runs(state, hit, planes, scene, consts,
                                                   tile_pixels)
        differ = sum(cs._bits_equal(kp[n], pp[n]) for n in STATE_F)
        differ += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "act"))
        differ += int((kl != pl).sum())
        work = cs._clone(state)
        fb = torch.zeros((tile_pixels, 3), device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        kernels[name] = dict(ms=cs._timed_ms(
            lambda: shade_flush(work, hit, planes, scene.background, fb, lost, max_depth=50,
                                gradient=scene.gradient_bg, consts=consts), reps,
            reset=lambda: cs._restore(work, state)), differ=differ,
            fb_rel=float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max()))

    k3 = cs._baked_k3_inputs(dev, box)
    for label in ("cornell_box staged", "cornell_box random", "cornell_box side by side"):
        scene, state, hit, planes, _ = k3[label]
        k3_case(f"K3 baked {label}", state, hit, planes, scene, scene.tables.shade_rows,
                box["tile_pixels"])

    # plane-fed K3 on phase 2a's refilled bouncing_spheres pool
    tables, o, d, tm, state, tile_pixels, scene = _refilled_pool(cs, dev, full=True)
    rng = np.random.default_rng(cs.SEED + 2)
    rec = closest_surface_p(tables, o, d, tm, T_MIN, plain=True)
    params = shade_params_p(tables, rec)
    u = torch.from_numpy(rng.random((4, o[0].shape[0]), dtype=np.float32)).to(dev)
    planes = dict(zip(REC_F, (*rec.p, *rec.normal, *params[:3], *params[3], *params[4], *u)))
    cs._out_of_tile(state, tile_pixels)
    k3_case("K3 plane-fed bouncing_spheres", state, rec.hit, planes, scene, None, tile_pixels)
    k3_case("K3 plane-fed bouncing_spheres side by side", cs._side_by_side(state, tile_pixels, rng),
            rec.hit, planes, scene, None, tile_pixels)
    scene, state, hit, planes, tile_pixels = cs._plane_fed_staged(dev)
    k3_case("K3 plane-fed bouncing_spheres staged", state, hit, planes, scene, None, tile_pixels)

    args = (cs._clone(cp), cornell.camera, staged["q"].clone(), 0, staged["hist"].clone(), 20,
            staged["scal"], cornell.tables, cornell.background, staged["fb"].clone(),
            staged["lost"].clone())
    names = cs._captured_names(lambda: staged_step(*args, key=(7, 0, 0),
                                                   ncols=staged["ncols"], max_depth=50,
                                                   gradient=cornell.gradient_bg))
    kernels["staged cornell_box iteration"] = dict(launches=sum(names.values()), names=names)


def fetch_cases(cs, dev, kernels, reps):
    """The image fetch on phase 2d's pools (module note)."""
    import torch

    from art_tpu_torch.ops.texture_eval import eval_special_p

    for name, f in cs._fetch_pools(dev).items():
        atlas = f["scene"].tables.atlas
        args = (f["img"], f["u"], f["v"], f["needy"])
        rec = f["rec"]
        leaf = (f["scene"].tables, tuple(sp for sp in f["specials"] if sp[1] == "image"),
                rec.mat, rec.u, rec.v, rec.p)
        blocks = {f"sample {name}": lambda plain=False: (atlas.sample(*args, plain=plain),),
                  f"eval_special_p image leaf {name}": lambda plain=False: eval_special_p(
                      *leaf, valid=f["valid"], plain=plain)}
        for label, fn in blocks.items():
            k, p = fn(), fn(plain=True)
            torch.cuda.synchronize()
            kernels[label] = dict(ms=cs._timed_ms(fn, reps), launches=cs._captured_launches(fn),
                                  differ=sum(cs._bits_equal(a.contiguous(), b.contiguous())
                                             for a, b in zip(k, p)),
                                  needy=int(f["needy"].sum()))
        names = cs._staged_names(f)
        kernels[f"staged {name} iteration"] = dict(launches=sum(names.values()), names=names)


def mxu_skip_cases(cs, dev, case):
    """K14, K16 (standalone and tail-only), K17 and K15s (module note)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as csph
    from art_tpu_torch.ops import intersect_kernels as K

    pools = cs._route_pools(dev)
    bt, bo, bd, btm = pools["bouncing_spheres"]
    ft, fo, fd, ftm = pools["final_scene"]
    F, A = bt.sph_mxu_feat, bt.sph_mxu_attr
    case("K14 bouncing_spheres", lambda: K.sphere_mxu_hit_attrs(F, A, bo, bd, btm),
         lambda: K.sphere_mxu_hit_attrs_plain(F, A, bo, bd, btm))
    og = tuple(c - g for c, g in zip(fo, ft.sph_tail_centroid))
    Ft, At = ft.sph_mxu_tail_feat, ft.sph_mxu_tail_attr
    case("K14 final_scene MXU tail", lambda: K.sphere_mxu_hit_attrs(Ft, At, og, fd, ftm),
         lambda: K.sphere_mxu_hit_attrs_plain(Ft, At, og, fd, ftm))
    case("K16 final_scene", lambda: K.sphere_skip_hit_attrs(ft, fo, fd, ftm),
         lambda: K.sphere_skip_hit_attrs_plain(ft, fo, fd, ftm))
    needy = csph.tail_box_needy(ft.sph_tail_box, fo, fd, T_MIN)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    rays = torch.stack([*fo, *fd]).index_select(1, cf.compact_ray_ids(needy))
    ko, kd, kz = tuple(rays[0:3]), tuple(rays[3:6]), torch.zeros_like(rays[0])
    case("K16 final_scene tail-only n_live",
         lambda: K.sphere_skip_hit_attrs(ft, ko, kd, kz, tail_only=True, n_live=cnt),
         lambda: K.sphere_skip_hit_attrs_plain(ft, ko, kd, kz, tail_only=True, n_live=cnt))
    for scene in ("bouncing_spheres", "final_scene"):
        t, o, d, tm = pools[scene]
        case(f"K17 {scene}", lambda: K.sphere_cellbin_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cellbin_hit_attrs_plain(t, o, d, tm))
        case(f"K15s {scene}", lambda: K.sphere_cluster_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cluster_hit_attrs_plain(t, o, d, tm))


def static_cellbin_cases(cs, dev, case, kernels):
    """K13 (both forms, three pools), K17 (two pools) and K2, K16, K15s
    as controls (module note)."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import intersect_kernels as K

    _, nvcc, wall = cs._static_builds()  # the six K13 libraries, built together
    pools = dict(cs._route_pools(dev))
    pools["cornell_box"] = cs._pool_rays(build_scene("cornell_box", 600, 600).to(dev), 600, 600,
                                         64, dev, 20)
    for name in cs.STATIC_SCENES:
        t, o, d, tm = pools[name]
        for expand in (False, True):
            form = "expanded" if expand else "direct"
            case(f"K13 {form} {name}",
                 lambda: K.sphere_static_hit_attrs(t, o, d, tm, expand=expand),
                 lambda: K.sphere_static_hit_attrs_plain(t, o, d, tm, expand=expand))
            kernels[f"K13 {form} {name}"]["nvcc_s"] = nvcc[f"{name} {form}"]
        case(f"K2 {name}", lambda: K.sphere_hit_attrs(t, o, d, tm),
             lambda: K.sphere_hit_attrs_plain(t, o, d, tm))
    kernels["K13 builds"] = dict(wall_s=wall)
    for name in ("bouncing_spheres", "final_scene"):
        t, o, d, tm = pools[name]
        case(f"K17 {name}", lambda: K.sphere_cellbin_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cellbin_hit_attrs_plain(t, o, d, tm))
        need, made = cs._culled_tests(t.sph_cellbin_rows, t.sph_cellbin_meta, o, d, tm, True)
        kernels[f"K17 {name}"].update(tests_needed=need, tests_made=made)
        case(f"K15s {name}", lambda: K.sphere_cluster_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cluster_hit_attrs_plain(t, o, d, tm))
    ft, fo, fd, ftm = pools["final_scene"]
    case("K16 final_scene", lambda: K.sphere_skip_hit_attrs(ft, fo, fd, ftm),
         lambda: K.sphere_skip_hit_attrs_plain(ft, fo, fd, ftm))


def cluster_cases(cs, dev, case, kernels):
    """K15s, K15b and K17 on their pools (module note)."""
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import intersect_kernels as K

    pools = cs._cluster_pools(dev)
    for name in ("bouncing_spheres", "final_scene"):
        t, o, d, tm = pools[name]
        case(f"K15s {name}", lambda: K.sphere_cluster_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cluster_hit_attrs_plain(t, o, d, tm))
        need, made = cs._culled_tests(t.sph_cl_rows, t.sph_cl_meta, o, d, tm, True, head=False)
        kernels[f"K15s {name}"].update(tests_needed=need, tests_made=made)
        case(f"K17 {name}", lambda: K.sphere_cellbin_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cellbin_hit_attrs_plain(t, o, d, tm))
        need, made = cs._culled_tests(t.sph_cellbin_rows, t.sph_cellbin_meta, o, d, tm, True)
        kernels[f"K17 {name}"].update(tests_needed=need, tests_made=made)
    rows, seg, meta, mo, md, mtm = cs._many_cluster_rays(dev)
    label = f"K15s {len(meta[1])} clusters"
    case(label, lambda: K._culled_launch(K.CLUSTER, rows, seg, 0, mo, md, mtm, T_MIN),
         lambda: K.culled_plain(rows, meta, mo, md, mtm, T_MIN, occlusion=True, head=False))
    need, made = cs._culled_tests(rows, meta, mo, md, mtm, True, head=False)
    kernels[label].update(tests_needed=need, tests_made=made)
    for name in ("final_scene", "box field", "rotated field"):
        t, o, d, _ = pools[name]
        case(f"K15b {name}", lambda: K.box_cluster_hit_attrs(t, o, d),
             lambda: K.box_cluster_hit_attrs_plain(t, o, d))
        need, made = cs._box_cluster_tests(t, o, d)
        kernels[f"K15b {name}"].update(tests_needed=need, tests_made=made)


def seam_grid_cases(cs, dev, case, kernels, reps):
    """K12, its flush-only entry, K1 and K11; K10 with K9 as a control
    (module note)."""
    import dataclasses

    from art_tpu_torch.ops import intersect_kernels as K

    k12_cases(cs, dev, kernels, reps, flush_only=True)
    k1_cases(cs, dev, kernels, reps)
    k11_cases(cs, dev, kernels, reps)
    ft, fo, fd, _ = cs._route_pools(dev)["final_scene"]
    case("K9 final_scene", lambda: K.box_grid_cells_hit_attrs(ft, fo, fd),
         lambda: K.box_grid_cells_hit_attrs_plain(ft, fo, fd))
    t10 = dataclasses.replace(ft, box_grid_cells=None, box_grid_cell_rows=None)
    fields = {"final_scene table": (t10, fo, fd),
              "box field": _field_pool(cs, dev, 40, 40, 160, 90)}
    for label, (t, o, d) in fields.items():
        case(f"K10 {label}", lambda: K.box_grid_hit_attrs(t, o, d),
             lambda: K.box_grid_hit_attrs_plain(t, o, d))
        kernels[f"K10 {label}"]["tests"] = cs._grid_test_stats(cs._grid_tests(t, o, d))
    t, o, d = _field_pool(cs, dev, 72, 8, 160, 90)
    case("K9 72x8 field", lambda: K.box_grid_cells_hit_attrs(t, o, d),
         lambda: K.box_grid_cells_hit_attrs_plain(t, o, d))


# the split's renders of --set compact: alone, and with the occlusion gate
# and K16's tail-only call (chip_smoke's "final_scene split" and "split skip")
SPLIT_RENDERS = ("final_scene:compact_sph",
                 "final_scene:compact_sph+occ_gate+sph_skip+compact_skip")


def _split_compaction(cf, needy, planes):
    """The split's compaction in this checkout's port: K4's compaction form,
    or the pipeline it replaced; (ids, cnt, planes_k)."""
    import torch

    if hasattr(cf, "compact"):
        return cf.compact(needy, planes)[:3]
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    ids = cf.compact_ray_ids(needy)
    return ids, cnt, tuple(torch.stack(planes).index_select(1, ids))


def compact_cases(cs, dev, case, kernels, reps):
    """The split's compaction, the split, and K2, K16 and K1 as controls
    (module note)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as csph
    from art_tpu_torch.ops import intersect_kernels as K

    def differ(a, b):
        return cs._compaction_differ((*a, None), (*b[:3], None))

    for name, (needy, planes) in cs._compaction_pools(dev).items():
        blocks = {f"compaction {name}": lambda: _split_compaction(cf, needy, planes),
                  f"K4 flush pipeline {name}": lambda: cs._parent_compaction(needy, planes)}
        for label, fn in blocks.items():
            case(label, fn, lambda: cs._parent_compaction(needy, planes), differ)
            names = cs._captured_names(fn)
            kernels[label].update(launches=sum(names.values()), names=names,
                                  needy=int(needy.sum()))
    f = cs._fetch_pools(dev)["final_scene"]
    t, p = f["scene"].tables, f["s"]["pool"]
    o, d, tm = (p["ox"], p["oy"], p["oz"]), (p["dx"], p["dy"], p["dz"]), p["tm"]
    for skip in (False, True):
        label = "split K16 tail-only" if skip else "split K2 tail"
        fn = lambda skip=skip: csph.sphere_hit_attrs_split(t, o, d, tm, skip_tail=skip)
        case(label, fn, lambda: csph.sphere_hit_attrs_split(t, o, d, tm, skip_tail=skip,
                                                            plain=True))
        names = cs._captured_names(fn)
        kernels[label].update(launches=sum(names.values()), names=names)
    needy = csph.tail_box_needy(t.sph_tail_box, o, d, T_MIN)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    rays = torch.stack([*o, *d]).index_select(1, cf.compact_ray_ids(needy))
    ko, kd, kz = tuple(rays[0:3]), tuple(rays[3:6]), torch.zeros_like(rays[0])
    case("K2 final_scene tail n_live",
         lambda: K.sphere_hit_attrs(t, ko, kd, kz, rows=t.sph_tail_rows, n_live=cnt),
         lambda: K.sphere_hit_attrs_plain(t, ko, kd, kz, rows=t.sph_tail_rows, n_live=cnt))
    case("K16 final_scene tail-only n_live",
         lambda: K.sphere_skip_hit_attrs(t, ko, kd, kz, tail_only=True, n_live=cnt),
         lambda: K.sphere_skip_hit_attrs_plain(t, ko, kd, kz, tail_only=True, n_live=cnt))
    k1_cases(cs, dev, kernels, reps)


def intersect_cases(cs, dev, case):
    """The sphere and box kernels (K2, K9, K10, K15s, K16, K17)."""
    import dataclasses

    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as csph
    from art_tpu_torch.ops import intersect_kernels as K

    bt, bo, bd, btm = _refilled_pool(cs, dev)
    case("K2 bouncing 2a", lambda: K.sphere_hit_attrs(bt, bo, bd, btm),
         lambda: K.sphere_hit_attrs_plain(bt, bo, bd, btm))
    case("K2 bouncing 2a t_min 0.25", lambda: K.sphere_hit_attrs(bt, bo, bd, btm, 0.25),
         lambda: K.sphere_hit_attrs_plain(bt, bo, bd, btm, 0.25))
    pools = cs._route_pools(dev)
    for scene in ("bouncing_spheres", "final_scene"):
        t, o, d, tm = pools[scene]
        case(f"K2 {scene}", lambda: K.sphere_hit_attrs(t, o, d, tm),
             lambda: K.sphere_hit_attrs_plain(t, o, d, tm))
        case(f"K17 {scene}", lambda: K.sphere_cellbin_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cellbin_hit_attrs_plain(t, o, d, tm))
        case(f"K15s {scene}", lambda: K.sphere_cluster_hit_attrs(t, o, d, tm),
             lambda: K.sphere_cluster_hit_attrs_plain(t, o, d, tm))
    ft, fo, fd, ftm = pools["final_scene"]
    case("K16 final_scene", lambda: K.sphere_skip_hit_attrs(ft, fo, fd, ftm),
         lambda: K.sphere_skip_hit_attrs_plain(ft, fo, fd, ftm))
    needy = csph.tail_box_needy(ft.sph_tail_box, fo, fd, T_MIN)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    rays = torch.stack([*fo, *fd]).index_select(1, cf.compact_ray_ids(needy))
    ko, kd, kz = tuple(rays[0:3]), tuple(rays[3:6]), torch.zeros_like(rays[0])
    case("K2 final_scene tail n_live",
         lambda: K.sphere_hit_attrs(ft, ko, kd, kz, rows=ft.sph_tail_rows, n_live=cnt),
         lambda: K.sphere_hit_attrs_plain(ft, ko, kd, kz, rows=ft.sph_tail_rows, n_live=cnt))
    case("K9 final_scene", lambda: K.box_grid_cells_hit_attrs(ft, fo, fd),
         lambda: K.box_grid_cells_hit_attrs_plain(ft, fo, fd))
    t10 = dataclasses.replace(ft, box_grid_cells=None, box_grid_cell_rows=None)
    case("K10 final_scene table", lambda: K.box_grid_hit_attrs(t10, fo, fd),
         lambda: K.box_grid_hit_attrs_plain(t10, fo, fd))
    scene = build_scene("cornell_box", 600, 600).to(dev)
    ct, cp = scene.tables, cs._staged_pool(scene, 600, 600, 64, dev, 1)["pool"]
    co, cd, ctm = (cp["ox"], cp["oy"], cp["oz"]), (cp["dx"], cp["dy"], cp["dz"]), cp["tm"]
    case("K2 cornell_box", lambda: K.sphere_hit_attrs(ct, co, cd, ctm),
         lambda: K.sphere_hit_attrs_plain(ct, co, cd, ctm))
    t, o, d = _field_pool(cs, dev, 40, 40, 160, 90)
    case("K10 box field", lambda: K.box_grid_hit_attrs(t, o, d),
         lambda: K.box_grid_hit_attrs_plain(t, o, d))
    t, o, d = _field_pool(cs, dev, 72, 8, 160, 90)
    case("K9 72x8 field", lambda: K.box_grid_cells_hit_attrs(t, o, d),
         lambda: K.box_grid_cells_hit_attrs_plain(t, o, d))


if __name__ == "__main__":
    sys.exit(main())
