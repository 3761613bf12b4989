#!/usr/bin/env python3
"""On-card smoke test of art_tpu_torch (the PyTorch/CUDA port) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each runs; any failure exits non-zero without the final result):
 1. the card (``nvidia-smi`` name and power limit), ``nvcc``, and the build of
    every kernel from ``art_tpu_torch/csrc`` (one nvcc per source, in
    parallel; timed);
 1b. the registers, local-memory spills and hot-loop instructions of K2, K9
    (both forms), K10, K7 (its octave in each form), K11 (held to 64
    registers), K1, K12, K5, K6 (both forms), K3 (both modes), K14, K16,
    K17 (the fewest instructions a row of its group scans; also K15's
    spheres) and K15's boxes (both forms, instructions a (ray, box) pair) in
    the built library (``scripts/sass_loops.py``); K13 built per scene and form for
    bouncing_spheres, final_scene and cornell_box, all six nvcc started
    together (seconds each), with the code size, registers, spills and the
    fewest instructions a row of its group loops of bouncing_spheres' and
    final_scene's libraries in the scene's form (``sph_expand``);
 2. each kernel against its plain PyTorch twin on the card, with inputs and
    injected uniforms from a numpy seed, then both timed with CUDA events
    behind a device spin, beside the least time the card could take for the
    same work (bound): K1 refill, K2 sphere hit and plane-fed K3 shade+flush
    at the pool size R that ``plan_batches`` picks for bouncing_spheres
    1200x800 (K3 also with the pool's samples side by side, and on a
    bouncing_spheres render's pool 20 staged iterations in); K5 quad hit
    with its winner's attributes (bit-equal to its twin in all seven
    outputs on random rays, a cornell_box 600x600 @ 64 pool 20 staged
    iterations in and 2f's final_scene pool; timed beside the PyTorch glue
    it replaced, with that glue's launches and those of a staged
    cornell_box iteration), K6 box hit (rotated: cornell_box; unrotated: a
    scene of translated boxes) in its plain form and in its merge form
    (bit-equal to K6 plus ``_closer`` in all seven outputs, timed beside
    them on the staged pool), and baked K3 (cornell_box's staged pool, a
    random cornell_box pool, also with its samples side by side, and a
    checker scene) at cornell_box 600x600's R, every K3 bit-equal to its
    twin in its state, its framebuffer within 1e-6 of ``flush_warp_p``'s
    order, with the share of a warp's deaths that share a pixel;
    K7 turbulence (depth 7, depth 2, with a per-lane octave mask) bit-equal
    to its twin at the hit points of perlin rays 20 iterations into a
    render (R = 2^17; camera rays) and 21 (their bounces), of a final_scene
    staged pool (2f's) and at random points (each lane its own cell), timed
    on each with the share of warp-octaves in each form of its shared
    gradients and a bound from the distinct lattice points the input needs;
    baked K3 with perlin's noise planes on those rays, and K11 (the short
    path) on the quads and perlin tables in both uniform modes, from a
    random pool and from pools 20 (and perlin's 21) iterations into a
    render, timed on perlin 20 and 21 and quads 20; K4 (flush_accumulate)
    in its compaction use on an earth pool 20 iterations into a render
    (R = 2^17) and on a colliding flush into a window at a base row, K8
    (table_gather_u24) on that pool's texel slots with out-of-range indices,
    and the compacted fetch against the dense gather at 0, about 30% and
    100% needy lanes, timed against the one-call dense gather (K8's and K4's
    flush form's ``launches`` are 0: no render runs them; these calls are their
    ``check_calls``); K4's compaction form (``compact``, one launch: ids,
    count, rank and six ray planes) bit-equal to its twin and to the
    pipeline it replaced (K4's flush form with the rank, count and gather
    around it) on that earth pool and a final_scene pool 20 iterations in
    (the split's needy lanes), at their own needy lanes, at 0, one lane,
    30% and 100% and at R - 100 lanes (a pad), every slot and rank written
    over a sentinel, timed beside that pipeline (device ms and launches by
    kernel name), its twin and ``torch.nonzero``; K8's fetch form (atlas_fetch, the
    whole ``ImageAtlas.sample(..., needy)`` in one launch) bit-equal to its
    twin on that pool at 0, 30%, the rendered and 100% needy lanes, on lanes
    with NaN, infinite and out-of-range (u, v) and image ids, equal to the
    compacted pipeline it replaced, and on a final_scene pool 20 iterations
    in through ``eval_special_p``; timed on both pools beside the dense
    ``where(needy, index_select)`` and the replaced pipeline, with the
    launches of a staged earth and final_scene iteration by kernel name;
    the launches and device time of felt's plain-PyTorch noise;
    2e. on a final_scene pool 20 iterations into a render (R = 2^17): K9
    (box_grid_cells) and K10 (box_grid, final_scene's table with its cell
    list dropped) equal to their twins, K9's form and the share of lanes
    and warps its skip predicate leaves untested (each a miss), K9 against
    K10 and against K6 over the same 400 boxes; K10 equal to its twin on
    the 40x40 box field's pool (its own path: 1600 cells, rays whose
    winners lie past the 1024th) and timed there, with the (ray, cell)
    tests its culled walk makes there and on final_scene's table; K9's
    per-cell form on a 72x8 field's pool, equal to its twin; K2 bit-equal
    to its twin on the final_scene pool and timed there; the split sphere pass equal to
    its twin and to the full-table K2 but on exact head/tail ties, K2 with
    n_live equal to its twin on the compacted slots, K2 with n_live and
    K16's tail-only call unchanged when the compacted rays past the count
    are NaN, the split (K2 or K16 tail) bit-equal to the split on the
    pipeline K4's compaction form replaced; times of each, of the split
    against the full-table K2 and that split, and the launches of the
    split and of a whole staged final_scene iteration; K18 (the media)
    bit-equal to its twin on that pool, a cornell_smoke pool and a table of
    every medium kind, one launch a call, its time, bound and host time
    (``media_checks``);
    2f. K16 (skip bins: standalone, and tail-only with n_live on the split's
    compacted slots) and K17 (cell bins: bouncing_spheres' whole-set 4x4
    lattice, final_scene's 3x3x3 tail lattice) bit-equal to their twins on
    a bouncing_spheres 1200x800 pool and a final_scene 800x800 pool 20
    staged iterations in (R = 2^17), and equal in t to the full-table K2
    with their exact ties between segments counted; K2 bit-equal to its
    twin there; their times, the full-table K2's, and bounds from the
    (ray, sphere) tests those rays need, beside the tests their threads
    make; then ``closest_surface_p`` under
    every opt-in sphere route (ROUTE_RUNS) equal to its plain record and to
    the default route's, launching the route's sphere kernels;
    2g. K15 (``ART_TPU_CLUSTER``): its spheres (K17's kernel with no head)
    on 2f's bouncing_spheres and final_scene pools and on a table of more
    than 64 clusters (4500 spheres, R = 2^17 aimed rays), its boxes on that
    final_scene pool, the box field's pool (2e's) and a rotated field's (144
    boxes turned about y, 320x240 @ 64, 20 staged iterations in, R = 2^17),
    each bit-equal to its twin and equal in t to the full-table K2 / K6
    with the exact ties counted, timed beside the full-table kernel with
    bounds from the (ray, primitive) tests those rays need, the tests its
    warps make, and its registers, spills and SASS instructions a pair
    (phase 1b's) for every pool; ``closest_surface_p`` under
    CLUSTER and under BVH (``ART_TPU_BVH``, the plain per-ray descent)
    equal to its plain record and, in t, to the default route's (with the
    boxes through K6 under CLUSTER), launching the route's kernels and under
    BVH no sphere kernel; the descent's steps and time a call;
    2h. K12 (``ART_TPU_SEAM_FLUSH``'s seam flush) on a bouncing_spheres pool
    20 seam iterations in, with injected and Philox uniforms, bit-equal to
    its twin and (but for the zeroed dead radiance) to K1, its framebuffer
    within 1e-6 relative (flush_warp's per-pixel sums; their census on the
    pool); K13 (``ART_TPU_SPH_STATIC``, phase 1b's builds)
    on the bouncing_spheres, final_scene and a cornell_box pool in both
    quadratic forms, bit-equal to its twin, the direct form equal to the full-table
    K2 in t on every lane, the expanded form within its rounding bound;
    K14 (``ART_TPU_MXU_SPHERES``) on the bouncing_spheres pool and the
    split's MXU-tail dense branch (``ART_TPU_MXU_TAIL``) on the final_scene
    pool, each bit-equal to its twin and against K2 at the TPU tests' bars;
    every lane where an expanded form parts from K2 explained (a self-hit
    of a ray leaving a sphere, a grazing ray, or K2's t within K14's 2 t_min
    margin) and their count held to a bar; K12's flush-only entry bit-equal to its
    twin; ``closest_surface_p`` under each switch equal to its plain record;
    2i. the refill core's one-launch look-back scan: K1, K12 and K11 (quads)
    against their twins on pools with 0%, 30% and 100% of the slots dead at
    R = 2^17 and on a 2^22 + 100-slot pool (16,385 blocks, more than the
    card holds at once), each for two consecutive calls of one dispatch on
    one persistent scratch and then a new dispatch at it = 0, the scratch's
    ticket back at 0 and every word its block's inclusive prefix after each
    call; K1 timed on each dead share;
 3. the in-kernel Philox uniforms: range, mean, variance, and that they
    change across iterations and slots;
 4. renders through ``render_scene`` on the card, each with the launch
    counts set to 0 just before it and read just after:
    three_spheres 400x225 @ 16 (baked K3), bouncing_spheres 1200x800 @ 64
    (K1, K2, plane-fed K3), cornell_box 600x600 @ 64 (K1, K5, K6's merge
    form, K2, baked K3) and boxes with no quad, 320x320 @ 16 (K6's plain
    form); then the short path (K11 alone): quads and perlin 1200x600
    @ 64, checkered_spheres and simple_light_book 1200x600 @ 16, and perlin
    1200x600 @ 64 staged (K1, K2, K7, baked K3 with its noise planes), which
    must agree statistically with the short-path image; then the image
    scenes, three renders each: earth 1200x600 @ 64 (K1, K2, K8's fetch
    form, baked K3) and simple_light 1200x600 @ 16 (K1, K5, K2, K7, K8's
    fetch form, baked K3); then the big scenes: final_scene 800x800 @ 16
    (K1, K5, K9, the full-table K2 once an iteration, K8's fetch form for
    the image, K7, baked K3
    and K18 for the media once an iteration), original_scene 800x800 @ 16,
    cornell_smoke 600x600 @ 64 (K1, K5, K18 over two box media, baked K3)
    and a 40x40 box field
    (1600 boxes: K10), each finite, >= 0 and not black; then each opt-in
    sphere route (``art_tpu_torch/ops/routes.py``) at full width, route /
    default: bouncing_spheres 1200x800 @ 64 under
    SPH_CELLBIN (K17), final_scene 800x800 @ 16 under SPH_CELLBIN (K17),
    SPH_SKIP (K16), the split with OCC_GATE and K16's tail-only call, the
    split's forced dense branch with COMPACT_CELLBIN (K17), and the split
    alone (the splits compacting with K4's compaction form), and K15's route (CLUSTER_RUNS)
    default / route / route / default: final_scene 800x800 @ 16 (K15's
    spheres and boxes),
    bouncing_spheres 1200x800 @ 64 and the box field (K15's boxes in place
    of K10), each route render launching its own
    kernels; then bouncing_spheres 1200x800 @ 1 under the BVH descent (no
    sphere kernel; the spp cut to fit the run); then this slice's routes
    (SLICE8_RUNS) route / default: the seam route on bouncing_spheres
    1200x800 @ 16 and cornell_box 600x600 @ 16 (K12 in place of K1 and K3,
    its flush-only entry once a tile),
    K13 and K14 on bouncing_spheres 1200x800 @ 64, K13 and the MXU-tail
    split on final_scene 800x800 @ 16; then, per scene and route
    (perlin staged and the box field included), the kernel path against the
    plain path on the same injected uniforms (``n_uniform_cols`` rows) and,
    but for the box field's default path, with independent seeds,
    statistically (a route against the default route);
 5. checkpoint and resume: cornell_box 600x600 @ 16 (six dispatches)
    uninterrupted, interrupted after three dispatches by an exception from a
    wrapped ``render_wavefront``, and resumed (its launches read as a
    render's), the resumed image within 1e-5 relative and 1e-6 absolute of
    the uninterrupted one on every pixel (the measured maximum reported), the
    seconds of one save;
 6. multi-device rendering (``art_tpu_torch.parallel``), every world of
    child processes started by ``spawn_ranks`` after the kernels are built,
    with a timeout (a failed or late rank fails the phase): a world of one
    on NCCL, cornell_box 600x600 @ 16 sharded against ``render_scene``
    (three interleaved pairs: rays equal, every pixel within 1e-5 relative
    and 1e-6 absolute); the error NCCL gives two ranks of one communicator
    on one card (recorded); two ranks on gloo, each on cuda:0, 2x1 and 1x2
    meshes over cornell_smoke 600x600 @ 16 and earth 1200x600 @ 16, each
    held to ``render_scene`` by the gate for independent renders, ``spp`` at
    least the config's, the 1x2 shards' partial sums apart, each rank's
    launches its scene's path; a 1x2 cornell_box 600x600 @ 16 interrupted
    after three of six dispatches and resumed within phase 5's bars; the
    seconds, Mrays/s and the collectives' ms a dispatch of each run (the
    wait for the slowest rank included) and of one all-reduce of the tile
    after a barrier, with the backend and the world size.

Standard output ends with a JSON line of per-kernel results (each kernel's
``launches`` counted in the first default-route render that runs it, in
the order bouncing_spheres, final_scene, cornell_box, the image and
short-path scenes, the others; else in its opt-in route's render, K4's
compaction form's in the plain split's; K8's and K4's flush form's 0, on no
render's path; named by ``launches_path``), the
card's name and power limit, and then
``{"ok": true, "device": {...}}``.  Needs
``torch.cuda.is_available()``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 2026
N_OUT = 8  # live slots at their last bounce with a pixel outside the tile
SPIN_CYCLES = 40_000_000  # ~20 ms of device spin: longer than any call's host enqueue
# (scene, nx, ny, spp) of the renders
CORNELL = ("cornell_box", 600, 600, 64)
BOUNCING = ("bouncing_spheres", 1200, 800, 64)
THREE = ("three_spheres", 400, 225, 16)
# _box_scene without its floor: boxes and a sphere, no quad
BOXES_ALONE = ("boxes alone", 320, 320, 16)
# the big-scene slice's paths: (label, scene, nx, ny, spp, renders); the
# first is its main path (rendered ten times more in ROUTE_RUNS' default
# turns); "box field" is the 40x40 field of _box_field (1600 boxes, so no K9
# cell table: K10)
BIG_SCENES = [("final_scene", "final_scene", 800, 800, 16, 1),
              ("original_scene", "original_scene", 800, 800, 16, 1),
              ("cornell_smoke", "cornell_smoke", 600, 600, 64, 1),
              ("box field", "box field", 160, 90, 4, 1)]
# the image slice's paths, three renders each: (label, scene, nx, ny, spp,
# short_path)
IMAGE = [("earth", "earth", 1200, 600, 64, None),
         ("simple_light", "simple_light", 1200, 600, 16, None)]
IMAGE_RENDERS = 3
# the short-path slice's paths, the first its main path
SHORT = [("perlin", "perlin", 1200, 600, 64, None),
         ("quads", "quads", 1200, 600, 64, None),
         ("checkered_spheres", "checkered_spheres", 1200, 600, 16, None),
         ("simple_light_book", "simple_light_book", 1200, 600, 16, None),
         ("perlin staged", "perlin", 1200, 600, 64, False)]
# (nx, ny, spp) of the kernel-vs-plain renders, per scene
SAME_UNIFORMS = {"three_spheres": (64, 32, 16), "bouncing_spheres": (64, 32, 16),
                 "cornell_box": (64, 64, 16), "quads": (64, 32, 16),
                 "checkered_spheres": (64, 32, 16), "perlin": (64, 32, 16),
                 "simple_light_book": (64, 32, 16), "perlin staged": (64, 32, 16),
                 "earth": (64, 32, 16), "simple_light": (64, 32, 16),
                 "cornell_smoke": (64, 64, 16), "final_scene": (64, 64, 16),
                 "original_scene": (64, 64, 16), "box field": (64, 36, 16)}
INDEPENDENT = {"three_spheres": (96, 64, 256), "bouncing_spheres": (96, 64, 256),
               "cornell_box": (96, 96, 256), "quads": (96, 64, 256),
               "checkered_spheres": (96, 64, 256), "perlin": (96, 64, 256),
               "simple_light_book": (96, 64, 256), "earth": (96, 64, 256),
               "simple_light": (96, 64, 256), "cornell_smoke": (64, 64, 256),
               "final_scene": (64, 64, 256), "original_scene": (64, 64, 256),
               "box field": (64, 40, 256)}
KERNELS = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "refill": ("art_tpu_torch/csrc/refill.cu", "art_tpu/ops/refill_kernel.py:284"),
    "sphere_hit": ("art_tpu_torch/csrc/sphere_hit.cu",
                   "art_tpu/ops/pallas_kernels.py:282"),
    "shade_flush": ("art_tpu_torch/csrc/shade_flush.cu",
                    "art_tpu/ops/shade_kernel.py:331"),
    "shade_flush_baked": ("art_tpu_torch/csrc/shade_flush.cu",
                          "art_tpu/ops/shade_kernel.py:331"),
    "quad_hit": ("art_tpu_torch/csrc/quad_hit.cu", "art_tpu/ops/pallas_kernels.py:1890"),
    "box_hit": ("art_tpu_torch/csrc/box_hit.cu", "art_tpu/ops/pallas_kernels.py:2139"),
    # K6's merge form, after the quads (with art_tpu's jnp merge,
    # art_tpu/ops/intersect.py:593-595, 726-740)
    "box_hit_merge": ("art_tpu_torch/csrc/box_hit.cu", "art_tpu/ops/pallas_kernels.py:2139"),
    "turb": ("art_tpu_torch/csrc/turb.cu", "art_tpu/ops/perlin_kernel.py:113"),
    "sp_step": ("art_tpu_torch/csrc/sp_step.cu", "art_tpu/ops/sp_kernel.py:571"),
    "flush_accumulate": ("art_tpu_torch/csrc/flush_accumulate.cu",
                         "art_tpu/ops/flush_kernel.py:196"),
    # K4's compaction form: K4 (:196) as art_tpu/ops/compact_fetch.py:192
    # compact_ray_ids calls it, with the rank, count and ray gather around it
    # (art_tpu/ops/compact_sphere.py)
    "compact": ("art_tpu_torch/csrc/compact.cu", "art_tpu/ops/flush_kernel.py:196"),
    "table_gather_u24": ("art_tpu_torch/csrc/table_gather.cu",
                         "art_tpu/ops/flush_kernel.py:147"),
    # K8's fetch form: compact_gather's K8 (:147) and K4 (:196) as
    # art_tpu/ops/compact_fetch.py:87 calls them, with ImageAtlas.sample's
    # texel index and unpack (art_tpu/utils/images.py)
    "atlas_fetch": ("art_tpu_torch/csrc/table_gather.cu", "art_tpu/ops/flush_kernel.py:147"),
    "box_grid_cells": ("art_tpu_torch/csrc/box_grid.cu",
                       "art_tpu/ops/pallas_kernels.py:2435"),
    "box_grid": ("art_tpu_torch/csrc/box_grid.cu", "art_tpu/ops/pallas_kernels.py:2297"),
    "sphere_skip": ("art_tpu_torch/csrc/sphere_skip.cu",
                    "art_tpu/ops/pallas_kernels.py:1353"),
    "sphere_cellbin": ("art_tpu_torch/csrc/sphere_cellbin.cu",
                       "art_tpu/ops/pallas_kernels.py:1798"),
    # K15's spheres: K17's kernel with no head, counted as its own launch
    "sphere_cluster": ("art_tpu_torch/csrc/sphere_cellbin.cu",
                       "art_tpu/ops/pallas_kernels.py:896"),
    "box_cluster": ("art_tpu_torch/csrc/box_cluster.cu",
                    "art_tpu/ops/pallas_kernels.py:2601"),
    "refill_flush": ("art_tpu_torch/csrc/refill_flush.cu",
                     "art_tpu/ops/refill_kernel.py:523"),
    # K12's flush half alone: the seam route's last flush, after the loop,
    # which art_tpu makes with K4 (art_tpu/render/integrator.py:906-921)
    "flush_dead": ("art_tpu_torch/csrc/refill_flush.cu", "art_tpu/ops/flush_kernel.py:196"),
    "sphere_static": ("art_tpu_torch/csrc/sphere_static.cu",
                      "art_tpu/ops/pallas_kernels.py:520"),
    "sphere_mxu": ("art_tpu_torch/csrc/sphere_mxu.cu", "art_tpu/ops/pallas_kernels.py:730"),
    # K18: the media in one launch, where art_tpu has jnp and no Pallas kernel
    "media": ("art_tpu_torch/csrc/media.cu", "none (jnp art_tpu/ops/intersect.py:844)"),
}
# which renders of phase 4 must launch which kernels (the launch-count gate);
# a render may launch no kernel of KERNELS outside its own list
PATHS = {"three_spheres": ("refill", "sphere_hit", "shade_flush_baked"),
         "bouncing_spheres": ("refill", "sphere_hit", "shade_flush"),
         "cornell_box": ("refill", "quad_hit", "box_hit_merge", "sphere_hit",
                         "shade_flush_baked"),
         # boxes with no quad before them: K6's plain form
         "boxes alone": ("refill", "box_hit", "sphere_hit", "shade_flush_baked"),
         "perlin": ("sp_step",), "quads": ("sp_step",), "checkered_spheres": ("sp_step",),
         "simple_light_book": ("sp_step",),
         "perlin staged": ("refill", "sphere_hit", "turb", "shade_flush_baked"),
         # an image's texels through K8's fetch form, one launch; no render
         # compacts the fetch (K4 and K8), as art_tpu compacts only on the TPU
         "earth": ("refill", "sphere_hit", "atlas_fetch", "shade_flush_baked"),
         "simple_light": ("refill", "quad_hit", "sphere_hit", "turb", "atlas_fetch",
                          "shade_flush_baked"),
         # the full-table K2 once an iteration (the split is opt-in); K8's
         # fetch form for the earth image
         "final_scene": ("refill", "quad_hit", "box_grid_cells", "sphere_hit",
                         "atlas_fetch", "turb", "shade_flush_baked"),
         "original_scene": ("refill", "quad_hit", "box_grid_cells", "sphere_hit",
                            "atlas_fetch", "turb", "shade_flush_baked"),
         "cornell_smoke": ("refill", "quad_hit", "shade_flush_baked"),
         "box field": ("refill", "box_grid", "shade_flush_baked"),
         # the opt-in sphere routes (ROUTE_RUNS)
         "bouncing_spheres cellbin": ("refill", "sphere_cellbin", "shade_flush"),
         "final_scene cellbin": ("refill", "quad_hit", "box_grid_cells", "sphere_cellbin",
                                 "atlas_fetch", "turb", "shade_flush_baked"),
         "final_scene skip": ("refill", "quad_hit", "box_grid_cells", "sphere_skip",
                              "atlas_fetch", "turb", "shade_flush_baked"),
         # K2 over the head, K4's compaction form, K16's tail-only call
         "final_scene split skip": ("refill", "quad_hit", "box_grid_cells", "sphere_hit",
                                    "sphere_skip", "compact", "atlas_fetch", "turb",
                                    "shade_flush_baked"),
         # the dense branch is K17 alone: no compaction
         "final_scene split dense": ("refill", "quad_hit", "box_grid_cells", "sphere_cellbin",
                                     "atlas_fetch", "turb", "shade_flush_baked"),
         "final_scene split": ("refill", "quad_hit", "box_grid_cells", "sphere_hit",
                               "compact", "atlas_fetch", "turb", "shade_flush_baked"),
         # ART_TPU_CLUSTER (CLUSTER_RUNS): K15's spheres in place of K2, its
         # boxes in place of K9 and K10
         "final_scene cluster": ("refill", "quad_hit", "box_cluster", "sphere_cluster",
                                 "atlas_fetch", "turb", "shade_flush_baked"),
         "bouncing_spheres cluster": ("refill", "sphere_cluster", "shade_flush"),
         "box field cluster": ("refill", "box_cluster", "shade_flush_baked"),
         # ART_TPU_BVH: the per-ray descent is plain PyTorch, no sphere kernel
         "bouncing_spheres bvh": ("refill", "shade_flush"),
         # this slice's routes (SLICE8_RUNS): the seam route's K12 in place of
         # K1 and K3 (its shading is plain PyTorch) and its flush-only entry
         # once a tile, K13 or K14 in place of K2, and K2 with K14 in the
         # split's MXU-tail dense branch
         "bouncing_spheres seam": ("refill_flush", "flush_dead", "sphere_hit"),
         "cornell_box seam": ("refill_flush", "flush_dead", "quad_hit", "box_hit_merge",
                              "sphere_hit"),
         "bouncing_spheres static": ("refill", "sphere_static", "shade_flush"),
         "bouncing_spheres mxu": ("refill", "sphere_mxu", "shade_flush"),
         "final_scene static": ("refill", "quad_hit", "box_grid_cells", "sphere_static",
                                "atlas_fetch", "turb", "shade_flush_baked"),
         # the dense branch: K2 over the head, K14 over the tail, no compaction
         "final_scene split mxu tail": ("refill", "quad_hit", "box_grid_cells", "sphere_hit",
                                        "sphere_mxu", "atlas_fetch", "turb",
                                        "shade_flush_baked")}
# the scenes with media launch K18 once an iteration, on every route
MEDIA_SCENES = ("final_scene", "original_scene", "cornell_smoke")
PATHS.update({label: path + ("media",) for label, path in PATHS.items()
              if label.split()[0] in MEDIA_SCENES})
# the checkpoint phase's render: six (tile, chunk) dispatches (tiles of
# 60,032 pixels, one chunk of 16 samples), interrupted after CHECKPOINT_STOP
CHECKPOINT = ("cornell_box", 600, 600, 16)
CHECKPOINT_STOP = 3
# phase 6, multi-device rendering (art_tpu_torch.parallel): the world of one
# (NCCL) against render_scene in MESH_PAIRS interleaved pairs; two ranks on
# the one card (gloo) over MESH_SCENES (the scenes of __graft_entry__'s
# multi-chip dry run) on each mesh of MESH_SHAPES; MESH_CHECKPOINT on a 1x2
# mesh (six dispatches of 60,032-pixel tiles, 8 samples a rank), interrupted
# after CHECKPOINT_STOP; the seconds a world may take
MESH_ONE = ("cornell_box", 600, 600, 16)
MESH_PAIRS = 3
MESH_SCENES = (("cornell_smoke", 600, 600, 16), ("earth", 1200, 600, 16))
MESH_SHAPES = ((2, 1), (1, 2))
MESH_CHECKPOINT = ("cornell_box", 600, 600, 16)
MESH_TIMEOUT = 300
NCCL_SHARED_TIMEOUT = 90
# the opt-in sphere routes of the culling slice (art_tpu_torch/ops/routes.py),
# each rendered at full width route / default against the default route:
# (label, scene, nx, ny, spp, the switches); COMPACT_SKIP acts with SPH_SKIP,
# as in art_tpu
ROUTE_RUNS = [
    ("bouncing_spheres cellbin", "bouncing_spheres", 1200, 800, 64, dict(sph_cellbin=True)),
    ("final_scene cellbin", "final_scene", 800, 800, 16, dict(sph_cellbin=True)),
    ("final_scene skip", "final_scene", 800, 800, 16, dict(sph_skip=True)),
    ("final_scene split skip", "final_scene", 800, 800, 16,
     dict(compact_sph=True, occ_gate=True, sph_skip=True, compact_skip=True)),
    ("final_scene split dense", "final_scene", 800, 800, 16,
     dict(compact_sph=True, force_branch="dense", compact_cellbin=True)),
    ("final_scene split", "final_scene", 800, 800, 16, dict(compact_sph=True))]
# K15's route (ART_TPU_CLUSTER), rendered default / route / route / default,
# and the per-ray
# BVH descent (ART_TPU_BVH), rendered once at full resolution with the spp cut
# to fit the run's time: a descent step is ~75 PyTorch launches (~1 ms on the
# H100's host) and a call ~180 steps, so an iteration takes ~0.15-0.19 s and a
# 1200x800 render at 1 spp (~560 iterations) ~80 s
CLUSTER_RUNS = [
    ("final_scene cluster", "final_scene", 800, 800, 16, dict(cluster=True)),
    ("bouncing_spheres cluster", "bouncing_spheres", 1200, 800, 64, dict(cluster=True)),
    ("box field cluster", "box field", 160, 90, 4, dict(cluster=True))]
BVH_RUN = ("bouncing_spheres bvh", "bouncing_spheres", 1200, 800, 1, dict(bvh=True))
# this slice's opt-in routes, each rendered at full width route / default:
# the seam route (ART_TPU_SEAM_FLUSH, K12), K13 (ART_TPU_SPH_STATIC), K14
# (ART_TPU_MXU_SPHERES) and the split's MXU-tail dense branch
# (ART_TPU_MXU_TAIL)
SLICE8_RUNS = [
    ("bouncing_spheres seam", "bouncing_spheres", 1200, 800, 16, dict(seam_flush=True)),
    ("cornell_box seam", "cornell_box", 600, 600, 16, dict(seam_flush=True)),
    ("bouncing_spheres static", "bouncing_spheres", 1200, 800, 64, dict(sph_static=True)),
    ("bouncing_spheres mxu", "bouncing_spheres", 1200, 800, 64, dict(mxu_spheres=True)),
    ("final_scene static", "final_scene", 800, 800, 16, dict(sph_static=True)),
    ("final_scene split mxu tail", "final_scene", 800, 800, 16,
     dict(compact_sph=True, force_branch="dense", mxu_tail=True))]
# K13's scenes, each built in both forms at the start of phase 2h
STATIC_SCENES = ("bouncing_spheres", "final_scene", "cornell_box")
# an origin within this share of |o| + |c| + |r| of a sphere lies on it: a
# bounce's hit point rounds to a few float32 ulps of that scale (2^-16 is
# 128 ulps); the next closest sphere of a parting lane lies ~1e-3 away
SURFACE_REL = 2.0 ** -16
# lanes where an expanded form parts from the full-table K2 on phase 2h's
# pools, all explained (_parting): about twice the lanes of the card's
# reading (PERF.md section 6: 25, 152, 79; about 38; about 15)
# (ray, sphere) pairs of one K14 group: 8 spheres x 2 rays (csrc/sphere_mxu.cu)
K14_GROUP_PAIRS = 16
PARTING_BARS = {"K13 expanded, bouncing_spheres": 50, "K13 expanded, final_scene": 300,
                "K13 expanded, cornell_box": 160, "K14, bouncing_spheres": 80,
                "MXU-tail dense branch, final_scene": 32}
# The least time the card could take (NVIDIA H100
# SXM data sheet): bytes over the HBM rate, or operations over the FP32 rate
# outside the tensor cores, which counts an FMA as two operations; these
# kernels are built with -fmad=false, so their own ceiling is half of it.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per (ray, primitive) by hand count of each kernel's inner loop
OPS_SPHERE = 25  # center at time 6, oc 3, b 5, c 6, disc 3, tests and roots 2
# a static sphere, no centre at time: the direct quadratic 19; the expanded
# one with its baked K (K13) 18: b 6, c 7, disc 3, tests and roots 2
OPS_STATIC = {False: 19, True: 18}
OPS_QUAD = 44  # n.d 5, n.o 5, t 2, alpha 13, beta 13, tests 6
OPS_QUAD_WINNER = 43  # p 6, p - q 3, two cross products 18, two dots 10, the flip 6
OPS_BOX = {True: 54, False: 39}  # frame 15 (rotated), 3 guarded inverses 12,
#                                   slabs 12, min/max 10, tests 5
OPS_BOX_WINNER = 80  # the winner's face, normal and (u, v), once per hit
OPS_PHILOX = 80  # one Philox4x32-10 call: 10 rounds of 2 mul, 2 mulhi, 4 xor/add
OPS_CAMERA = 45  # one camera ray
OPS_SHADE = 60  # the dielectric scatter, the longest material path
# one noise octave, split by what each part depends on (csrc/perlin.cuh):
# a lane's blend (floor, fractions and smoothstep ~30; 8 corners' weight and
# dot, 18 each) and a lattice point's gradient (mix3 5, 3 Wang hashes 28,
# 3 u2m11 15, normalisation 11), counted once per distinct lattice point an
# octave of the input (perlin.noise_census); integer operations at the FP32
# rate
OPS_NOISE_BLEND = 174
OPS_GRADIENT = 59
OPS_SP_BOUNCE = 100  # the short path's background, material row and scatter
OPS_FLUSH = 8  # K4 a lane: load, test, shift, window, index; an add a channel
OPS_GATHER = 4  # K8 a lane: two range tests, a select
OPS_COMPACT = 6  # K4's compaction form a lane: the flag, ballot, popc, rank, slot, select
# a grid cell with the x and z slabs hoisted per column and row, as the TPU
# kernels and K9 compute them: the top plane 2, y slab 2, t0 and t1 4, the
# entry / exit choice 4, the merge 6, the amortized x and z slabs 2 (K10
# recomputes the slabs per cell: ~28)
OPS_GRID_CELL = 20


def log(*args):
    print(*args, flush=True)


class Checks:
    """Collects failed checks; every phase runs and reports."""

    def __init__(self):
        self.failed: list[str] = []

    def expect(self, ok: bool, what: str):
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
            # also on stderr, whose end is what a caller that keeps only
            # the tail of a long run sees
            print(f"[FAIL] {what}", file=sys.stderr, flush=True)

    def phase(self, name, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:  # noqa: BLE001 — record, keep running the other phases
            traceback.print_exc()
            self.failed.append(f"{name}: exception")
            log(f"  [FAIL] {name} raised (traceback on stderr)")
        finally:
            log(f"  ({time.perf_counter() - t0:.1f} s)")


def _timed_ms(fn, reps: int, reset=None) -> float:
    """Mean device time of ``fn`` over ``reps`` calls.

    Each call sits between two CUDA events behind a spin kernel
    (``torch.cuda._sleep``) that keeps the device busy while the host
    enqueues the call, so the wrapper's host work is not counted; ``reset``
    restores the inputs outside the timed region."""
    import torch

    total = 0.0
    for rep in range(reps + 1):  # rep 0 warms up
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if rep:
            total += start.elapsed_time(end)
    return total / reps


def _sphere_row_ops(rows) -> int:
    """K2's least operations a ray over the (S, 10) sphere rows: OPS_SPHERE
    for a moving row, OPS_STATIC[False] for a static one (v = 0)."""
    moving = int((rows[:, 3:6] != 0).any(dim=1).sum())
    return moving * OPS_SPHERE + (rows.shape[0] - moving) * OPS_STATIC[False]


def _set_bound(entry: dict, nbytes: float, nops: float):
    """bound_ms: the larger of bytes / HBM rate and operations / FP32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / FP32_OPS_PER_S * 1e3
    entry.update(bound_ms=max(by_bytes, by_ops),
                 bound_by="bytes" if by_bytes >= by_ops else "operations",
                 bound_bytes=float(nbytes), bound_ops=float(nops))


def _refill_work(R: int, ncols: int, taken: int) -> tuple:
    """(bytes, operations) the refill must move and do (K1; K12 adds its
    flush): act of every slot in; the uniform rows every slot writes out
    (ball, choice and the media: ncols - 5 floats) and the Philox calls that
    draw them (every call of the block but the camera's, call 1); a taken
    slot's 13 f32 planes, bounce, pix and act out (61 B), the camera's call
    and a camera ray."""
    calls = -(-ncols // 4) - 1
    return (R * (1 + 4 * (ncols - 5)) + taken * 61,
            R * calls * OPS_PHILOX + taken * (OPS_PHILOX + OPS_CAMERA))


def _shade_bytes(state, after, n_rec_bytes: int) -> float:
    """Bytes K3 must move: act of every slot; a live slot's state (12 f32,
    bounce, pix, hit: 57 B) and hit-record planes in, its radiance and
    bounce out (16 B); a survivor's o, d, throughput out (36 B); a death's
    act and framebuffer add (13 B)."""
    live = int(state["act"].sum())
    died = int((state["act"] & ~after["act"]).sum())
    R = state["act"].shape[0]
    return R + live * (57 + n_rec_bytes + 16) + (live - died) * 36 + died * 13


def card_info(checks: Checks, dev):
    import torch

    from art_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"nvidia-smi: {smi.stdout.strip().splitlines()[0] if smi.stdout else smi.stderr}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernel build: nvcc {lib.build_seconds:.2f} s, first load "
        f"{time.perf_counter() - t0:.2f} s")
    checks.expect(lib is not None, "kernels built and loaded")
    return smi.stdout.strip()


def sass_report(checks: Checks, results: dict):
    """Registers, spills and the hot loop's instructions of K2, K9 (both
    forms), K10, K7, K11, K1, K12, K5, K6 (rotated, both forms), K3 (both
    modes), K14, K16, K17 (also K15's spheres) and K15's boxes (both forms)
    in the built library (``scripts/sass_loops.py``), and of K13 in its
    per-scene libraries (built here for phase 2h: every scene of
    STATIC_SCENES in both forms, nvcc seconds each), with K13's code size,
    the fewest instructions a row of K13's and K17's group loops and K15's
    boxes' instructions a pair (``_pair_paths``);
    K14's instructions a pair: its loop's path with no root over the
    K14_GROUP_PAIRS pairs of a group;
    K7's octave: the shared form from the any-depth kernel's loop (27
    shuffles in one cell), the per-lane form from the depth-7 kernel's."""
    import importlib.util
    from pathlib import Path

    from art_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "sass_loops", Path(__file__).resolve().parent / "scripts" / "sass_loops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep = mod.report(_build.library()._name)
    # K18 has no hot loop to count (a medium a trip, two on final_scene):
    # its registers and spills alone
    rep["media_kernel"] = next((v for k, v in mod.resource_usage(_build.library()._name).items()
                                if "media_kernel" in k), {"error": "not found"})
    for name, r in rep.items():
        loop = r.get("loop", {})
        log(f"  {name}: {r.get('REG')} registers, {r.get('LOCAL')} B local (spills), "
            f"{r.get('SHARED')} B static shared; hot loop {loop.get('instructions')} "
            f"instructions in {loop.get('blocks')} blocks, paths by {r.get('key')} count "
            f"{loop.get('paths')}")
    shared = rep.get("turb_kernelILi0E", {}).get("loop", {}).get("paths", {})
    per_lane = rep.get("turb_kernelILi7E", {}).get("loop", {}).get("paths", {}).get("0")
    if "27" in shared and per_lane:
        rep["turb_octave"] = {"shared_one_cell": shared["27"], "per_lane": per_lane}
        log(f"  K7 octave: {shared['27']['fewest']}-{shared['27']['most']} instructions in "
            f"the shared form in one cell, {per_lane['fewest']}-{per_lane['most']} per lane")
    k14 = rep.get("sphere_mxu_kernel", {}).get("loop", {}).get("paths", {})
    if k14:
        fewest = min(v["fewest"] for v in k14.values())
        rep["sphere_mxu_pair"] = {"instructions": fewest / K14_GROUP_PAIRS}
        log(f"  K14: {fewest} instructions a group of {K14_GROUP_PAIRS} (ray, sphere) pairs "
            f"with no root, {fewest / K14_GROUP_PAIRS:.2f} a pair")
    checks.expect(all("error" not in r and r.get("LOCAL", 0) == 0 for r in rep.values()),
                  "K2, K9, K10, K7, K11, K1, K12, K5, K6, K3, K14, K16, K17, K15's boxes and "
                  "K18 found in the library, no local-memory spill")
    for key, name, what in (("sphere_cellbin_row", "sphere_cellbin_kernelILb0E", "K17 (also "
                             "K15's spheres)"),
                            ("sphere_cellbin_many_row", "sphere_cellbin_kernelILb1E",
                             "K17's instance for more than 64 cells")):
        rows = _row_paths(rep.get(name, {}))
        rep[key] = rows
        log(f"  {what}: its group scans' fewest instructions a row (one ray, no root): "
            + ", ".join(f"{k} {v:.2f}" for k, v in rows.items()))
    for form, name in (("folded", "box_cluster_kernelILb0E"),
                       ("rotated", "box_cluster_kernelILb1E")):
        pairs = _pair_paths(rep.get(name, {}), K15B_LDS_A_ROW[form])
        rep[f"box_cluster_pair_{form}"] = pairs
        log(f"  K15 boxes, {form}: its row scans' instructions a (ray, box) pair (no take): "
            + ", ".join(f"{k} {v:.2f}" for k, v in pairs.items()))
    k11 = rep.get("sp_step_kernel", {}).get("REG", 99)
    checks.expect(k11 <= 64, f"K11 in {k11} registers (<= 64: four blocks an SM)")
    # K13, per scene: built here (every scene and form at once), its code
    # size, registers and instructions a row in the scene's form (sph_expand)
    libs, nvcc, wall = _static_builds()
    statics = _STATIC_BUILDS["tables"]
    log(f"  K13 builds (3 scenes x 2 forms in parallel, {wall:.1f} s wall): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in nvcc.items()))
    checks.expect(all(libs.values()), "K13 built for every scene and form")
    for name in ("bouncing_spheres", "final_scene"):
        form = "expanded" if statics[name].sph_expand else "direct"
        r = mod.report(libs[f"{name} {form}"]._name, mod.STATIC)["sphere_static_kernel"]
        rows = _row_paths(r)
        rep[f"sphere_static {name} {form}"] = dict(
            {k: r.get(k) for k in ("REG", "LOCAL", "SHARED", "code_bytes")}, rows=rows)
        log(f"  K13 {name} {form}: {r.get('REG')} registers, {r.get('LOCAL')} B local "
            f"(spills), {r.get('code_bytes')} B of SASS for {statics[name].n_spheres} spheres; "
            f"its group loops' fewest instructions a row (two rays, no root): "
            + ", ".join(f"{k} {v:.2f}" for k, v in rows.items()))
        checks.expect("error" not in r and r.get("LOCAL", 0) == 0,
                      f"K13 {name} {form} found in its library, no local-memory spill")
    results["_sass"] = rep


# K13's builds (phase 1b, used by 2h): {"tables": {scene: tables}, "libs":
# {"scene form": library}, "nvcc": {"scene form": seconds}, "wall": s}
_STATIC_BUILDS: dict = {}


def _static_builds():
    """K13 built for every scene of STATIC_SCENES in both forms, one nvcc
    each, all started together (once a run): (libraries, nvcc seconds
    each, wall seconds), keyed "scene form"."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build

    if not _STATIC_BUILDS:
        statics = {n: build_scene(n, 16, 16).tables for n in STATIC_SCENES}
        jobs = [(n, ex) for n in statics for ex in (False, True)]
        t0 = time.perf_counter()
        built = _build.static_libraries([(statics[n].sph_static_cells, statics[n].sph_tail_r,
                                          statics[n].sph_tail_mat, ex) for n, ex in jobs])
        keys = [f"{n} {'expanded' if ex else 'direct'}" for n, ex in jobs]
        _STATIC_BUILDS.update(tables=statics, libs=dict(zip(keys, built)),
                              nvcc={k: lib.build_seconds for k, lib in zip(keys, built)},
                              wall=time.perf_counter() - t0)
    return _STATIC_BUILDS["libs"], _STATIC_BUILDS["nvcc"], _STATIC_BUILDS["wall"]


def _row_paths(r: dict) -> dict:
    """{"LDS n at head": the fewest instructions a row} of a sass_loops
    report's group scans: each innermost loop with eight LDS or more (a
    group of eight staged rows, a moving one with their velocities too),
    its path with the fewest LDS and no root, over the group's eight rows."""
    out = {}
    for lp in r.get("loop", {}).get("inner", []):
        key = min(lp["paths"], key=int)
        if int(key) >= 8:
            out[f"LDS {key} at {lp['head']}"] = lp["paths"][key]["fewest"] / 8
    return out


# cells whose boxes K17's kernel stages (csrc/sphere_cellbin.cu kMaxCells);
# a table of more runs its kMany instance
K17_STAGED_CELLS = 64
# rows a group of K15's folded box scan, taken where a lane of the warp
# passes the group box's bounded test (csrc/box_cluster.cu kGroup)
K15B_GROUP = 8
# LDS a staged row in K15's box scan (csrc/box_cluster.cu): two float4s in
# the folded form, three in the rotated one; a trip of its row loops takes
# four rows (the rotated form's unroll 4; nvcc unrolls the folded form's
# loop over a partial group by 4; the loop that builds the groups' boxes
# reads more LDS a trip)
K15B_LDS_A_ROW = {"folded": 2, "rotated": 3}
K15B_ROWS_A_TRIP = 4


def _pair_paths(r: dict, lds_a_row: int) -> dict:
    """{"LDS n at head": instructions a (ray, row) pair} of a sass_loops
    report's row scans: each innermost loop whose path with the fewest LDS
    reads K15B_ROWS_A_TRIP staged rows, its instructions over those rows
    (one ray a thread, no row taken)."""
    out = {}
    for lp in r.get("loop", {}).get("inner", []):
        key = min(lp["paths"], key=int)
        if int(key) == lds_a_row * K15B_ROWS_A_TRIP:
            out[f"LDS {key} at {lp['head']}"] = lp["paths"][key]["fewest"] / K15B_ROWS_A_TRIP
    return out


def _random_pool(rng, R, dev):
    import torch

    from art_tpu_torch.ops import refill_kernel as rk

    pool = {n: torch.from_numpy(
        (rng.random(R, dtype=np.float32) * 7 - 3).astype(np.float32)).to(dev)
        for n in rk.POOL_F}
    for n in ("t0", "t1", "t2"):
        pool[n].abs_()
    pool["bounce"] = torch.from_numpy(rng.integers(0, 50, R).astype(np.int32)).to(dev)
    pool["pix"] = torch.from_numpy(rng.integers(0, 64000, R).astype(np.int32)).to(dev)
    pool["act"] = torch.from_numpy(rng.random(R) < 0.4).to(dev)
    return pool


def _clone(pool):
    return {k: v.clone() for k, v in pool.items()}


def _restore(dst, src):
    for k in dst:
        dst[k].copy_(src[k])


def _max_diff(a, b, mask=None):
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def kernel_checks(checks: Checks, dev, results: dict):
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.intersect import closest_surface_p
    from art_tpu_torch.ops.intersect_kernels import sphere_hit_attrs, sphere_hit_attrs_plain
    from art_tpu_torch.ops.shade import shade_params_p
    from art_tpu_torch.ops.shade_kernel import REC_F, shade_flush, shade_flush_plain
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    rng = np.random.default_rng(SEED)
    scene = build_scene("bouncing_spheres", 1200, 800)
    tables = scene.tables.to(dev)
    cam = scene.camera
    tile_pixels, spp, R = plan_batches(1200 * 800, 64, tables.n_spheres, RenderConfig(), dev)
    log(f"  R = {R} slots, tile {tile_pixels} px, {spp} spp per chunk, "
        f"{tables.n_spheres} spheres")
    budget = max(2, 2 * R // 8192)  # knife-edge flips allowed, as the CPU tests
    scal = rk.RefillScal(spp, tile_pixels, 3 * tile_pixels, 1200 * 800, 1200, 800)
    next_q = 1_234_567
    ncols = 10
    base = _random_pool(rng, R, dev)
    block = torch.from_numpy(rng.random((ncols, R), dtype=np.float32)).to(dev)

    # ---- K1: refill, injected uniforms and Philox ----
    def refill(fn, pool, **src):
        q = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
        hist = torch.zeros(8, dtype=torch.int64, device=dev)
        out = fn(pool, cam, q, 0, hist, 3, scal, ncols=ncols, **src)
        torch.cuda.synchronize()
        return q, hist, out

    k1_err = 0.0
    for mode, src in (("injected", dict(block=block)), ("philox", dict(key=(1984, 3, 1)))):
        kp, pp = _clone(base), _clone(base)
        kq, kh, ku = refill(rk.fused_refill, kp, **src)
        pq, ph, pu = refill(rk.fused_refill_plain, pp, **src)
        checks.expect(torch.equal(kq, pq) and torch.equal(kh, ph),
                      f"K1 {mode}: queue head {int(kq[1])} and live count "
                      f"{int(kh[3])} equal the plain twin's")
        bad = sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
        checks.expect(bad == 0, f"K1 {mode}: integer planes exact ({bad} mismatches)")
        err = max(_max_diff(kp[n], pp[n]) for n in rk.POOL_F)
        rel = max(float(((kp[n] - pp[n]).abs() / (pp[n].abs() + 1.0)).max())
                  for n in rk.POOL_F)
        checks.expect(rel <= 1e-6, f"K1 {mode}: float planes max abs err {err:.3g} "
                                   f"(rel {rel:.3g} <= 1e-6)")
        u_err = max(_max_diff(a, b) for a, b in zip(ku[0] + (ku[1],) + ku[2],
                                                   pu[0] + (pu[1],) + pu[2]))
        checks.expect(u_err == 0.0, f"K1 {mode}: uniform planes bit-equal (err {u_err})")
        k1_err = max(k1_err, err)
    refilled = kp  # a pool with fresh camera rays in its taken slots

    work = _clone(base)
    q_t = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
    hist_t = torch.zeros(8, dtype=torch.int64, device=dev)
    for name, fn in (("ms", rk.fused_refill), ("plain_ms", rk.fused_refill_plain)):
        results["refill"][name] = _timed_ms(
            lambda fn=fn: fn(work, cam, q_t, 0, hist_t, 3, scal, ncols=ncols,
                             key=(1984, 3, 1)),
            20 if name == "ms" else 5, reset=lambda: _restore(work, base))
    results["refill"]["max_abs_err"] = k1_err
    # Philox mode as timed: every dead slot takes a queue element
    _set_bound(results["refill"], *_refill_work(R, ncols, int((~base["act"]).sum())))

    # ---- K2: closest sphere ----
    o = (refilled["ox"], refilled["oy"], refilled["oz"])
    d = (refilled["dx"], refilled["dy"], refilled["dz"])
    tm = refilled["tm"]
    # bit-equal to the twin: t, normal and material of every lane (the
    # kernel keeps the twin's operations and order, no FMA)
    k2 = sphere_hit_attrs(tables, o, d, tm)
    p2 = sphere_hit_attrs_plain(tables, o, d, tm)
    torch.cuda.synchronize()
    bad, hits = _equal(k2, p2), int((k2[0] < 1e30).sum())
    checks.expect(bad == 0, f"K2: {bad} values differ from the twin (t, normal, material; "
                            f"{hits} hits of {R})")
    results["sphere_hit"]["max_abs_err"] = max(
        _max_diff(x, y) for x, y in zip([k2[0], *k2[1], k2[2]], [p2[0], *p2[1], p2[2]]))
    # t_min is a run-time argument of the kernel
    kt2 = sphere_hit_attrs(tables, o, d, tm, 0.25)
    pt2 = sphere_hit_attrs_plain(tables, o, d, tm, 0.25)
    torch.cuda.synchronize()
    bad = _equal(kt2, pt2)
    beyond = bool((kt2[0][kt2[0] < 1e30] > 0.25).all())
    checks.expect(bad == 0 and beyond and bool((kt2[0] != k2[0]).any()),
                  f"K2 at t_min 0.25: {bad} values differ from the twin, every hit beyond "
                  f"0.25: {beyond}, {int((kt2[0] != k2[0]).sum())} rays changed")
    results["sphere_hit"]["ms"] = _timed_ms(lambda: sphere_hit_attrs(tables, o, d, tm), 20)
    results["sphere_hit"]["plain_ms"] = _timed_ms(
        lambda: sphere_hit_attrs_plain(tables, o, d, tm), 3)
    # 7 planes in, 5 out per ray; the sphere table once; the function's
    # least work: OPS_SPHERE a moving row, OPS_STATIC[False] a static one
    _set_bound(results["sphere_hit"], R * 48 + tables.n_spheres * 40,
               R * _sphere_row_ops(tables.sph_rows))

    # ---- K3: shade + integrate + flush, plane-fed: held to its twin on the
    # refilled pool (N_OUT deaths outside the tile), on it with its samples
    # side by side (also at R - 13 slots) and on a bouncing_spheres render's
    # pool 20 staged iterations in; timed on each ----
    rec = closest_surface_p(tables, o, d, tm, T_MIN, plain=True)
    params = shade_params_p(tables, rec)
    u = torch.from_numpy(rng.random((4, R), dtype=np.float32)).to(dev)
    planes = dict(zip(REC_F, (*rec.p, *rec.normal, *params[:3], *params[3], *params[4],
                              u[0], u[1], u[2], u[3])))
    state = _clone(refilled)
    _out_of_tile(state, tile_pixels)
    side = _side_by_side(state, tile_pixels, rng)
    cut = R - 13
    s_scene, s_state, s_hit, s_planes, s_tile = _plane_fed_staged(dev)
    k3_err, k3_census = 0.0, {}
    for label, sc, st, hit, pl, tile, n_out in (
            ("refilled", scene, state, rec.hit, planes, tile_pixels, N_OUT),
            ("side by side", scene, side, rec.hit, planes, tile_pixels, N_OUT),
            ("side by side, R - 13", scene, _cut(side, cut), rec.hit[:cut], _cut(planes, cut),
             tile_pixels, N_OUT),
            ("bouncing_spheres staged", s_scene, s_state, s_hit, s_planes, s_tile, 0)):
        runs = _k3_runs(st, hit, pl, sc, None, tile)
        got = _k3_expect(checks, label, st, runs, n_out, tile)
        k3_err = max(k3_err, got["fb_err"])
        k3_census[label] = got["census"]
        if label == "refilled":
            pp = runs[1][0]
    results["shade_flush"]["max_abs_err"] = k3_err
    results["shade_flush"]["census"] = k3_census
    work = _clone(state)
    fb_t = torch.zeros((tile_pixels, 3), device=dev)
    lost_t = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, fn in (("ms", shade_flush), ("plain_ms", shade_flush_plain)):
        results["shade_flush"][name] = _timed_ms(
            lambda fn=fn: fn(work, rec.hit, planes, scene.background, fb_t, lost_t,
                             max_depth=50, gradient=False),
            20 if name == "ms" else 5, reset=lambda: _restore(work, state))
    results["shade_flush"]["ms_side_by_side"] = _timed_ms(
        lambda: shade_flush(work, rec.hit, planes, scene.background, fb_t, lost_t,
                            max_depth=50, gradient=False), 20,
        reset=lambda: _restore(work, side))
    s_work = _clone(s_state)
    s_fb = torch.zeros((s_tile, 3), device=dev)
    results["shade_flush"]["ms_staged"] = _timed_ms(
        lambda: shade_flush(s_work, s_hit, s_planes, s_scene.background, s_fb, lost_t,
                            max_depth=50, gradient=s_scene.gradient_bg), 20,
        reset=lambda: _restore(s_work, s_state))
    _set_bound(results["shade_flush"], _shade_bytes(state, pp, 19 * 4),
               int(state["act"].sum()) * OPS_SHADE)
    _log_kernels(results, ("refill", "sphere_hit", "shade_flush"))
    r3 = results["shade_flush"]
    log(f"  plane-fed K3: side by side {r3['ms_side_by_side']:.4f} ms, bouncing_spheres staged "
        f"pool {r3['ms_staged']:.4f} ms; flush census (deaths, pixels a warp, sharing "
        f"share): " + "; ".join(f"{lab} {c['deaths']}, {c['pixels']}, {c['shared_share']:.3f}"
                                for lab, c in k3_census.items()))


def _log_kernels(results, names):
    for name in names:
        r = results[name]
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g}")


def _box_scene(checker: bool, floor: bool = True):
    """Translated, unrotated boxes (offsets folded into the kernel rows), a
    floor quad (with ``floor``) and a glass sphere; with ``checker`` the
    floor is a checker of solids, so baked K3 takes its parity path.
    Without the floor no quad comes first, so K6 runs in its plain form."""
    from art_tpu_torch.scene import materials as M
    from art_tpu_torch.scene import objects as O
    from art_tpu_torch.scene import textures as X
    from art_tpu_torch.scene.builder import SceneBuilder

    tex = (X.Checker(0.5, X.SolidColor((0.2, 0.3, 0.1)), X.SolidColor((0.9, 0.9, 0.9)))
           if checker else X.SolidColor((0.5, 0.5, 0.5)))
    objects = [O.Quad((-4, 0, -4), (8, 0, 0), (0, 0, 8), M.Lambertian(tex), inward=True)]
    b = SceneBuilder().add(
        *(objects if floor else []),
        O.Translate(O.Box((0, 0, 0), (1.25, 0.75, 1.5), M.Lambertian((0.7, 0.7, 0.7))),
                    (-2.3, 0.0, -0.7)),
        O.Translate(O.Box((0, 0, 0), (0.8, 1.9, 0.6), M.Metal((0.8, 0.7, 0.6), 0.2)),
                    (0.4, 0.1, 0.35)),
        O.Box((1.5, 0, -2.5), (2.5, 1.0, -1.5), M.DiffuseLight((4.0, 4.0, 4.0))),
        O.Sphere((0.0, 2.5, 0.0), 0.6, M.Dielectric(1.5)),
    )
    b.set_camera(lookfrom=(0, 3, 8), lookat=(0, 0.5, 0), vup=(0, 1, 0),
                 vfov_degrees=45.0, aspect=1.0, time0=0.0, time1=1.0)
    return b.compile()


def _scene_rays(rng, R, lo, hi, dev):
    import torch

    o = tuple(torch.from_numpy(rng.uniform(lo, hi, R).astype(np.float32)).to(dev)
              for _ in range(3))
    d = tuple(torch.from_numpy(rng.uniform(-1.0, 1.0, R).astype(np.float32)).to(dev)
              for _ in range(3))
    return o, d


def _box_cases(dev):
    """Phase 2b's scenes and pools at cornell_box 600x600's R: cornell_box
    and the translated-box scene (``_box_scene`` with its checker floor),
    each with random rays over its extent; cornell_box's staged pool 20
    iterations in (``_staged_pool``); and the tile's pixel count."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    rng = np.random.default_rng(SEED + 1)
    name, nx, ny, spp = CORNELL
    cornell = build_scene(name, nx, ny).to(dev)
    tile_pixels, _, R = plan_batches(nx * ny, spp, cornell.tables.n_quads, RenderConfig(), dev)
    boxes = _box_scene(checker=True).to(dev)
    cases = {"cornell_box": (cornell, _scene_rays(rng, R, 0.0, 555.0, dev)),
             "translated boxes": (boxes, _scene_rays(rng, R, -4.0, 4.0, dev))}
    return dict(cases=cases, rng=rng, R=R, tile_pixels=tile_pixels,
                staged=_staged_pool(cornell, nx, ny, spp, dev, 20))


def _out_of_tile(state, tile_pixels):
    """The first N_OUT slots: live, at their last bounce, each dying on a
    pixel outside the tile."""
    import torch

    dev = state["pix"].device
    state["pix"][:N_OUT] = torch.tensor([-1, tile_pixels, tile_pixels + 1, -7, 1 << 30,
                                         tile_pixels * 2, -(1 << 30), tile_pixels + 99],
                                        dtype=torch.int32, device=dev)
    state["act"][:N_OUT] = True
    state["bounce"][:N_OUT] = 49


def _side_by_side(state, tile_pixels, rng):
    """``state`` with the samples of a pixel side by side, as a render lays
    them out when it starts: slot i on pixel (i // 64) mod P; half the
    slots at their last bounce, so up to 32 slots of a warp die into one
    pixel; the first N_OUT dying outside the tile (``_out_of_tile``); the
    radiance made >= 0, as a render's, so a pixel's sums do not cancel."""
    import torch

    s = _clone(state)
    for n in ("r0", "r1", "r2"):
        s[n].abs_()
    dev, R = s["pix"].device, s["pix"].shape[0]
    slot = torch.arange(R, dtype=torch.int32, device=dev)
    s["pix"].copy_(torch.div(slot, 64, rounding_mode="floor") % tile_pixels)
    last = torch.from_numpy(rng.random(R) < 0.5).to(dev)
    s["bounce"].copy_(torch.where(last, torch.full_like(s["bounce"], 49), s["bounce"]))
    _out_of_tile(s, tile_pixels)
    return s


def _cut(x, n: int):
    """The first ``n`` slots of a pool, hit record or plane (views)."""
    if isinstance(x, dict):
        return {k: v[:n] for k, v in x.items()}
    return x[:n]


def _k3_runs(state, hit, planes, scene, consts, tile_pixels):
    """K3 and its plain twin, each on a copy of ``state``: ((pool, fb,
    lost) of the kernel, (pool, fb, lost) of the twin)."""
    import torch

    from art_tpu_torch.ops.shade_kernel import shade_flush, shade_flush_plain

    dev = hit.device
    runs = []
    for fn in (shade_flush, shade_flush_plain):
        pool = _clone(state)
        fb = torch.zeros((tile_pixels, 3), device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(pool, hit, planes, scene.background, fb, lost, max_depth=50,
           gradient=scene.gradient_bg, consts=consts)
        runs.append((pool, fb, lost))
    torch.cuda.synchronize()
    return runs


def _k3_expect(checks, label, state, runs, n_out: int, tile_pixels: int) -> dict:
    """K3 held to its twin: lost as the twin's and ``n_out``; every state
    plane, bounce and act bit-equal; the framebuffer within 1e-5 relative of
    the twin's index_add_ and 1e-6 of flush_warp_p's order over the
    kernel's own deaths.  Returns the largest errors and the flush census."""
    import torch

    from art_tpu_torch.ops.shade_kernel import STATE_F
    from art_tpu_torch.ops.sp_kernel import flush_census, flush_warp_p

    (kp, kfb, kl), (pp, pfb, pl) = runs
    bits = (sum(_bits_equal(kp[n], pp[n]) for n in STATE_F)
            + int((kp["bounce"] != pp["bounce"]).sum()) + int((kp["act"] != pp["act"]).sum()))
    died = state["act"] & ~kp["act"]
    wfb, wl = torch.zeros_like(kfb), torch.zeros_like(kl)
    flush_warp_p(state["pix"], died, (kp["r0"], kp["r1"], kp["r2"]), wfb, wl)
    fb_rel = float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max())
    warp_rel = float(((kfb - wfb).abs() / (wfb.abs() + 1e-6)).max())
    deaths, pixels, shared = flush_census(state["pix"], died, tile_pixels)
    checks.expect(int(kl) == int(pl) == int(wl) == n_out and bits == 0 and fb_rel <= 1e-5
                  and warp_rel <= 1e-6,
                  f"K3 {label}: lost {int(kl)} (plain {int(pl)}, want {n_out}), {bits} state, "
                  f"bounce and act values differ in bits from the twin; {deaths} deaths in the "
                  f"tile on {pixels} pixels a warp ({shared / max(deaths, 1):.3f} share a "
                  f"pixel in their warp); flush vs index_add max rel err {fb_rel:.3g} "
                  f"(<= 1e-5), vs flush_warp_p's order {warp_rel:.3g} (<= 1e-6)")
    return dict(fb_err=float((kfb - pfb).abs().max()), fb_rel=fb_rel, warp_rel=warp_rel,
                census=dict(deaths=deaths, pixels=pixels, shared=shared,
                            shared_share=shared / max(deaths, 1),
                            adds_ratio=pixels / max(deaths, 1)))


def _baked_k3_inputs(dev, box=None):
    """Baked K3's inputs on phase 2b's pools: {label: (scene, state, hit,
    planes, n_out)} — cornell_box's staged pool 20 iterations in (its
    closest_surface_p hit record, its real pixels and the refill's
    uniforms), random pools on cornell_box's and the translated-box scene's
    rays (pixels a random remainder, N_OUT outside the tile), and the
    cornell_box random pool with its samples side by side
    (``_side_by_side``)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops.intersect import closest_surface_p
    from art_tpu_torch.ops.shade_kernel import REC_BAKED

    box = box or _box_cases(dev)
    rng, R, tile_pixels, staged = box["rng"], box["R"], box["tile_pixels"], box["staged"]
    cornell = box["cases"]["cornell_box"][0]
    out = {}
    for label, (scene, (o, d)) in box["cases"].items():
        st = _random_pool(rng, R, dev)
        for n, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"), (*o, *d)):
            st[n].copy_(c)
        for n in ("r0", "r1", "r2"):  # radiance is >= 0, so sums do not cancel
            st[n].abs_()
        st["pix"].remainder_(tile_pixels)
        _out_of_tile(st, tile_pixels)
        rec = closest_surface_p(scene.tables, o, d, st["tm"], T_MIN, plain=True)
        u = torch.from_numpy(rng.random((4, R), dtype=np.float32)).to(dev)
        planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u)))
        out[f"{label} random"] = (scene, st, rec.hit, planes, N_OUT)
    scene, st, hit, planes, _ = out["cornell_box random"]
    out["cornell_box side by side"] = (scene, _side_by_side(st, tile_pixels, rng), hit, planes,
                                       N_OUT)
    cut = R - 13  # R not a multiple of 32: the last warp part-filled
    out["cornell_box side by side, R - 13"] = (
        scene, _cut(out["cornell_box side by side"][1], cut), hit[:cut], _cut(planes, cut),
        N_OUT)
    pool = _clone(staged["pool"])
    o, d = (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(cornell.tables, o, d, pool["tm"], T_MIN)
    planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *staged["u_ball"],
                                  staged["u_choice"])))
    out["cornell_box staged"] = (cornell, pool, rec.hit, planes, 0)
    return out


def _plane_fed_staged(dev):
    """Plane-fed K3's inputs on the pool of a bouncing_spheres 1200x800 @ 64
    render 20 staged iterations in (``_staged_pool``: its real pixels, the
    refill's uniforms), with its closest_surface_p hit record and
    shade_params_p's planes: (scene, state, hit, planes, tile pixels)."""
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops.intersect import closest_surface_p
    from art_tpu_torch.ops.shade import shade_params_p
    from art_tpu_torch.ops.shade_kernel import REC_F

    name, nx, ny, spp = BOUNCING
    scene = build_scene(name, nx, ny).to(dev)
    staged = _staged_pool(scene, nx, ny, spp, dev, 20)
    pool = staged["pool"]
    o, d = (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])
    rec = closest_surface_p(scene.tables, o, d, pool["tm"], T_MIN)
    params = shade_params_p(scene.tables, rec)
    planes = dict(zip(REC_F, (*rec.p, *rec.normal, *params[:3], *params[3], *params[4],
                              *staged["u_ball"], staged["u_choice"])))
    return scene, pool, rec.hit, planes, staged["fb"].shape[0]


def _clone_hit(h):
    """A copy of a (t, normal, u, v, mat) hit."""
    return (h[0].clone(), tuple(c.clone() for c in h[1]), *(x.clone() for x in h[2:]))


def _restore_hit(dst, src):
    for a, b in zip((dst[0], *dst[1], *dst[2:]), (src[0], *src[1], *src[2:])):
        a.copy_(b)


def quad_box_checks(checks: Checks, dev, results: dict):
    """K5, K6 (both forms) and baked K3 against their twins at cornell_box
    600x600's R; K6 and baked K3 timed on the render's pool (cornell_box's
    staged pool 20 iterations in) and on random ones."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN, p_where
    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops.intersect import (
        _closer,
        closest_surface_p,
        quad_attributes_p,
        quad_candidates_p,
    )
    from art_tpu_torch.ops.intersect_kernels import (
        box_hit_attrs,
        box_hit_attrs_merge,
        box_hit_attrs_merge_plain,
        box_hit_attrs_plain,
        quad_hit_attrs,
        quad_hit_attrs_plain,
    )
    from art_tpu_torch.ops.shade_kernel import shade_flush, shade_flush_plain
    from art_tpu_torch.render.integrator import staged_step

    box = _box_cases(dev)
    cases, R, tile_pixels, staged = box["cases"], box["R"], box["tile_pixels"], box["staged"]
    cornell, boxes = cases["cornell_box"][0], cases["translated boxes"][0]
    tables = cornell.tables
    log(f"  R = {R} slots, tile {tile_pixels} px; cornell_box: {tables.n_quads} quads, "
        f"{tables.n_boxes} boxes (rotated {tables.has_rotated_boxes}), "
        f"{tables.n_spheres} spheres, {tables.shade_rows.shape[0]} baked materials")
    budget = max(2, 2 * R // 8192)

    # ---- K5: closest quad and its winner's attributes, bit-equal to its
    # twin in all seven outputs: random rays, and the pools of a cornell_box
    # render 20 staged iterations in and of final_scene (2f's) ----
    cp = staged["pool"]
    c_o, c_d = (cp["ox"], cp["oy"], cp["oz"]), (cp["dx"], cp["dy"], cp["dz"])
    f_tables, f_o, f_d, _ = _route_pools(dev)["final_scene"]
    k5_cases = [(label, scene.tables, o, d) for label, (scene, (o, d)) in cases.items()]
    k5_cases += [("cornell_box pool", tables, c_o, c_d), ("final_scene pool", f_tables, f_o, f_d)]
    k5_err = 0.0
    for label, k5_tables, o, d in k5_cases:
        for t_min in (T_MIN, 50.0 if label.startswith("cornell_box") else 0.5):
            k = quad_hit_attrs(k5_tables, o, d, t_min)
            p = quad_hit_attrs_plain(k5_tables, o, d, t_min)
            torch.cuda.synchronize()
            hit = p[0] < BIG
            bad = _attrs_differ(k, p)
            checks.expect(bad == 0, f"K5 {label} t_min {t_min:g}: {bad} of the 7 x {R} "
                                    f"outputs differ in bits from the twin; {int(hit.sum())} "
                                    f"hits, {int((p[1][1][hit] < 0).sum())} normals with y < 0")
            k5_err = max(k5_err, *(_max_diff(x, y, hit) for x, y in zip(
                [k[0], *k[1], *k[2:]], [p[0], *p[1], *p[2:]])))
    results["quad_hit"]["max_abs_err"] = k5_err

    # ---- K6: closest oriented box, rotated (cornell_box) and unrotated, in
    # its plain form, against its twin; and its merge form (closest_surface_p's
    # box block after the quads) bit-equal to K6 plus _closer in all seven
    # outputs and held to its twin as K6 is, on the same rays and on
    # cornell_box's staged pool ----
    def k6_expect(what, k, p):
        khit, phit = k[0] < BIG, p[0] < BIG
        same = (khit == phit) & (~khit | (k[4] == p[4]))
        flips = int((~same).sum())
        both = same & khit
        errs = [_max_diff(k[0], p[0], both)] + [_max_diff(k[1][c], p[1][c], both)
                                               for c in range(3)] + [
            _max_diff(k[2], p[2], both), _max_diff(k[3], p[3], both)]
        t_rel = float(((k[0] - p[0]).abs() / p[0].abs().clamp_min(1e-30))[both].max())
        checks.expect(flips <= budget and t_rel <= 1e-6 and max(errs[1:]) <= 1e-5,
                      f"{what}: {flips} hit/material flips (<= {budget}), {int(khit.sum())} "
                      f"hits, t max rel err {t_rel:.3g} (<= 1e-6), normal/u/v max err "
                      f"{max(errs[1:]):.3g} (<= 1e-5), {_attrs_differ(k, p)} values differ "
                      f"in bits")
        return max(errs)

    k6_err, merge_err = 0.0, 0.0
    merge_cases = [(label, scene, o, d) for label, (scene, (o, d)) in cases.items()]
    merge_cases.append(("cornell_box pool", cornell, c_o, c_d))
    for label, scene, o, d in merge_cases:
        rot = scene.tables.has_rotated_boxes
        for t_min in (T_MIN, 50.0 if label.startswith("cornell_box") else 0.5):
            k = box_hit_attrs(scene.tables, o, d, t_min)
            p = box_hit_attrs_plain(scene.tables, o, d, t_min)
            torch.cuda.synchronize()
            k6_err = max(k6_err, k6_expect(
                f"K6 {label} (rotated {rot}) t_min {t_min:g}", k, p))
            quad = quad_hit_attrs(scene.tables, o, d, t_min)
            want = _closer(quad, k)
            got = box_hit_attrs_merge(scene.tables, o, d, _clone_hit(quad), t_min)
            twin = box_hit_attrs_merge_plain(scene.tables, o, d,
                                             quad_hit_attrs_plain(scene.tables, o, d, t_min),
                                             t_min)
            torch.cuda.synchronize()
            bad = _attrs_differ(got, want)
            ties = int(((k[0] == quad[0]) & (quad[0] < BIG)).sum())
            checks.expect(bad == 0, f"K6 merge {label} t_min {t_min:g}: {bad} of the 7 x {R} "
                                    f"outputs differ in bits from K6 + _closer; "
                                    f"{int((k[0] < quad[0]).sum())} lanes a box wins, {ties} "
                                    f"exact quad/box ties kept by the quad")
            merge_err = max(merge_err, k6_expect(f"K6 merge {label} t_min {t_min:g} against "
                                                 f"its twin", got, twin))
    results["box_hit"]["max_abs_err"] = k6_err
    results["box_hit_merge"]["max_abs_err"] = merge_err
    # closest_surface_p takes the merge form on cornell_box: one launch for
    # the boxes, none of the plain form
    _build.launches.clear()
    closest_surface_p(tables, c_o, c_d, cp["tm"], T_MIN)
    counts = dict(_build.launches)
    checks.expect(counts.get("box_hit_merge") == 1 and not counts.get("box_hit"),
                  f"closest_surface_p on cornell_box: the box block is K6's merge form "
                  f"({counts})")

    # K5 timed on the cornell_box pool, beside the glue it replaced (the
    # winner's attributes and the miss masking of closest_surface_p, in
    # PyTorch, on the candidates' (t, idx)); the launches of a staged
    # cornell_box iteration now, and with that glue
    r5 = results["quad_hit"]
    r5["ms"] = _timed_ms(lambda: quad_hit_attrs(tables, c_o, c_d), 20)
    r5["plain_ms"] = _timed_ms(lambda: quad_hit_attrs_plain(tables, c_o, c_d), 5)
    r5["ms_final_scene"] = _timed_ms(lambda: quad_hit_attrs(f_tables, f_o, f_d), 20)
    c_t, c_idx = quad_candidates_p(tables, c_o, c_d, T_MIN)

    def glue():
        normal, alpha, beta, mat = quad_attributes_p(tables, c_o, c_d, c_t, c_idx.clamp_min(0))
        hit = c_t < BIG
        zero = torch.zeros_like(c_t)
        return (p_where(hit, normal, (torch.ones_like(c_t), zero, zero)),
                torch.where(hit, alpha, zero), torch.where(hit, beta, zero),
                torch.where(hit, mat, torch.zeros_like(mat)))

    r5["glue_ms"] = _timed_ms(glue, 20)
    r5["glue_launches"] = _captured_launches(glue)
    s_args = (_clone(cp), cornell.camera, staged["q"].clone(), 0, staged["hist"].clone(), 20,
              staged["scal"], tables, cornell.background, staged["fb"].clone(),
              staged["lost"].clone())
    r5["staged_cornell_launches"] = _captured_launches(lambda: staged_step(
        *s_args, key=(7, 0, 0), ncols=staged["ncols"], max_depth=50,
        gradient=cornell.gradient_bg))
    c_hits = int((c_t < BIG).sum())
    # 6 planes in and 7 out a ray (52 B), both tables once
    _set_bound(r5, R * 52 + tables.n_quads * (48 + 64),
               R * tables.n_quads * OPS_QUAD + c_hits * OPS_QUAD_WINNER)

    # K6 timed on the staged pool (the render's rays) and on random rays:
    # its plain form; its merge form against the parent's block, K6 and
    # _closer as one function; the merge's bound on this pool: 6 ray planes
    # and the incoming t in (28 B a ray), 28 B out a lane a box wins, the
    # table once
    r6, rm = results["box_hit"], results["box_hit_merge"]
    co_r, cd_r = cases["cornell_box"][1]
    r6["ms"] = _timed_ms(lambda: box_hit_attrs(tables, c_o, c_d), 20)
    r6["plain_ms"] = _timed_ms(lambda: box_hit_attrs_plain(tables, c_o, c_d), 5)
    r6["ms_random"] = _timed_ms(lambda: box_hit_attrs(tables, co_r, cd_r), 20)
    hits = int((box_hit_attrs_plain(tables, c_o, c_d)[0] < BIG).sum())
    _set_bound(r6, R * 52 + tables.n_boxes * 48,
               R * tables.n_boxes * OPS_BOX[True] + hits * OPS_BOX_WINNER)
    bo, bd = cases["translated boxes"][1]
    r6["ms_unrotated"] = _timed_ms(lambda: box_hit_attrs(boxes.tables, bo, bd), 20)
    for key, scene, o, d in (("", cornell, c_o, c_d), ("_random", cornell, co_r, cd_r),
                             ("_translated", boxes, bo, bd)):
        quad = quad_hit_attrs(scene.tables, o, d)
        work = _clone_hit(quad)
        rm[f"ms{key}"] = _timed_ms(lambda: box_hit_attrs_merge(scene.tables, o, d, work), 20,
                                   reset=lambda: _restore_hit(work, quad))
        rm[f"k6_closer_ms{key}"] = _timed_ms(
            lambda: _closer(quad, box_hit_attrs(scene.tables, o, d)), 20)
        if not key:
            wins = int((box_hit_attrs_merge_plain(tables, o, d, quad)[0] < quad[0]).sum())
            rm["plain_ms"] = _timed_ms(lambda: box_hit_attrs_merge_plain(tables, o, d, quad), 5)
            rm["launches_block"] = _captured_launches(
                lambda: box_hit_attrs_merge(tables, o, d, work))
            rm["k6_closer_launches"] = _captured_launches(
                lambda: _closer(quad, box_hit_attrs(tables, o, d)))
            rm["wins"] = wins
            _set_bound(rm, R * 28 + wins * 28 + tables.n_boxes * 48,
                       R * tables.n_boxes * OPS_BOX[True] + wins * OPS_BOX_WINNER)

    # ---- baked K3: held to its twin on the random pools of cornell_box and
    # the checker scene, on the cornell_box one with its samples side by
    # side (also at R - 13 slots) and on cornell_box's staged pool; timed on
    # the staged pool (the render's) and the random one ----
    k3 = _baked_k3_inputs(dev, box)
    k3_err, k3_census = 0.0, {}
    for label, (scene, state, hit, planes, n_out) in k3.items():
        runs = _k3_runs(state, hit, planes, scene, scene.tables.shade_rows, tile_pixels)
        got = _k3_expect(checks, f"baked {label}", state, runs, n_out, tile_pixels)
        k3_err = max(k3_err, got["fb_err"])
        k3_census[label] = got["census"]
        if label == "cornell_box staged":
            staged_after = runs[1][0]
    r3 = results["shade_flush_baked"]
    r3["max_abs_err"] = k3_err
    r3["census"] = k3_census
    fb_t = torch.zeros((tile_pixels, 3), device=dev)
    lost_t = torch.zeros(1, dtype=torch.int32, device=dev)
    for key, label in (("", "cornell_box staged"), ("_random", "cornell_box random"),
                       ("_side_by_side", "cornell_box side by side")):
        scene, state, hit, planes, _ = k3[label]
        work = _clone(state)
        for name, fn in ((f"ms{key}", shade_flush), (f"plain_ms{key}", shade_flush_plain)):
            if name == "plain_ms_side_by_side":
                continue
            r3[name] = _timed_ms(
                lambda fn=fn: fn(work, hit, planes, scene.background, fb_t, lost_t,
                                 max_depth=50, gradient=False, consts=tables.shade_rows),
                20 if name.startswith("ms") else 5, reset=lambda: _restore(work, state))
    state = k3["cornell_box staged"][1]
    _set_bound(r3, _shade_bytes(state, staged_after, 11 * 4), int(state["act"].sum()) * OPS_SHADE)
    _log_kernels(results, ("quad_hit", "box_hit", "box_hit_merge", "shade_flush_baked"))
    log(f"  box_hit: random rays {r6['ms_random']:.4f} ms, unrotated {r6['ms_unrotated']:.4f} "
        f"ms; box_hit_merge: {rm['wins']} lanes a box wins, {rm['launches_block']} launch "
        f"against K6 + _closer's {rm['k6_closer_launches']}: staged pool {rm['ms']:.4f} ms "
        f"(K6 + _closer {rm['k6_closer_ms']:.4f}), random rays {rm['ms_random']:.4f} "
        f"({rm['k6_closer_ms_random']:.4f}), translated boxes {rm['ms_translated']:.4f} "
        f"({rm['k6_closer_ms_translated']:.4f})")
    log(f"  baked K3: staged pool {r3['ms']:.4f} ms, random pool {r3['ms_random']:.4f} ms, "
        f"side by side {r3['ms_side_by_side']:.4f} ms; flush census (deaths, pixels a warp, "
        f"sharing share): " + "; ".join(
            f"{lab} {c['deaths']}, {c['pixels']}, {c['shared_share']:.3f}"
            for lab, c in k3_census.items()))
    log(f"  quad_hit on final_scene's pool {r5['ms_final_scene']:.4f} ms; the glue it "
        f"replaced {r5['glue_ms']:.4f} ms in {r5['glue_launches']} launches; a staged "
        f"cornell_box iteration: {r5['staged_cornell_launches']} launches")


def _attrs_differ(k, p) -> int:
    """Values whose bits differ between two (t, normal, ...) results: each
    float output by its bits (so -0 against +0 counts), the last (the
    material) as integers."""
    fk, fp = [k[0], *k[1], *k[2:]], [p[0], *p[1], *p[2:]]
    return (sum(_bits_equal(x, y) for x, y in zip(fk[:-1], fp[:-1]))
            + int((fk[-1] != fp[-1]).sum()))


def _bits_equal(a, b) -> int:
    """Lanes whose float32 bits differ (two NaNs count as equal)."""
    import torch

    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def _sp_pool(rng, R, tile_pixels, dev):
    """A random pool with radiance >= 0 (so a pixel's sum cannot cancel),
    pixels inside the tile but for ``N_OUT`` live slots at their last
    bounce whose deaths must count into ``lost``."""
    import torch

    pool = _random_pool(rng, R, dev)
    for n in ("r0", "r1", "r2"):
        pool[n].abs_()
    pool["pix"].remainder_(tile_pixels)
    pool["pix"][:N_OUT] = torch.tensor([-1, tile_pixels, tile_pixels + 1, -7, 1 << 30,
                                        tile_pixels * 2, -(1 << 30), tile_pixels + 99],
                                       dtype=torch.int32, device=dev)
    pool["act"][:N_OUT] = True
    pool["bounce"][:N_OUT] = 49
    return pool


_SHORT: dict = {}


def _short_setup(dev):
    """quads and perlin 1200x600 @ 64 on the card (R = 2^17, as
    ``plan_batches`` gives): the scenes, the queue geometry, a queue head
    inside the tile, and the pools of a short-path render (Philox key
    (7, 0, 0)) 20 iterations in, and perlin's 21 in; built once for phase 2c
    and ``scripts/kernel_pair.py``."""
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.sp_kernel import sp_step
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    if _SHORT:
        return _SHORT
    _, _, nx, ny, spp, _ = SHORT[0]
    scenes = {name: build_scene(name, nx, ny).to(dev) for name in ("quads", "perlin")}
    tile_pixels, spp_chunk, R = plan_batches(nx * ny, spp, 2, RenderConfig(), dev)
    scal = rk.RefillScal(spp_chunk, tile_pixels, 0, nx * ny, nx, ny)
    rendered = {}
    for name, scene in scenes.items():
        pool = rk.new_pool(R, dev)
        q = torch.zeros(2, dtype=torch.int64, device=dev)
        hist = torch.zeros(21, dtype=torch.int64, device=dev)
        fb = torch.zeros((tile_pixels, 3), device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        for it in range(21 if name == "perlin" else 20):
            sp_step(pool, scene.camera, q, it % 2, hist, it, scal, scene.tables,
                    scene.background, fb, lost, key=(7, 0, 0), ncols=10, max_depth=50,
                    gradient=scene.gradient_bg)
            if it + 1 >= 20:
                rendered[(name, it + 1)] = _clone(pool)
    _SHORT.update(scenes=scenes, tile_pixels=tile_pixels, spp_chunk=spp_chunk, R=R,
                  scal=scal, q0=spp_chunk * 1000 + 3, rendered=rendered)
    return _SHORT


def _sp_refilled(s, scene, base, **src):
    """``base`` after the plain refill of iteration 5 from queue head q0
    (the state the bounce of a K11 step sees)."""
    import torch

    from art_tpu_torch.ops import refill_kernel as rk

    pool = _clone(base)
    dev = pool["act"].device
    rk.fused_refill_plain(pool, scene.camera,
                          torch.tensor([s["q0"], 0], dtype=torch.int64, device=dev), 0,
                          torch.zeros(6, dtype=torch.int64, device=dev), 5, s["scal"],
                          ncols=10, **src)
    return pool


def _sp_hits(scene, pool):
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops.intersect import closest_surface_p

    return closest_surface_p(scene.tables, (pool["ox"], pool["oy"], pool["oz"]),
                             (pool["dx"], pool["dy"], pool["dz"]), pool["tm"], T_MIN,
                             plain=True)


def _sp_run(s, fn, scene, base, src):
    """One K11 step (or its twin ``fn``) of iteration 5 from ``base``:
    (pool, q, hist, fb, lost, died)."""
    import torch

    dev = base["act"].device
    pool = _clone(base)
    q = torch.tensor([s["q0"], 0], dtype=torch.int64, device=dev)
    hist = torch.zeros(6, dtype=torch.int64, device=dev)
    fb = torch.zeros((s["tile_pixels"], 3), device=dev)
    lost = torch.zeros(1, dtype=torch.int32, device=dev)
    died = fn(pool, scene.camera, q, 0, hist, 5, s["scal"], scene.tables, scene.background,
              fb, lost, ncols=10, max_depth=50, gradient=scene.gradient_bg, **src)
    torch.cuda.synchronize()
    return pool, q, hist, fb, lost, died


def _sp_step_ms(s, fn, name, iters, reps):
    """Device ms of ``fn`` (K11 or its twin) on the step timed in phase 2c:
    iteration 5's Philox uniforms (key (1984, 2, 1)) from the pool of
    ``name`` ``iters`` iterations in, queue head q0."""
    import torch

    scene, base = s["scenes"][name], s["rendered"][(name, iters)]
    dev = base["act"].device
    work = _clone(base)
    q = torch.zeros(2, dtype=torch.int64, device=dev)
    hist = torch.zeros(6, dtype=torch.int64, device=dev)
    fb = torch.zeros((s["tile_pixels"], 3), device=dev)
    lost = torch.zeros(1, dtype=torch.int32, device=dev)

    def reset():
        _restore(work, base)
        q.fill_(s["q0"])

    def step():
        fn(work, scene.camera, q, 0, hist, 5, s["scal"], scene.tables, scene.background, fb,
           lost, key=(1984, 2, 1), ncols=10, max_depth=50, gradient=scene.gradient_bg)

    return _timed_ms(step, reps, reset=reset)


# the short-path steps K11 is timed on: (results key suffix, scene,
# iterations into the render); perlin 20 is this slice's main path (camera
# rays on marble), perlin 21 their bounces (most die: the flush), quads 20
SP_TIMED = (("", "perlin", 20), ("_bounces", "perlin", 21), ("_quads", "quads", 20))


def _turb_pools(dev):
    """K7's inputs at R = 2^17 (name -> (px, py, pz)): the hit points, misses
    at o + 1e30 d as the staged path feeds them, of the K11 steps timed in
    phase 2c (perlin 20 and 21 iterations in, each refilled as ``_sp_refilled``
    does) and of the final_scene staged pool of phase 2f (20 iterations in);
    and random points in [-1e4, 1e4), each lane its own cell (the per-lane
    form)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops.intersect import closest_surface_p

    s = _short_setup(dev)
    perl = s["scenes"]["perlin"]
    pools = {}
    for label, it in (("perlin", 20), ("bounces", 21)):
        rec = _sp_hits(perl, _sp_refilled(s, perl, s["rendered"][("perlin", it)],
                                          key=(1984, 2, 1)))
        pools[label] = tuple(c.contiguous() for c in rec.p)
    tables, o, d, tm = _route_pools(dev)["final_scene"]
    pools["final_scene"] = tuple(c.contiguous() for c in closest_surface_p(
        tables, o, d, tm, T_MIN, plain=True).p)
    rng = np.random.default_rng(SEED + 10)
    pools["random"] = tuple(torch.from_numpy(c).to(dev) for c in rng.uniform(
        -1e4, 1e4, (3, s["R"])).astype(np.float32))
    return pools


def _noise_work(p, depth, need=None):
    """(operations, forms, lattice points) of a depth-octave turbulence over
    the lanes with ``need`` (default all): OPS_NOISE_BLEND a lane and octave,
    OPS_GRADIENT a distinct lattice point an octave (``perlin.noise_census``:
    forms (depth, 3) counts warps in 1, <= 4 and > 4 cells)."""
    from art_tpu_torch.ops import perlin

    forms, points = perlin.noise_census(*p, depth, need)
    n = p[0].shape[0] if need is None else int(need.sum())
    return n * depth * OPS_NOISE_BLEND + int(points.sum()) * OPS_GRADIENT, forms, points


def _forms_text(forms, points) -> str:
    """The share of warp-octaves in each form of perlin.cuh's noise."""
    tot = max(int(forms[:, 1].sum() + forms[:, 2].sum()), 1)
    return (f"warp-octaves in 1 cell {100 * int(forms[:, 0].sum()) / tot:.1f}%, in <= 4 "
            f"cells (shared) {100 * int(forms[:, 1].sum()) / tot:.1f}%, per-lane "
            f"{100 * int(forms[:, 2].sum()) / tot:.1f}% (of {tot}); distinct lattice points "
            f"an octave {points.tolist()}")


def turb_sp_checks(checks: Checks, dev, results: dict):
    """K7 and K11 against their twins at quads and perlin 1200x600's R
    (2^17), then timed."""
    import torch

    from art_tpu_torch.ops import perlin, perlin_kernel
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.shade_kernel import (
        REC_BAKED,
        REC_SP,
        STATE_F,
        shade_flush,
        shade_flush_plain,
    )
    from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain
    from art_tpu_torch.ops.texture_eval import eval_special_p

    rng = np.random.default_rng(SEED + 2)
    s = _short_setup(dev)
    scenes, R, tile_pixels, rendered = s["scenes"], s["R"], s["tile_pixels"], s["rendered"]
    log(f"  R = {R} slots, tile {tile_pixels} px, {s['spp_chunk']} spp per chunk")

    # ---- K7 bit-equal to its twin on every pool, at depth 7, 2 and masked;
    # timed at depth 7 (perlin: phase 2c's pool, this slice's main input) ----
    k7_err = 0.0
    for label, p in _turb_pools(dev).items():
        n = p[0].shape[0]
        mask = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).to(dev)
        for case, depth, m in (("depth 7", 7, None), ("depth 2", 2, None),
                               ("depth 7 masked", 7, mask)):
            k = perlin_kernel.turb(*p, depth, m)
            q = perlin.turb_p(*p, depth, m)
            torch.cuda.synchronize()
            bad = _bits_equal(k, q)
            checks.expect(bad == 0, f"K7 {label} {case}: {bad} of {n} lanes differ in bits")
            k7_err = max(k7_err, _max_diff(k, q, torch.isfinite(q)))
        key = "" if label == "perlin" else f"_{label}"
        entry = results["turb"] if label == "perlin" else {}
        entry["ms"] = _timed_ms(lambda: perlin_kernel.turb(*p, 7), 20)
        ops, forms, points = _noise_work(p, 7)
        # 3 planes in, 1 out
        _set_bound(entry, n * 16, ops)
        if label == "perlin":
            results["turb"]["plain_ms"] = _timed_ms(lambda: perlin.turb_p(*p, 7), 3)
        else:
            for k in ("ms", "bound_ms", "bound_by"):
                results["turb"][f"{k}{key}"] = entry[k]
        log(f"  K7 {label}: {entry['ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}); {_forms_text(forms, points)}")
    results["turb"]["max_abs_err"] = k7_err

    # ---- baked K3 with the noise planes, on phase 2c's perlin rays ----
    perl = scenes["perlin"]
    after = _sp_refilled(s, perl, rendered[("perlin", 20)], key=(1984, 2, 1))
    rec = _sp_hits(perl, after)
    state = _sp_pool(rng, R, tile_pixels, dev)
    for n in ("ox", "oy", "oz", "dx", "dy", "dz"):
        state[n].copy_(after[n])
    u = torch.from_numpy(rng.random((4, R), dtype=np.float32)).to(dev)
    planes = dict(zip(REC_BAKED, (*rec.p, *rec.normal, rec.mat, *u)))
    planes.update(zip(REC_SP, eval_special_p(perl.tables, perl.tables.shade_consts[1],
                                             rec.mat, rec.u, rec.v, rec.p, plain=True)))
    out = []
    for fn in (shade_flush, shade_flush_plain):
        pool, fb = _clone(state), torch.zeros((tile_pixels, 3), device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(pool, rec.hit, planes, perl.background, fb, lost, max_depth=50,
           gradient=perl.gradient_bg, consts=perl.tables.shade_rows)
        torch.cuda.synchronize()
        out.append((pool, fb, lost))
    (kp, kfb, kl), (pp, pfb, pl) = out
    bad = sum(_bits_equal(kp[n], pp[n]) for n in STATE_F)
    bad += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "act"))
    fb_rel = float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max())
    checks.expect(bad == 0 and int(kl) == int(pl) == N_OUT and fb_rel <= 1e-6,
                  f"K3 baked with noise planes (perlin): {bad} plane mismatches, "
                  f"{int((state['act'] & ~pp['act']).sum())} died, out-of-tile deaths "
                  f"{int(kl)} (plain {int(pl)}, want {N_OUT}), flush max rel err "
                  f"{fb_rel:.3g} (<= 1e-6)")

    # ---- K11: both uniform modes, from a random pool and rendered ones ----
    k11_err = 0.0
    block = torch.from_numpy(rng.random((10, R), dtype=np.float32)).to(dev)
    for sname, pool_label, base, n_out in (
            ("quads", "random pool", _sp_pool(rng, R, tile_pixels, dev), N_OUT),
            ("quads", "pool after 20 iterations", rendered[("quads", 20)], 0),
            ("perlin", "random pool", _sp_pool(rng, R, tile_pixels, dev), N_OUT),
            ("perlin", "pool after 20 iterations", rendered[("perlin", 20)], 0),
            ("perlin", "pool after 21 iterations", rendered[("perlin", 21)], 0)):
        scene = scenes[sname]
        for mode, src in (("injected", dict(block=block)), ("philox", dict(key=(1984, 2, 1)))):
            kp, kq, kh, kfb, kl, kd = _sp_run(s, sp_step, scene, base, src)
            pp, pq, ph, pfb, pl, pd = _sp_run(s, sp_step_plain, scene, base, src)
            bad = sum(_bits_equal(kp[n], pp[n]) for n in rk.POOL_F)
            bad += sum(int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
            fb_rel = float(((kfb - pfb).abs() / (pfb.abs() + 1e-6)).max())
            ok = (bad == 0 and torch.equal(kq, pq) and torch.equal(kh, ph)
                  and torch.equal(kd, pd) and int(kl) == int(pl) == n_out
                  and fb_rel <= 1e-6)
            checks.expect(ok, f"K11 {sname} {pool_label} {mode}: take "
                              f"{int(kq[1] - kq[0])} (plain {int(pq[1] - pq[0])}), live "
                              f"{int(kh[5])} ({int(ph[5])}), died {int(kd.sum())} "
                              f"({int((kd != pd).sum())} differ), {bad} plane "
                              f"mismatches, out-of-tile deaths {int(kl)} (plain "
                              f"{int(pl)}, want {n_out}), flush max rel err "
                              f"{fb_rel:.3g} (<= 1e-6)")
            k11_err = max(k11_err, float((kfb - pfb).abs().max()),
                          *(_max_diff(kp[n], pp[n]) for n in rk.POOL_F))
    results["sp_step"]["max_abs_err"] = k11_err

    # ---- K11 timed from the rendered pools, Philox uniforms ----
    for key, sname, iters in SP_TIMED:
        scene = scenes[sname]
        ms = _sp_step_ms(s, sp_step, sname, iters, 20)
        plain_ms = _sp_step_ms(s, sp_step_plain, sname, iters, 3)
        # what this step's data needs: the slots live after the refill, the
        # taken ones, the hits and the turbulence of the marble hits
        base = s["rendered"][(sname, iters)]
        after = _sp_refilled(s, scene, base, key=(1984, 2, 1))
        rec = _sp_hits(scene, after)
        live = after["act"]
        n_live, was = int(live.sum()), int(base["act"].sum())
        taken = n_live - was
        hit = rec.hit & live
        mats = scene.tables.sp_mat_rows
        scatter = hit & (mats[rec.mat.long().clamp(0, mats.shape[0] - 1), 0] != 3.0)
        kind = scene.tables.sp_mat_rows[rec.mat.long().clamp(
            0, scene.tables.sp_mat_rows.shape[0] - 1), 6]
        marble = hit & (kind == 2.0)
        died = _sp_run(s, sp_step_plain, scene, base, dict(key=(1984, 2, 1)))[5]
        noise_ops, forms, points = _noise_work(rec.p, 7, marble)
        prims = scene.tables.n_spheres * OPS_SPHERE + scene.tables.n_quads * OPS_QUAD
        # act of every slot in and died out; a slot live before the refill
        # reads its state (60 B); a live slot writes radiance, bounce and act
        # (17 B) and o, d, throughput (36 B; counted for every live slot);
        # a taken slot tm and pix (8 B); the framebuffer adds are not
        # counted.  Philox: the ball's call for a slot that scatters (a live
        # hit on no light), the camera's two for a taken slot
        entry = results["sp_step"] if key == "" else {}
        _set_bound(entry, R * 2 + was * 60 + n_live * (17 + 36) + taken * 8,
                   n_live * (prims + OPS_SP_BOUNCE) + int(scatter.sum()) * OPS_PHILOX
                   + taken * (2 * OPS_PHILOX + OPS_CAMERA) + noise_ops)
        results["sp_step"].update({f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                                   f"bound_ms{key}": entry["bound_ms"],
                                   f"bound_by{key}": entry["bound_by"]})
        log(f"  K11 {sname} {iters} iterations in: {ms:.4f} ms (plain {plain_ms:.4f}, bound "
            f"{entry['bound_ms']:.4f} {entry['bound_by']}); {n_live} live ({taken} taken), "
            f"{int(hit.sum())} hits, {int(marble.sum())} on marble, {int(died.sum())} died"
            + (f"; {_forms_text(forms, points)}" if int(marble.sum()) else ""))
    _log_kernels(results, ("turb", "sp_step"))


# the image fetch's pools (phase 2d, scripts/kernel_pair.py --set fetch):
# (scene, nx, ny, spp) 20 staged iterations into a render
FETCH_SCENES = (("earth", 1200, 600, 64), ("final_scene", 800, 800, 16))
OPS_FETCH = 26  # K8's fetch form a needy lane: 2 clamps and NaN tests 6, index 9,
#                 the flip 1, 3 channels of shift, mask, convert and scale 12
_FETCH_POOLS: dict = {}


def _fetch_pools(dev):
    """FETCH_SCENES' pools (``_staged_pool``, refilled) with the hit record
    a staged iteration shades there (the plain ``closest_surface_p`` and
    ``apply_media_p``) and its image fetch's inputs (``image_lanes``):
    name -> dict(scene, s, rec, valid, specials, img, u, v, needy); built
    once."""
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops.intersect import apply_media_p, closest_surface_p
    from art_tpu_torch.ops.texture_eval import image_lanes

    for name, nx, ny, spp in FETCH_SCENES:
        if name in _FETCH_POOLS:
            continue
        scene = build_scene(name, nx, ny).to(dev)
        s = _staged_pool(scene, nx, ny, spp, dev, 20)
        pool, tables = s["pool"], scene.tables
        o, d = (pool["ox"], pool["oy"], pool["oz"]), (pool["dx"], pool["dy"], pool["dz"])
        surf = closest_surface_p(tables, o, d, pool["tm"], T_MIN, plain=True)
        rec = apply_media_p(tables, o, d, T_MIN, surf, s["u_media"], time=pool["tm"])
        valid = rec.hit & pool["act"]
        specials = tables.shade_consts[1]
        img, u, v, needy = image_lanes(specials, rec.mat, rec.u, rec.v, valid)
        _FETCH_POOLS[name] = dict(scene=scene, s=s, rec=rec, valid=valid, specials=specials,
                                  img=img, u=u, v=v, needy=needy)
    return _FETCH_POOLS


# CUgraphNodeType: the nodes that are device work, as a launch each
GRAPH_WORK_NODES = {0: None, 1: "memcpy", 2: "memset"}


def _captured_names(fn) -> dict:
    """{device kernel name: launches} of one call of ``fn`` (after a
    warm-up call), read from a CUDA graph capture of the call: its kernel,
    memcpy and memset nodes, a kernel named by the driver (``cuFuncGetName``,
    the mangled name).  The capture records every launch on the current
    stream, the port's kernels' included, and runs none of them.  (A
    profiler window is no count: late in a long process it lost launches,
    ``sample`` reading 0 device launches in up to 19 of 20 windows.)"""
    import collections
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value not in GRAPH_WORK_NODES:
            continue  # empty, host, event and wait nodes: no device work
        label = GRAPH_WORK_NODES[kind.value]
        if label is None:
            params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2: func first
            name = ctypes.c_char_p()
            if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) != 0
                    or cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p.from_buffer(
                        params).value) != 0):
                raise RuntimeError("a kernel node's function name was not readable")
            label = name.value.decode()[:80]
        names[label] += 1
    graph.reset()
    return dict(names)


def _staged_names(f) -> dict:
    """{device kernel name: launches} of one staged iteration on a
    ``_fetch_pools`` pool (a copy of it)."""
    from art_tpu_torch.render.integrator import staged_step

    s, scene = f["s"], f["scene"]
    args = (_clone(s["pool"]), scene.camera, s["q"].clone(), 0, s["hist"].clone(), 20,
            s["scal"], scene.tables, scene.background, s["fb"].clone(), s["lost"].clone())
    return _captured_names(lambda: staged_step(*args, key=(7, 0, 0), ncols=s["ncols"],
                                               max_depth=50, gradient=scene.gradient_bg))


def _atlas_args(atlas) -> tuple:
    """K8's fetch form's atlas arguments: data, widths, heights, hmax, wmax."""
    return atlas.data, atlas.widths, atlas.heights, atlas.hmax, atlas.wmax


def _unpacked_compact(atlas, img, u, v, needy):
    """``ImageAtlas.sample(img, u, v, needy)`` as the port ran it before K8's
    fetch form: the texel index, the compacted fetch (K4, K8 and their
    glue), the unpack and a stack, (R, 3)."""
    import torch

    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops.flush_kernel import UNPACK_SCALE

    px = cf.compact_gather(atlas.data, atlas.texel_index(img, u, v), needy)
    return torch.stack([((px >> s) & 0xFF).to(torch.float32) * UNPACK_SCALE
                        for s in (0, 8, 16)], dim=-1)


def compact_checks(checks: Checks, dev, results: dict):
    """K4, K8 (both forms) and the compacted fetch against their twins at
    earth 1200x600's R (2^17), on a pool 20 staged iterations into a
    render; K8's fetch form also on a final_scene pool."""
    import torch

    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import flush_kernel as fk

    rng = np.random.default_rng(SEED + 3)
    pools = _fetch_pools(dev)
    f = pools["earth"]
    pool, rec, needy, R = f["s"]["pool"], f["rec"], f["needy"], f["s"]["R"]
    atlas = f["scene"].tables.atlas
    flat = atlas.texel_index(f["img"], f["u"], f["v"])
    n_needy = int(needy.sum())
    log(f"  R = {R}, earth pool after 20 iterations: {int(pool['act'].sum())} live, "
        f"{n_needy} needy ({n_needy / R:.3f}), atlas {atlas.data.shape[0]} texels")

    # ---- K4 in its compaction use: slot rank[r] <- ray id r over needy lanes ----
    rank = cf._rank(needy)
    ray_id = torch.arange(R, dtype=torch.float32, device=dev)
    n_hi = -(-R // fk.LANES)
    k4 = fk.flush_accumulate(rank, needy, (ray_id,), torch.zeros(n_hi, fk.LANES, device=dev))
    p4 = fk.flush_accumulate_plain(rank, needy, (ray_id,),
                                   torch.zeros(n_hi, fk.LANES, device=dev))
    torch.cuda.synchronize()
    bad = _bits_equal(k4, p4)
    slots = k4.view(-1)[:n_needy].to(torch.int64)
    ids_ok = torch.equal(slots, torch.nonzero(needy).view(-1))
    checks.expect(bad == 0 and ids_ok and not bool(k4.view(-1)[n_needy:].any()),
                  f"K4 compaction on the earth pool: {bad} of {n_hi * fk.LANES} slots "
                  f"differ from the twin in bits; slots are the needy ray ids in order: "
                  f"{ids_ok}")
    k4_err = _max_diff(k4, p4)

    # ---- K4 on a colliding 3-channel flush into a window at base row 7 ----
    win, base = 96, 7
    pix = torch.from_numpy(rng.integers(0, (win + 20) * 128, R).astype(np.int32)).to(dev)
    pix[:64] = torch.from_numpy(rng.integers(-(1 << 30), 0, 64).astype(np.int32)).to(dev)
    died = torch.from_numpy(rng.random(R) < 0.6).to(dev)
    vals = tuple(torch.from_numpy(rng.random(R, dtype=np.float32) * 4).to(dev)
                 for _ in range(3))
    fb0 = torch.from_numpy(rng.random((win, 384), dtype=np.float32)).to(dev)
    base_t = torch.tensor([base], dtype=torch.int32, device=dev)
    kf = fk.flush_accumulate(pix, died, vals, fb0.clone(), base_t)
    pf = fk.flush_accumulate_plain(pix, died, vals, fb0.clone(), base_t)
    torch.cuda.synchronize()
    rel = float(((kf - pf).abs() / pf.abs().clamp_min(1e-30)).max())
    hi = (pix.long() & 0xFFFFFFFF) >> 7
    inside = int((died & (hi >= base) & (hi < base + win)).sum())
    checks.expect(rel <= 1e-5 and bool((kf >= fb0).all()),
                  f"K4 colliding flush, window of {win} rows at base {base}: {inside} of "
                  f"{int(died.sum())} dying lanes inside, max rel err {rel:.3g} (<= 1e-5), "
                  f"radiance >= 0")
    k4_err = max(k4_err, float((kf - pf).abs().max()))
    results["flush_accumulate"]["max_abs_err"] = k4_err

    # ---- K8: the route-back on this pool's texel slots, out-of-range included ----
    table = cf.compact_gather(atlas.data, flat, needy)  # any (R,) int32 table
    idx = rank.clone()
    idx[:256] = torch.from_numpy(np.concatenate([
        rng.integers(-(1 << 30), 0, 128), rng.integers(R, 1 << 30, 128)]).astype(np.int32)
    ).to(dev)
    k8, p8 = fk.table_gather_u24(table, idx), fk.table_gather_u24_plain(table, idx)
    torch.cuda.synchronize()
    bad = int((k8 != p8).sum())
    checks.expect(bad == 0 and not bool(k8[:256].any()),
                  f"K8 on the earth pool: {bad} of {R} lanes differ, 256 out-of-range "
                  f"indices read 0")
    results["table_gather_u24"]["max_abs_err"] = float((k8 - p8).abs().max())

    # ---- the compacted fetch against the dense gather; no render runs K8,
    # so its launches are these calls' ----
    masks = {"0": torch.zeros_like(needy), "rendered": needy,
             "30%": torch.from_numpy(rng.random(R) < 0.3).to(dev),
             "100%": torch.ones_like(needy)}
    _build.launches.clear()
    for label, m in masks.items():
        got = cf.compact_gather(atlas.data, flat, m)
        want = torch.where(m, atlas.data.index_select(0, flat), 0)
        torch.cuda.synchronize()
        checks.expect(torch.equal(got, want),
                      f"compact_gather at {label} needy ({int(m.sum())} lanes) equals "
                      f"where(needy, data[flat], 0)")
    results["table_gather_u24"]["check_calls"] = _build.launches[fk.GATHER]

    # ---- times: K4 and K8 as the fetch calls them, on this pool ----
    zeros = torch.zeros(n_hi, fk.LANES, device=dev)
    work = zeros.clone()
    r4 = results["flush_accumulate"]
    for key, fn in (("ms", fk.flush_accumulate), ("plain_ms", fk.flush_accumulate_plain)):
        r4[key] = _timed_ms(lambda fn=fn: fn(rank, needy, (ray_id,), work),
                            20 if key == "ms" else 5, reset=lambda: work.copy_(zeros))
    # the library call: one index_put_ over every lane, each of the others
    # to a spare element of its own past the slots (sent to one spare
    # element, they made one index of ~10^5 duplicates, which index_put_
    # walks one by one: kept beside as library_one_spare_ms)
    n_slots = n_hi * fk.LANES
    for key, size, other in (("library_ms", n_slots + R, n_slots + torch.arange(R, device=dev)),
                             ("library_one_spare_ms", n_slots + 1, n_slots)):
        spare = torch.zeros(size, device=dev)
        lib_idx = torch.where(needy, rank.long(), other)
        r4[key] = _timed_ms(lambda: spare.index_put_((lib_idx,), ray_id, accumulate=True), 20,
                            reset=lambda: spare.zero_())
    # pix and died of every lane in; a needy lane's value in, its slot read
    # and written
    _set_bound(r4, R * 5 + n_needy * 12, R * OPS_FLUSH)
    slots_tab = torch.where(torch.arange(n_hi * fk.LANES, device=dev) < n_needy,
                            atlas.data.index_select(0, flat.index_select(
                                0, k4.view(-1).to(torch.int32))), 0)
    r8 = results["table_gather_u24"]
    r8["ms"] = _timed_ms(lambda: fk.table_gather_u24(slots_tab, rank), 20)
    r8["plain_ms"] = _timed_ms(lambda: fk.table_gather_u24_plain(slots_tab, rank), 5)
    r8["library_ms"] = _timed_ms(lambda: slots_tab.index_select(0, rank), 20)
    # idx in and out for every lane; the table entries the ranks reach once
    _set_bound(r8, R * 8 + (n_needy + 1) * 4, R * OPS_GATHER)
    fetch = {"needy": n_needy, "R": R}
    fetch["compact_ms"] = _timed_ms(lambda: cf.compact_gather(atlas.data, flat, needy), 20)
    fetch["dense_ms"] = _timed_ms(lambda: atlas.data.index_select(0, flat), 20)
    fetch["dense_where_ms"] = _timed_ms(
        lambda: torch.where(needy, atlas.data.index_select(0, flat), 0), 20)
    results["_compact_fetch"] = fetch
    atlas_fetch_checks(checks, dev, results, pools, masks)

    # felt's mottling noise stays plain PyTorch (jnp outside any Pallas
    # kernel in art_tpu): its device launches and device time on this pool's
    # hit points at simple_light's mottling scale
    from art_tpu_torch.ops.perlin import noise_p

    pts = tuple((c * 16.0).contiguous() for c in rec.p)
    launches = _captured_launches(lambda: noise_p(*pts))
    results["_noise_p"] = {"launches": launches, "ms": _timed_ms(lambda: noise_p(*pts), 5),
                           "R": R}
    compaction_checks(checks, dev, results)
    _log_kernels(results, ("flush_accumulate", "compact", "table_gather_u24", "atlas_fetch"))
    log(f"  felt's noise_p (plain PyTorch): {launches} device launches, "
        f"{results['_noise_p']['ms']:.4f} ms at R = {R}")
    log(f"  library: index_put_ {r4['library_ms']:.4f} ms (every other lane to one spare "
        f"element: {r4['library_one_spare_ms']:.4f} ms), index_select "
        f"{r8['library_ms']:.4f} ms; compact_gather {fetch['compact_ms']:.4f} ms against "
        f"the dense gather {fetch['dense_ms']:.4f} ms ({fetch['dense_where_ms']:.4f} ms "
        f"with its where)")
    for name, c in fetch["pools"].items():
        log(f"  sample(..., needy) on {name}'s pool ({c['needy']} of {c['R']} needy): K8's "
            f"fetch form {c['ms']:.4f} ms in {c['sample_launches']} launch, the compacted "
            f"pipeline it replaced "
            f"{c['compact_sample_ms']:.4f} ms in {c['compact_sample_launches']}; a staged "
            f"iteration {c['staged_launches']} launches "
            f"({sum(n for k, n in c['staged_names'].items() if 'atlas_fetch' in k)} of K8's "
            f"fetch form)")


def _parent_compaction(needy, planes):
    """The split's compaction as the port ran it before K4's compaction
    form: the cumsum rank, K4's flush form scattering the ray ids,
    ``needy.sum`` and one ``index_select`` of the stacked planes; (ids, cnt,
    planes_k, rank)."""
    import torch

    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import flush_kernel as fk

    R = needy.shape[0]
    rank = cf._rank(needy)
    slots = torch.zeros((-(-R // fk.LANES), fk.LANES), dtype=torch.float32, device=needy.device)
    ids = fk.flush_accumulate(rank, needy, (torch.arange(R, dtype=torch.float32,
                                                         device=needy.device),),
                              slots).view(-1).to(torch.int32)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    return ids, cnt, tuple(torch.stack(planes).index_select(1, ids)), rank


def _compaction_pools(dev) -> dict:
    """K4's compaction form's pools: (needy, the six ray planes) of phase
    2d's earth pool (the image fetch's needy lanes) and of its final_scene
    pool (the split's: the lanes that can reach the sphere tail's box;
    phase 2e's pool)."""
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import compact_sphere as cs

    pools = _fetch_pools(dev)
    out = {}
    for name, f in pools.items():
        p = f["s"]["pool"]
        planes = tuple(p[k] for k in ("ox", "oy", "oz", "dx", "dy", "dz"))
        if name == "final_scene":
            needy = cs.tail_box_needy(f["scene"].tables.sph_tail_box, planes[:3], planes[3:],
                                      T_MIN)
        else:
            needy = f["needy"]
        out[name] = (needy, planes)
    return out


def _compaction_differ(got, want) -> int:
    """Values of (ids, cnt, planes_k on the first cnt slots, rank) that
    differ in bits."""
    n = int(want[1])
    bad = _bits_equal(got[0], want[0]) + _bits_equal(got[1], want[1])
    bad += sum(_bits_equal(a[:n].contiguous(), b[:n].contiguous())
               for a, b in zip(got[2], want[2]))
    if want[3] is not None:
        bad += _bits_equal(got[3], want[3])
    return bad


def compaction_checks(checks: Checks, dev, results: dict):
    """K4's compaction form (``compact_fetch.compact``) bit-equal to its twin
    and to the pipeline it replaced on phase 2d's earth and final_scene split
    pools, at their own needy lanes and at 0, one lane, 30% and 100%, at R -
    100 lanes (a pad), every slot written over a sentinel; its time against
    that pipeline's (device ms and launches by kernel name), the twin's and
    ``torch.nonzero``'s, beside its bound."""
    import torch

    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import compact_fetch as cf

    rng = np.random.default_rng(SEED + 18)
    r = results["compact"]
    r["pools"], err = {}, 0.0
    for name, (needy, planes) in _compaction_pools(dev).items():
        R = needy.shape[0]
        one = torch.zeros_like(needy)
        one[int(rng.integers(R))] = True
        masks = {"rendered": needy, "0": torch.zeros_like(needy), "one lane": one,
                 "30%": torch.from_numpy(rng.random(R) < 0.3).to(dev),
                 "100%": torch.ones_like(needy)}
        cases = [(label, m, planes) for label, m in masks.items()]
        cases.append((f"rendered, R - 100 = {R - 100}", needy[:R - 100].contiguous(),
                      tuple(p[:R - 100].contiguous() for p in planes)))
        for label, m, pl in cases:
            n, S = int(m.sum()), -(-m.shape[0] // 128) * 128
            # every output over a sentinel: each slot written, each rank
            ids = torch.full((S,), -7, dtype=torch.int32, device=dev)
            cnt = torch.full((1,), -7, dtype=torch.int32, device=dev)
            out = torch.full((len(pl), S), float("nan"), device=dev)
            rank = torch.full((m.shape[0],), -7, dtype=torch.int32, device=dev)
            cf._launch(m, pl, ids, cnt, tuple(out), rank)
            got = (ids, cnt, tuple(out), rank)
            twin = cf.compact(m, pl, want_rank=True, plain=True)
            parent = _parent_compaction(m, pl)
            public = cf.compact(m, pl)
            torch.cuda.synchronize()
            bad_t, bad_p = _compaction_differ(got, twin), _compaction_differ(got, parent)
            bad_c = _compaction_differ(public, (*twin[:3], None))
            checks.expect(bad_t == 0 and bad_p == 0 and bad_c == 0 and int(cnt) == n,
                          f"K4's compaction form on {name}'s pool at {label} needy ({n} of "
                          f"{m.shape[0]}): every slot and rank written, {bad_t} values differ "
                          f"from the twin, {bad_p} from the pipeline it replaced, {bad_c} "
                          f"without the rank")
            err = max(err, float((ids - twin[0]).abs().max()), float((rank - twin[3]).abs().max()))
    r["max_abs_err"] = err

    # times on the two pools at their own needy lanes, six planes: the
    # split's call, the pipeline it replaced, the twin, torch.nonzero (which
    # reads the count on the host: no path can take it)
    for name, (needy, planes) in _compaction_pools(dev).items():
        R, n = needy.shape[0], int(needy.sum())
        S = -(-R // 128) * 128
        c = {"R": R, "needy": n}
        c["ms"] = _timed_ms(lambda: cf.compact(needy, planes), 20)
        c["ms_with_rank"] = _timed_ms(lambda: cf.compact(needy, planes, want_rank=True), 20)
        c["parent_ms"] = _timed_ms(lambda: _parent_compaction(needy, planes), 20)
        c["plain_ms"] = _timed_ms(lambda: cf.compact(needy, planes, plain=True), 5)
        c["nonzero_ms"] = _timed_ms(lambda: torch.nonzero(needy), 20)
        c["names"] = _captured_names(lambda: cf.compact(needy, planes))
        c["parent_names"] = _captured_names(lambda: _parent_compaction(needy, planes))
        c["launches"], c["parent_launches"] = sum(c["names"].values()), sum(
            c["parent_names"].values())
        # needy in, ids out, the count out, a needy lane's six planes in
        # and out; with the rank, 4 B a lane more
        _set_bound(c, R + 4 * S + 4 + 48 * n, R * OPS_COMPACT)
        c["bound_ms_with_rank"] = (R + 4 * S + 4 + 48 * n + 4 * R) / HBM_BYTES_PER_S * 1e3
        r["pools"][name] = c
        log(f"  K4's compaction form on {name}'s pool ({n} of {R} needy): {c['ms']:.4f} ms in "
            f"{c['launches']} launch ({c['ms_with_rank']:.4f} with the rank), the pipeline it "
            f"replaced {c['parent_ms']:.4f} ms in {c['parent_launches']} ({c['parent_names']}), "
            f"twin {c['plain_ms']:.4f}, torch.nonzero {c['nonzero_ms']:.4f}; bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    # the kernel table's row: the split's pool (the render's path)
    f = r["pools"]["final_scene"]
    r.update({k: f[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes",
                                 "bound_ops")}, library_ms=f["nonzero_ms"])
    checks.expect(all(c["launches"] == 1 for c in r["pools"].values()),
                  f"K4's compaction form is one device launch a call: "
                  f"{[c['names'] for c in r['pools'].values()]}")
    # K4's flush form is on no render's path: its launches are phase 2d's
    results["flush_accumulate"]["check_calls"] = _build.launches[cf.fk.FLUSH]


def atlas_fetch_checks(checks: Checks, dev, results: dict, pools: dict, masks: dict):
    """K8's fetch form against its twin on earth's pool at each of
    ``masks``' needy shares, on lanes with NaN, infinite and out-of-range
    inputs, against the compacted pipeline it replaced, and on final_scene's
    pool through ``eval_special_p``; its times on both pools, the dense
    gather's and the replaced pipeline's, and a staged iteration's launches
    by kernel name."""
    import torch

    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import flush_kernel as fk
    from art_tpu_torch.ops.texture_eval import eval_special_p

    rng = np.random.default_rng(SEED + 13)
    f = pools["earth"]
    atlas = f["scene"].tables.atlas
    fa = _atlas_args(atlas)
    img, u, v, R = f["img"], f["u"], f["v"], f["s"]["R"]
    err = 0.0
    for label, m in masks.items():
        k, p = fk.atlas_fetch(*fa, img, u, v, m), fk.atlas_fetch_plain(*fa, img, u, v, m)
        c = _unpacked_compact(atlas, img, u, v, m)
        torch.cuda.synchronize()
        bad, off = _bits_equal(k, p), bool(k[:, ~m].view(torch.int32).any())
        checks.expect(bad == 0 and not off and _bits_equal(k.T.contiguous(), c) == 0,
                      f"K8's fetch form on the earth pool at {label} needy ({int(m.sum())} "
                      f"lanes): {bad} of {3 * R} values differ from the twin in bits; +0.0 "
                      f"off the needy lanes: {not off}; equal to the compacted pipeline")
        err = max(err, float((k - p).abs().max()))
    # lanes the renders do not make: NaN, infinite and out-of-range u and v,
    # image ids out of range; every lane needy
    uo, vo, io = u.clone(), v.clone(), img.clone()
    lanes = torch.from_numpy(rng.choice(R, 7 * 64, replace=False)).to(dev).view(7, 64)
    uo[lanes[0]] = float("nan")
    vo[lanes[1]] = float("nan")
    uo[lanes[2]], vo[lanes[2]] = float("inf"), float("-inf")
    uo[lanes[3]], vo[lanes[3]] = float("-inf"), float("inf")
    uo[lanes[4]] = torch.from_numpy(rng.uniform(-3, 4, 64).astype(np.float32)).to(dev)
    vo[lanes[5]] = torch.from_numpy(rng.uniform(-3, 4, 64).astype(np.float32)).to(dev)
    io[lanes[6]] = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, 64).astype(np.int32)
                                    ).to(dev)
    every = torch.ones_like(masks["rendered"])
    k, p = fk.atlas_fetch(*fa, io, uo, vo, every), fk.atlas_fetch_plain(*fa, io, uo, vo, every)
    torch.cuda.synchronize()
    bad = _bits_equal(k, p)
    checks.expect(bad == 0, f"K8's fetch form with NaN, infinite and out-of-range u, v and "
                            f"image ids on {7 * 64} lanes, every lane needy: {bad} values "
                            f"differ from the twin on the card")
    err = max(err, float((k - p).abs().max()))

    # final_scene's pool: the fetch, and eval_special_p (image and marble)
    g = pools["final_scene"]
    ga = g["scene"].tables.atlas
    k = fk.atlas_fetch(*_atlas_args(ga), g["img"], g["u"], g["v"], g["needy"])
    p = fk.atlas_fetch_plain(*_atlas_args(ga), g["img"], g["u"], g["v"], g["needy"])
    rec, specials = g["rec"], g["specials"]
    args = (g["scene"].tables, specials, rec.mat, rec.u, rec.v, rec.p)
    ks = eval_special_p(*args, valid=g["valid"])
    ps = eval_special_p(*args, valid=g["valid"], plain=True)
    torch.cuda.synchronize()
    bad, bad_s = _bits_equal(k, p), sum(_bits_equal(a, b) for a, b in zip(ks, ps))
    checks.expect(bad == 0 and bad_s == 0 and int(g["needy"].sum()) > 0,
                  f"K8's fetch form on the final_scene pool ({int(g['needy'].sum())} needy): "
                  f"{bad} values differ from the twin; eval_special_p "
                  f"({[sp[1] for sp in specials]}) {bad_s} values differ from its plain path")
    err = max(err, float((k - p).abs().max()))

    rf = results["atlas_fetch"]
    rf["max_abs_err"] = err
    needy = f["needy"]
    n_needy = int(needy.sum())
    flat = atlas.texel_index(img, u, v)
    rf["ms"] = _timed_ms(lambda: fk.atlas_fetch(*fa, img, u, v, needy), 20)
    rf["plain_ms"] = _timed_ms(lambda: fk.atlas_fetch_plain(*fa, img, u, v, needy), 5)
    # the dense gather with its mask, on the texel index the fetch computes
    rf["library_ms"] = _timed_ms(
        lambda: torch.where(needy, atlas.data.index_select(0, flat), 0), 20)
    # needy in and three planes out every lane; img, u, v in and the texel
    # of a needy lane alone (the kernel loads them only there); widths and
    # heights
    _set_bound(rf, R * 13 + n_needy * 16 + atlas.widths.shape[0] * 8, n_needy * OPS_FETCH)
    per_pool = {}
    for name, q in pools.items():
        qa, qargs = q["scene"].tables.atlas, (q["img"], q["u"], q["v"], q["needy"])
        names = _staged_names(q)
        _build.launches.clear()
        launches = _captured_launches(lambda: qa.sample(*qargs))  # two calls
        counted = _build.launches[fk.FETCH]
        c = per_pool[name] = dict(
            needy=int(q["needy"].sum()), R=q["s"]["R"], sample_launches=launches,
            ms=_timed_ms(lambda: qa.sample(*qargs), 20),
            compact_sample_ms=_timed_ms(lambda: _unpacked_compact(qa, *qargs), 20),
            compact_sample_launches=_captured_launches(lambda: _unpacked_compact(qa, *qargs)),
            staged_launches=sum(names.values()), staged_names=names)
        fetches = sum(n for k, n in names.items() if "atlas_fetch" in k)
        checks.expect(launches == 1 and counted == 2 and fetches == 1,
                      f"sample(..., needy) on {name}'s pool: {launches} device launch "
                      f"(K8's fetch form, counted {counted} in two calls); a staged "
                      f"iteration launches it {fetches} time")
    results["_compact_fetch"]["pools"] = per_pool


def _box_field(nx: int, ny: int, kx: int = 40, kz: int = 40):
    """A kx x kz field of boxes under a gradient sky: at 40x40 (1600 > 1024)
    the builder sets no K9 cell table and the grid goes to K10, as in
    art_tpu; at 72x8 (576 boxes, kx + kz = 80) K9 takes its per-cell form."""
    from art_tpu_torch.scene import materials as M
    from art_tpu_torch.scene import objects as O
    from art_tpu_torch.scene.builder import SceneBuilder

    mats = [M.Lambertian((0.7, 0.6, 0.5)), M.Lambertian((0.3, 0.5, 0.7))]
    b = SceneBuilder().set_name("box field" if (kx, kz) == (40, 40) else f"box field {kx}x{kz}")
    for ix in range(kx):
        for iz in range(kz):
            h = 1.0 + (ix * 7 + iz * 11) % 9
            b.add(O.Box((ix * 4.0, 0.0, iz * 4.0), (ix * 4.0 + 4.0, h, iz * 4.0 + 4.0),
                        mats[(ix + iz) % 2]))
    b.set_camera(lookfrom=(2 * kx, 60, -60), lookat=(2 * kx, 0, 2 * kz), vup=(0, 1, 0),
                 vfov_degrees=50.0, aspect=nx / ny, time0=0.0, time1=1.0)
    b.set_background(gradient=True)
    return b.compile()


def _scene(name: str, nx: int, ny: int):
    """The registry scene ``name``, or the box field."""
    from art_tpu_torch.models import build_scene

    return _box_field(nx, ny) if name == "box field" else build_scene(name, nx, ny)


def _captured_launches(fn) -> int:
    """Device launches of one call of ``fn`` (after a warm-up call)."""
    return sum(_captured_names(fn).values())


def _staged_pool(scene, nx, ny, spp, dev, iters):
    """The pool of a render of ``scene`` at nx x ny @ spp (the R that
    plan_batches picks on the card) after ``iters`` staged iterations, its
    dead slots refilled by the plain K1: a dict of the pool, its queue and
    tile state, and the refill's uniforms (ball, choice and media)."""
    import torch

    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render.integrator import n_uniform_cols, staged_step
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    tables = scene.tables
    tile_pixels, spp_chunk, R = plan_batches(nx * ny, spp, tables.n_spheres, RenderConfig(),
                                             dev)
    s = dict(R=R, ncols=n_uniform_cols(tables), pool=rk.new_pool(R, dev),
             scal=rk.RefillScal(spp_chunk, tile_pixels, 0, nx * ny, nx, ny),
             q=torch.zeros(2, dtype=torch.int64, device=dev),
             hist=torch.zeros(21, dtype=torch.int64, device=dev),
             fb=torch.zeros((tile_pixels, 3), device=dev),
             lost=torch.zeros(1, dtype=torch.int32, device=dev))
    for it in range(iters):
        staged_step(s["pool"], scene.camera, s["q"], it % 2, s["hist"], it, s["scal"], tables,
                    scene.background, s["fb"], s["lost"], key=(7, 0, 0), ncols=s["ncols"],
                    max_depth=50, gradient=scene.gradient_bg)
    s["u_ball"], s["u_choice"], s["u_media"] = rk.fused_refill_plain(
        s["pool"], scene.camera, s["q"], 0, s["hist"], iters, s["scal"], key=(7, 0, 0),
        ncols=s["ncols"])
    torch.cuda.synchronize()
    return s


def _equal(a, b) -> int:
    """Values that differ between two (t, normal, u, v, mat) or (t, normal,
    mat) results."""
    fa, fb = [a[0], *a[1], *a[2:]], [b[0], *b[1], *b[2:]]
    return sum(int((x != y).sum()) for x, y in zip(fa, fb))


def _grid_conditions(tables, o, d, t_min=None):
    """Where K10's culled walk (``csrc/box_grid.cu``) tests: (cols (R, kx),
    rows (R, kx, kz)) bool.  With the y window [Ylo, Yhi] of the floor and
    the table's lowest and highest tops and the z window of the first and
    last rows, a column is walked where its x slab has xhi > max(t_min, Ylo,
    Zlo) and xlo < min(Yhi, Zhi), and in it a row where its z slab has zhi
    > max(t_min, Ylo, xlo) and zlo < min(Yhi, xhi); nothing where Yhi <=
    t_min.  The kernel settles each of these sets as an interval by exact
    steps; here every column and row is held to the conditions."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN, safe_dir

    t_min = T_MIN if t_min is None else t_min
    kx, kz, w = tables.box_grid_kx, tables.box_grid_kz, tables.box_grid_w
    heights = tables.box_grid_rows[:, 0::2]
    inv = tuple(1.0 / safe_dir(c) for c in d)
    ex0, sxv = (tables.box_grid_x0 - o[0]) * inv[0], w * inv[0]
    ez0, szv = (tables.box_grid_z0 - o[2]) * inv[2], w * inv[2]
    ty0p = (tables.box_grid_y0 - o[1]) * inv[1]
    ta, tb = (heights.min() - o[1]) * inv[1], (heights.max() - o[1]) * inv[1]
    y_lo = torch.minimum(ty0p, torch.minimum(ta, tb))
    y_hi = torch.maximum(ty0p, torch.maximum(ta, tb))
    ix = torch.arange(kx, dtype=torch.float32, device=o[0].device)
    iz = torch.arange(kz, dtype=torch.float32, device=o[0].device)
    ta = ex0[:, None] + ix[None] * sxv[:, None]
    tb = ta + sxv[:, None]
    xlo, xhi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    ta = ez0[:, None] + iz[None] * szv[:, None]
    tb = ta + szv[:, None]
    zlo, zhi = torch.minimum(ta, tb), torch.maximum(ta, tb)
    z_lo = torch.minimum(zlo[:, 0], zlo[:, -1])
    z_hi = torch.maximum(zhi[:, 0], zhi[:, -1])
    low = y_lo.clamp_min(t_min)
    cols = ((xhi > torch.maximum(low, z_lo)[:, None])
            & (xlo < torch.minimum(y_hi, z_hi)[:, None]) & (y_hi > t_min)[:, None])
    b = torch.maximum(low[:, None], xlo)
    top = torch.minimum(y_hi[:, None], xhi)
    rows = (zhi[:, None, :] > b[:, :, None]) & (zlo[:, None, :] < top[:, :, None])
    return cols, rows


def _grid_tests(tables, o, d, t_min=None, chunk: int = 4096, columns: bool = False):
    """(R,) int64: the (ray, cell) tests K10's culled walk makes on these
    rays (``_grid_conditions``); with ``columns``, the columns it walks."""
    import torch

    out = []
    for a in range(0, o[0].shape[0], chunk):
        cols, rows = _grid_conditions(tables, tuple(c[a:a + chunk] for c in o),
                                      tuple(c[a:a + chunk] for c in d), t_min)
        out.append(cols.sum(dim=1) if columns else (rows & cols[:, :, None]).sum(dim=(1, 2)))
    return torch.cat(out)


def _grid_test_stats(tests) -> dict:
    """K10's tests a ray: the total, the mean, the mean over warps (32
    consecutive rays) of the warp's most and the most."""
    n = tests.shape[0] // 32 * 32
    warp_max = tests[:n].reshape(-1, 32).max(dim=1).values
    return dict(tests=int(tests.sum()), mean=float(tests.double().mean()),
                warp_max_mean=float(warp_max.double().mean()), most=int(tests.max()))


def box_field_checks(checks: Checks, dev, results: dict):
    """K10 on its own path: the 40x40 box field's pool (1600 cells, more
    than K9's gate takes), bit-equal to its twin, with winners in cells past
    the 1024th; the (ray, cell) tests its culled walk makes
    (``_grid_tests``) against the table's cells a ray; K10's time and bound
    at that path's shapes (the bound of the tests these rays need, and of
    every cell a ray beside it)."""
    import torch

    from art_tpu_torch.core.vecmath import BIG
    from art_tpu_torch.ops import intersect_kernels as K

    _, name, nx, ny, spp, _ = BIG_SCENES[-1]
    scene = _box_field(nx, ny).to(dev)
    tables = scene.tables
    s = _staged_pool(scene, nx, ny, spp, dev, 1)
    R, pool = s["R"], s["pool"]
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    k, p = K.box_grid_hit_attrs(tables, o, d), K.box_grid_hit_attrs_plain(tables, o, d)
    torch.cuda.synchronize()
    hit = k[0] < BIG
    # the winner's cell, from a point just inside the box behind the hit
    eps = 1e-3 * tables.box_grid_w
    ix = torch.floor((o[0] + k[0] * d[0] - eps * k[1][0] - tables.box_grid_x0)
                     / tables.box_grid_w)
    iz = torch.floor((o[2] + k[0] * d[2] - eps * k[1][2] - tables.box_grid_z0)
                     / tables.box_grid_w)
    cells = tables.box_grid_kx * tables.box_grid_kz
    second = int((hit & (ix * tables.box_grid_kz + iz >= 1024)).sum())
    bad = _equal(k, p)
    checks.expect(cells > 1024 and tables.box_grid_cell_rows is None and bad == 0
                  and second > 0,
                  f"K10 on the {name} pool ({cells} cells, no K9 cell list, R = {R}, "
                  f"{int(pool['act'].sum())} live after 1 iteration): {bad} values differ "
                  f"from the twin; {int(hit.sum())} hits, {second} in cells past the "
                  f"1024th")
    r = results["box_grid"]
    r["max_abs_err"] = max(r["max_abs_err"] or 0.0, *(
        _max_diff(x, y) for x, y in zip([k[0], *k[1], k[2], k[3]], [p[0], *p[1], p[2], p[3]])))
    r["ms"] = _timed_ms(lambda: K.box_grid_hit_attrs(tables, o, d), 20)
    r["plain_ms"] = _timed_ms(lambda: K.box_grid_hit_attrs_plain(tables, o, d), 3)
    # the (ray, cell) tests these rays need: the cells of each ray's column
    # and row intervals (_grid_tests), as the kernel walks them
    tests = _grid_test_stats(_grid_tests(tables, o, d))
    checks.expect(tests["mean"] < cells,
                  f"K10 on the {name} pool tests {tests['mean']:.3f} cells a ray (the "
                  f"warps' most {tests['warp_max_mean']:.3f} a ray on average, "
                  f"{tests['most']} at most) of the table's {cells}")
    # 6 planes in and 7 out a ray, the (kx, 2 kz) table once; the tests
    # these rays need, and beside them every cell of the table a ray
    nbytes, hits = R * 52 + cells * 8, int(hit.sum())
    _set_bound(r, nbytes, tests["tests"] * OPS_GRID_CELL + hits * OPS_BOX_WINNER)
    r["bound_ms_all_cells"] = max(nbytes / HBM_BYTES_PER_S, (R * cells * OPS_GRID_CELL + hits
                                                            * OPS_BOX_WINNER)
                                  / FP32_OPS_PER_S) * 1e3
    r.update(cells=cells, R=R, shapes=f"{name} {nx}x{ny} @ {spp}", grid_tests=tests)


def long_field_checks(checks: Checks, dev, results: dict):
    """K9's second form: a 72x8 box field (576 cells, kx + kz = 80 slab
    columns, more than the hoisted form holds) on its pool one staged
    iteration in, bit-equal to its twin; its time."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.ops import intersect_kernels as K

    nx, ny = 160, 90
    scene = _box_field(nx, ny, 72, 8).to(dev)
    tables = scene.tables
    s = _staged_pool(scene, nx, ny, 4, dev, 1)
    R, pool = s["R"], s["pool"]
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    k, p = K.box_grid_cells_hit_attrs(tables, o, d), K.box_grid_cells_hit_attrs_plain(
        tables, o, d)
    torch.cuda.synchronize()
    form, bad = K.box_grid_cells_form(tables), _equal(k, p)
    skip = K.box_grid_skip_p(tables, o, d, T_MIN)
    warps = float(skip[: R // 32 * 32].reshape(-1, 32).all(dim=1).float().mean())
    checks.expect(form == "per-cell" and bad == 0 and tables.box_grid_cell_rows is not None,
                  f"K9 on the 72x8 field's pool ({tables.box_grid_cell_rows.shape[0]} cells, "
                  f"R = {R}): {form} form, {bad} values differ from the twin; "
                  f"{int((k[0] < BIG).sum())} hits, {warps:.4f} of the warps test no cell")
    r = results["box_grid_cells"]
    r["ms_72x8_field"] = _timed_ms(lambda: K.box_grid_cells_hit_attrs(tables, o, d), 20)
    r["form_72x8_field"] = form


def grid_split_checks(checks: Checks, dev, results: dict):
    """K9, K10, the split sphere pass (K2 with n_live, K4) and the media
    against their twins and each other at final_scene 800x800's R (2^17),
    on a pool 20 staged iterations into a render; then K10 on the box
    field's pool (box_field_checks)."""
    import dataclasses

    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as cs
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.render.integrator import staged_step

    _, name, nx, ny, spp, _ = BIG_SCENES[0]
    scene = build_scene(name, nx, ny).to(dev)
    tables = scene.tables
    s = _staged_pool(scene, nx, ny, spp, dev, 20)
    R, ncols, scal, pool = s["R"], s["ncols"], s["scal"], s["pool"]
    q, hist, fb, lost, u_media = s["q"], s["hist"], s["fb"], s["lost"], s["u_media"]
    o = (pool["ox"], pool["oy"], pool["oz"])
    d = (pool["dx"], pool["dy"], pool["dz"])
    tm = pool["tm"]
    log(f"  R = {R}, final_scene pool after 20 iterations: {int(pool['act'].sum())} live; "
        f"{tables.n_boxes} grid boxes ({tables.box_grid_kx}x{tables.box_grid_kz}), "
        f"{tables.n_spheres} spheres ({tables.sph_n_tail} in the tail), "
        f"{tables.n_media} media")

    # ---- K9 and K10 against their twins, each other and K6 ----
    t10 = dataclasses.replace(tables, box_grid_cells=None, box_grid_cell_rows=None)
    t6 = dataclasses.replace(tables, box_grid_kx=0)
    k9, p9 = K.box_grid_cells_hit_attrs(tables, o, d), K.box_grid_cells_hit_attrs_plain(
        tables, o, d)
    k10, p10 = K.box_grid_hit_attrs(t10, o, d), K.box_grid_hit_attrs_plain(t10, o, d)
    k6 = K.box_hit_attrs(t6, o, d)
    torch.cuda.synchronize()
    hits = int((k9[0] < BIG).sum())
    for label, k, p in (("K9", k9, p9), ("K10", k10, p10)):
        bad = _equal(k, p)
        checks.expect(bad == 0, f"{label} on the final_scene pool: {bad} values differ from "
                                f"the twin ({hits} hits of {R})")
        results["box_grid_cells" if label == "K9" else "box_grid"]["max_abs_err"] = max(
            _max_diff(x, y) for x, y in zip([k[0], *k[1], k[2], k[3]],
                                            [p[0], *p[1], p[2], p[3]]))
    # K9's form, and the lanes its warp skip may leave untested: each a miss
    form = K.box_grid_cells_form(tables)
    skip = K.box_grid_skip_p(tables, o, d, T_MIN)
    lanes = float(skip.float().mean())
    warps = float(skip[: R // 32 * 32].reshape(-1, 32).all(dim=1).float().mean())
    missed = bool((p9[0][skip] == BIG).all())
    checks.expect(form == "hoisted" and missed,
                  f"K9 on the final_scene pool: {form} form ({tables.box_grid_kx} + "
                  f"{tables.box_grid_kz} slab columns); the skip predicate holds on "
                  f"{lanes:.4f} of the lanes, every one a miss of the twin: {missed}; "
                  f"{warps:.4f} of the warps test no cell")
    same_t = bool(torch.equal(k9[0], k10[0]))
    attrs = torch.ones(R, dtype=torch.bool, device=dev)
    for x, y in zip([*k9[1], k9[2], k9[3], k9[4]], [*k10[1], k10[2], k10[3], k10[4]]):
        attrs &= x == y
    share = float(attrs[k9[0] < BIG].float().mean())
    checks.expect(same_t and share >= 0.999,
                  f"K9 against K10: hit mask and t equal {same_t}, attributes equal on "
                  f"{share:.5f} of the hits (>= 0.999)")
    # the lattice's incremental slabs (ex0 + ix sxv) round otherwise than
    # K6's (min - o) / d; a ray grazing a box it starts on can then hit it
    # just past t_min in one and not the other, so an equal hit mask and t
    # within 2e-5 everywhere cannot hold; the bars sit near what this pool
    # gives (on an H100: 9 flips, 242 of 61363 hits beyond 2e-5; on the CPU
    # twins, an 8192-ray final_scene pool: 2 flips, 8 of 3781 hits)
    h9, h6 = k9[0] < BIG, k6[0] < BIG
    both = h9 & h6
    rel = ((k9[0] - k6[0]).abs() / k6[0].abs().clamp_min(1e-30))[both]
    far, flips = int((rel > 2e-5).sum()), int((h9 != h6).sum())
    checks.expect(flips <= 30 and far <= int(both.sum()) // 200,
                  f"K9 against K6 over the same 400 boxes: {flips} hit-mask flips "
                  f"(<= 30), {far} of {int(both.sum())} hits beyond 2e-5 relative "
                  f"(<= 0.5%), t max rel err {float(rel.max()):.3g}")
    results["_grid"] = {"hits": hits, "k9_k6_flips": flips,
                        "k9_k6_t_max_rel": float(rel.max()), "k9_k6_beyond_2e-5": far,
                        "k9_form": form, "k9_skip_lanes": lanes, "k9_skip_warps": warps}

    # ---- the split against its twin and the full-table K2 ----
    split = cs.sphere_hit_attrs_split(tables, o, d, tm)
    split_p = cs.sphere_hit_attrs_split(tables, o, d, tm, plain=True)
    full = K.sphere_hit_attrs(tables, o, d, tm)
    full_p = K.sphere_hit_attrs_plain(tables, o, d, tm)
    head = K.sphere_hit_attrs(tables, o, d, tm, rows=tables.sph_head_rows)
    tail = K.sphere_hit_attrs(tables, o, d, tm, rows=tables.sph_tail_rows)
    torch.cuda.synchronize()
    bad = _equal(full, full_p)
    checks.expect(bad == 0, f"K2 on the final_scene pool: {bad} values differ from the twin "
                            f"({int((full[0] < BIG).sum())} hits of {R})")
    r2 = results["sphere_hit"]
    r2["max_abs_err"] = max(r2["max_abs_err"] or 0.0, *(
        _max_diff(x, y) for x, y in zip([full[0], *full[1], full[2]],
                                        [full_p[0], *full_p[1], full_p[2]])))
    r2["ms_final_scene"] = _timed_ms(lambda: K.sphere_hit_attrs(tables, o, d, tm), 20)
    r2["plain_ms_final_scene"] = _timed_ms(lambda: K.sphere_hit_attrs_plain(tables, o, d, tm),
                                           3)
    ops = R * _sphere_row_ops(tables.sph_rows)
    r2["bound_ms_final_scene"] = max((R * 48 + tables.n_spheres * 40) / HBM_BYTES_PER_S,
                                     ops / FP32_OPS_PER_S) * 1e3
    log(f"  K2 on the final_scene pool: {r2['ms_final_scene']:.4f} ms, plain "
        f"{r2['plain_ms_final_scene']:.4f} ms, bound {r2['bound_ms_final_scene']:.4f} ms")
    ties = int(((head[0] == tail[0]) & (head[0] < BIG)).sum())
    bad_p, bad_f = _equal(split, split_p), _equal(split, full)
    needy = cs.tail_box_needy(tables.sph_tail_box, o, d, T_MIN)
    n_needy = int(needy.sum())
    checks.expect(bad_p == 0 and bad_f == 0,
                  f"split sphere pass: {bad_p} values differ from its twin, {bad_f} from the "
                  f"full-table K2 ({ties} exact head/tail ties), {n_needy} needy lanes "
                  f"({n_needy / R:.3f})")
    # K2 with n_live on the compacted slots, against its twin
    ray_k = cf.compact_ray_ids(needy)
    rays_k = torch.stack([*o, *d]).index_select(1, ray_k)
    ok_, dk_ = tuple(rays_k[0:3]), tuple(rays_k[3:6])
    z = torch.zeros_like(rays_k[0])
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    kt = K.sphere_hit_attrs(tables, ok_, dk_, z, rows=tables.sph_tail_rows, n_live=cnt)
    pt = K.sphere_hit_attrs_plain(tables, ok_, dk_, z, rows=tables.sph_tail_rows, n_live=cnt)
    torch.cuda.synchronize()
    bad = _equal(kt, pt)
    checks.expect(bad == 0 and bool((kt[0][n_needy:] == BIG).all()),
                  f"K2 with n_live = {n_needy} on {ray_k.shape[0]} compacted slots: {bad} "
                  f"values differ from the twin, every slot past the count misses")
    r2["ms_tail_n_live"] = _timed_ms(lambda: K.sphere_hit_attrs(
        tables, ok_, dk_, z, rows=tables.sph_tail_rows, n_live=cnt), 20)
    r2["plain_ms_tail_n_live"] = _timed_ms(lambda: K.sphere_hit_attrs_plain(
        tables, ok_, dk_, z, rows=tables.sph_tail_rows, n_live=cnt), 3)
    r2["n_live"] = n_needy
    split_parent_checks(checks, tables, o, d, tm, needy, results)
    # the needy lanes against the 1000 static tail rows; 7 planes in, 5 out a
    # live slot
    by_bytes, by_ops = n_needy * 48, n_needy * _sphere_row_ops(tables.sph_tail_rows)
    r2["bound_ms_tail_n_live"] = max(by_bytes / HBM_BYTES_PER_S, by_ops / FP32_OPS_PER_S) * 1e3
    split_ms = _timed_ms(lambda: cs.sphere_hit_attrs_split(tables, o, d, tm), 20)
    full_ms = _timed_ms(lambda: K.sphere_hit_attrs(tables, o, d, tm), 20)
    results["_split"] = {
        "R": R, "needy": n_needy, "ties": ties, "split_ms": split_ms, "full_k2_ms": full_ms,
        "split_plain_ms": _timed_ms(
            lambda: cs.sphere_hit_attrs_split(tables, o, d, tm, plain=True), 3),
        "split_names": _captured_names(lambda: cs.sphere_hit_attrs_split(tables, o, d, tm)),
        "full_k2_launches": _captured_launches(lambda: K.sphere_hit_attrs(tables, o, d, tm))}

    results["_split"]["split_launches"] = sum(results["_split"]["split_names"].values())

    # ---- the media (K18, media_checks), then the launches of a whole staged
    # iteration (on a copy of the pool made outside the captured call) ----
    media_checks(checks, dev, results, tables, o, d, tm, u_media)
    staged = (_clone(pool), scene.camera, q.clone(), 0, hist.clone(), 20, scal, tables,
              scene.background, fb.clone(), lost.clone())
    results["_media"]["staged_step_launches"] = _captured_launches(lambda: staged_step(
        *staged, key=(7, 0, 0), ncols=ncols, max_depth=50, gradient=scene.gradient_bg))

    # ---- times and bounds: 6 planes in and 7 out a ray, the cell list once;
    # K10 on final_scene's table beside K9 (same work), and at its own
    # path's shapes in box_field_checks ----
    r = results["box_grid_cells"]
    cells = tables.box_grid_cell_rows.shape[0]
    r["ms"] = _timed_ms(lambda: K.box_grid_cells_hit_attrs(tables, o, d), 20)
    r["plain_ms"] = _timed_ms(lambda: K.box_grid_cells_hit_attrs_plain(tables, o, d), 3)
    # the cell tests these rays need: none for a lane the skip predicate
    # proves a miss
    need = R - int(skip.sum())
    _set_bound(r, R * 52 + cells * 16, need * cells * OPS_GRID_CELL + hits * OPS_BOX_WINNER)
    r["cells"] = cells
    r = results["box_grid"]
    r["ms_final_scene_table"] = _timed_ms(lambda: K.box_grid_hit_attrs(t10, o, d), 20)
    r["plain_ms_final_scene_table"] = _timed_ms(
        lambda: K.box_grid_hit_attrs_plain(t10, o, d), 3)
    r["grid_tests_final_scene_table"] = _grid_test_stats(_grid_tests(t10, o, d))
    results["box_hit"]["ms_final_scene_boxes"] = _timed_ms(lambda: K.box_hit_attrs(t6, o, d),
                                                           20)
    box_field_checks(checks, dev, results)
    long_field_checks(checks, dev, results)
    _log_kernels(results, ("box_grid_cells", "box_grid"))
    ft = r["grid_tests_final_scene_table"]
    log(f"  K10 on final_scene's table: {r['ms_final_scene_table']:.4f} ms (plain "
        f"{r['plain_ms_final_scene_table']:.4f} ms), {ft['mean']:.3f} cells a ray of "
        f"{t10.box_grid_kx * t10.box_grid_kz} (the warps' most {ft['warp_max_mean']:.3f}); "
        f"on the box field {r['grid_tests']['mean']:.3f} of {r['cells']} (the warps' most "
        f"{r['grid_tests']['warp_max_mean']:.3f}), bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; every cell a ray: {r['bound_ms_all_cells']:.4f} ms)")
    s = results["_split"]
    log(f"  split sphere pass {s['split_ms']:.4f} ms ({s['split_launches']} launches) "
        f"against the full-table K2 {s['full_k2_ms']:.4f} ms ({s['full_k2_launches']}); "
        f"K2 tail at n_live {n_needy}: {r2['ms_tail_n_live']:.4f} ms; K6 over the same "
        f"boxes {results['box_hit']['ms_final_scene_boxes']:.4f} ms")
    log(f"  one staged final_scene iteration: {results['_media']['staged_step_launches']} "
        f"launches")


OPS_MEDIUM = 45  # K18 a ray and analytic medium: the interval ~27, its rules 4,
#                 the clip 3, the free flight and t_m 5 (logf as one), tests 4;
#                 a ray: |d| 6 and p 6


def _every_kind_media():
    """A scene of one medium of each boundary kind and form: an analytic
    sphere (kind 0), a rotated box (kind 1), and kind-2 boundaries as
    tests/test_media_general.py builds them: a group of a box and a sphere,
    a bare quad, a union of two boxes, a moving sphere."""
    from art_tpu_torch.scene import builder, materials as M, objects as O

    mat = M.Lambertian((0.5, 0.5, 0.5))
    box = O.Box((-3, -2, -4), (2, 3, 1), mat)
    b = builder.SceneBuilder().add(
        O.ConstantMedium(O.Sphere((0.5, -1.0, 2.0), 3.0, mat), 0.5, (1, 1, 1)),
        O.ConstantMedium(O.Group(box, O.Sphere((4, 0, 0), 1.5, mat)), 0.35, (0.2, 0.4, 0.9)),
        O.ConstantMedium(O.Translate(O.RotateY(O.Box((-1, -1, -1), (1, 1, 1), mat), 30.0),
                                     (2, 0, -1)), 0.4, (1, 1, 1)),
        O.ConstantMedium(O.Quad((-1, -1, 0), (2, 0, 0), (0, 2, 0), mat), 5.0, (1, 1, 1)),
        O.ConstantMedium(O.Group(O.Box((-1, -1, 0), (1, 1, 2), mat),
                                 O.Box((-1, -1, 5), (1, 1, 7), mat)), 0.8, (1, 1, 1)),
        O.ConstantMedium(O.Sphere((0, 0, 0), 3.0, mat, center2=(4, 0, 0)), 0.6, (1, 1, 1)))
    b.set_camera(lookfrom=(0, 0, 10), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.compile().tables


def media_checks(checks: Checks, dev, results: dict, tables, o, d, tm, u_media):
    """K18 (``apply_media_p`` on CUDA tensors) bit-equal to its twin
    (``plain=True``) in every output on phase 2e's final_scene pool (the
    record of the default ``closest_surface_p``), on a cornell_smoke 600x600
    @ 64 pool 20 staged iterations in (two rotated boxes) and on R = 2^17
    random rays through ``_every_kind_media``'s six media over a random
    surface record, u at 0, 1e-6 and 1 - 2^-24 on some lanes; one launch a
    call; on final_scene's pool its device time, the twin's, the bound
    (bytes) and the host time a call (back-to-back calls, which the device
    keeps up with)."""
    import numpy as np
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops.intersect import HitRecordP, apply_media_p, closest_surface_p

    def flat(rec):
        return [rec.hit, rec.t, *rec.p, *rec.normal, rec.u, rec.v, rec.mat]

    def differ(a, b):  # values whose bits differ
        return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   if x.dtype == torch.float32 else int((x != y).sum())
                   for x, y in zip(flat(a), flat(b)))

    smoke = build_scene("cornell_smoke", 600, 600).to(dev)
    s = _staged_pool(smoke, 600, 600, 64, dev, 20)
    sp = s["pool"]
    every = _every_kind_media().to(dev)
    R = o[0].shape[0]
    rng = np.random.default_rng(2323)

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    u6 = rng.random((every.n_media, R), dtype=np.float32)
    for k, value in enumerate((0.0, 1e-6, 1.0 - 2.0 ** -24)):
        u6[:, k::7] = value
    rt = np.where(rng.random(R) < 0.5, rng.uniform(0.5, 30.0, R), 1e30)
    rand_surf = HitRecordP(
        hit=torch.from_numpy(rt < 1e30).to(dev), t=T(rt),
        p=tuple(T(rng.uniform(-5, 5, R)) for _ in range(3)),
        normal=tuple(T(rng.uniform(-1, 1, R)) for _ in range(3)),
        u=T(rng.random(R)), v=T(rng.random(R)),
        mat=torch.from_numpy(rng.integers(0, 6, R).astype(np.int32)).to(dev))
    pools = {
        "final_scene": (tables, o, d, tm, closest_surface_p(tables, o, d, tm, T_MIN), u_media),
        "cornell_smoke": (smoke.tables, (sp["ox"], sp["oy"], sp["oz"]),
                          (sp["dx"], sp["dy"], sp["dz"]), sp["tm"],
                          closest_surface_p(smoke.tables, (sp["ox"], sp["oy"], sp["oz"]),
                                            (sp["dx"], sp["dy"], sp["dz"]), sp["tm"], T_MIN),
                          s["u_media"]),
        "every kind": (every, tuple(T(rng.uniform(-10, 10, R)) for _ in range(3)),
                       tuple(T(rng.uniform(-1, 1, R)) for _ in range(3)), T(rng.random(R)),
                       rand_surf, T(u6))}
    out = {"n_media": tables.n_media}
    r = results["media"]
    r["max_abs_err"] = 0.0
    for label, (t, po, pd, ptm, surf, u) in pools.items():
        def call(plain=False):
            return apply_media_p(t, po, pd, T_MIN, surf, u, time=ptm, plain=plain)

        k, p = call(), call(True)
        torch.cuda.synchronize()
        bad = differ(k, p)
        launches = _captured_launches(call)
        scattered = int((k.t != surf.t).sum())
        checks.expect(bad == 0 and launches == 1,
                      f"K18 on the {label} pool ({t.n_media} media, kinds {t.med_kinds}): "
                      f"{bad} values differ from the twin in bits, {scattered} of "
                      f"{po[0].shape[0]} lanes scatter; {launches} launch a call")
        r["max_abs_err"] = max(r["max_abs_err"], *(
            _max_diff(x, y) for x, y in zip(flat(k)[1:10], flat(p)[1:10])))
        out[label] = dict(differ=bad, scattered=scattered, launches=launches,
                          kinds=list(t.med_kinds))
    t, po, pd, ptm, surf, u = pools["final_scene"]

    def k18():
        return apply_media_p(t, po, pd, T_MIN, surf, u, time=ptm)

    r["ms"] = _timed_ms(k18, 20)
    r["plain_ms"] = _timed_ms(lambda: apply_media_p(t, po, pd, T_MIN, surf, u, time=ptm,
                                                    plain=True), 3)
    # 15 f32 planes, hit and mat of the record and one uniform a medium in;
    # 9 f32 planes, hit and mat out; the table once
    C = t.n_media
    _set_bound(r, R * (15 * 4 + 1 + 4 + 4 * C + 9 * 4 + 1 + 4) + t.med_rows.numel() * 4,
               R * (12 + OPS_MEDIUM * C))
    hosts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            k18()
        hosts.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    out.update(launches=out["final_scene"]["launches"], ms=r["ms"], plain_ms=r["plain_ms"],
               bound_ms=r["bound_ms"], host_us=float(np.median(hosts)), host_us_all=hosts)
    results["_media"] = out
    log(f"  K18 on final_scene's pool: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms, {r['bound_by']}), host {out['host_us']:.1f} us a "
        f"call (back to back, the device keeping up); cornell_smoke and every-kind pools "
        f"bit-equal: "
        f"{out['cornell_smoke']['differ'] == 0}, {out['every kind']['differ'] == 0}")


def split_parent_checks(checks: Checks, tables, o, d, tm, needy, results: dict):
    """On phase 2e's final_scene pool: K2 with ``n_live`` and K16's
    tail-only call give the same values on the compacted slots whatever
    the ray planes hold past the needy count (the compaction form leaves
    them unspecified: here NaN); the split, with K2's tail and with K16's
    tail-only call, bit-equal to the split on the pipeline the compaction
    form replaced (``_parent_compaction``); the split's time against
    that split's."""
    import torch

    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as cs
    from art_tpu_torch.ops import intersect_kernels as K

    ids, cnt, rays_k, _ = cf.compact(needy, (*o, *d))
    n = int(cnt)
    nan = tuple(torch.cat([p[:n], torch.full_like(p[n:], float("nan"))]) for p in rays_k)
    z = torch.zeros_like(rays_k[0])
    for label, fn in (
            ("K2 with n_live", lambda r: K.sphere_hit_attrs(
                tables, r[0:3], r[3:6], z, rows=tables.sph_tail_rows, n_live=cnt)),
            ("K16 tail-only", lambda r: K.sphere_skip_hit_attrs(
                tables, r[0:3], r[3:6], z, tail_only=True, n_live=cnt))):
        a, b = fn(rays_k), fn(nan)
        torch.cuda.synchronize()
        bad = _equal(a, b)
        checks.expect(bad == 0, f"{label} on the {ids.shape[0]} compacted slots: {bad} values "
                                f"differ when the rays past the count ({n}) are NaN")
    split = {}
    for skip in (False, True):
        new = cs.sphere_hit_attrs_split(tables, o, d, tm, skip_tail=skip)
        compact = cf.compact
        cf.compact = lambda m, planes=(), **kw: _parent_compaction(m, planes)
        try:
            old = cs.sphere_hit_attrs_split(tables, o, d, tm, skip_tail=skip)
            ms_old = _timed_ms(lambda: cs.sphere_hit_attrs_split(tables, o, d, tm,
                                                                 skip_tail=skip), 20)
            old_names = _captured_names(lambda: cs.sphere_hit_attrs_split(
                tables, o, d, tm, skip_tail=skip))
        finally:
            cf.compact = compact
        torch.cuda.synchronize()
        bad = _equal(new, old)
        label = "K16 tail-only" if skip else "K2 tail"
        checks.expect(bad == 0, f"the split ({label}) on the final_scene pool: {bad} values "
                                f"differ from the split on the pipeline the compaction form "
                                f"replaced")
        split[label] = dict(
            ms=_timed_ms(lambda: cs.sphere_hit_attrs_split(tables, o, d, tm, skip_tail=skip),
                         20),
            launches=sum(_captured_names(lambda: cs.sphere_hit_attrs_split(
                tables, o, d, tm, skip_tail=skip)).values()),
            parent_ms=ms_old, parent_launches=sum(old_names.values()))
        log(f"  split ({label}): {split[label]['ms']:.4f} ms in {split[label]['launches']} "
            f"launches; on the pipeline the compaction form replaced "
            f"{ms_old:.4f} ms in {split[label]['parent_launches']}")
    results["_split_parent"] = split


def _ties(k, full):
    """(t bit-equal, lanes whose winner differs at that equal t: exact ties
    between segments) of a culled result against the full-table kernel's:
    (t, normal, mat) or (t, normal, u, v, mat) records."""
    differ = k[-1] != full[-1]
    for x, y in zip((*k[1], *k[2:-1]), (*full[1], *full[2:-1])):
        differ |= x != y
    return bool(k[0].eq(full[0]).all()), int(differ.sum())


def _warp_counts(lanes, n_rows):
    """(the lanes' (ray, primitive) tests of ``n_rows`` rows, the tests the
    kernel's warps make: each warp of 32 consecutive lanes with such a lane
    counted whole)."""
    import torch

    warps = torch.cat([lanes, lanes.new_zeros((-lanes.shape[0]) % 32)]).view(-1, 32)
    return int(lanes.sum()) * n_rows, int(warps.any(dim=1).sum()) * 32 * n_rows


def _spread_counts(lanes, n_rows):
    """(the lanes' (ray, primitive) tests of ``n_rows`` rows, the tests
    K16's threads make for them (``csrc/sphere.cuh`` spread_hit): for each
    tile of 256 lanes with nc testing lanes and each chunk of cn <= 64
    rows, each lane's hn = 256 // nc threads, thread h taking the rows h,
    h + hn, ... four at a time (a last short step still tests four))."""
    import torch

    tiles = torch.cat([lanes, lanes.new_zeros((-lanes.shape[0]) % 256)]).view(-1, 256).sum(1)
    made = 0
    for nc, count in zip(*torch.unique(tiles[tiles > 0], return_counts=True)):
        nc, hn = int(nc), 256 // int(nc)
        for c0 in range(0, n_rows, 64):
            cn = min(64, n_rows - c0)
            steps = sum(-(-(cn - h) // (4 * hn)) for h in range(min(hn, cn)))
            made += int(count) * nc * 4 * steps
    return int(lanes.sum()) * n_rows, made


def _tie_table():
    """(rows, meta) of a skip table whose sphere A (radius 1.5 at the
    origin) sits in the head (material 1) and in two bins (materials 2, 3),
    between other spheres; the bins' boxes as ``cull.pack_skip`` makes them
    (tests/test_torch_rule2_mxu_skip.py's tie table)."""
    import torch

    from art_tpu_torch.scene import cull

    def row(c, r, mat):
        return [*c, 0.0, 0.0, 0.0, r, mat, r * r, 0.0]

    A = (0.0, 0.0, 0.0)
    head = [row((0.0, -100.0, 0.0), 90.0, 0), row(A, 1.5, 1)]
    bins = [[row((3.0, 0.5, 0.0), 1.0, 4), row(A, 1.5, 2), row((-3.0, 0.0, 1.0), 0.8, 5)],
            [row(A, 1.5, 3), row((0.0, 3.0, -2.0), 1.0, 6)]]
    rows = np.asarray(head + bins[0] + bins[1], np.float32)
    segs, r0 = [], len(head)
    for b in bins:
        g = np.asarray(b, np.float32)
        segs.append((r0, r0 + len(g), cull._box(*cull._bounds(g, swept=False))))
        r0 += len(g)
    union = cull._box(*cull._bounds(rows[len(head):], swept=False))
    return torch.from_numpy(rows), (len(head), tuple(segs), union)


def _culled_tests(rows, meta, o, d, tm, occlusion, head=True, n_live=None):
    """The (ray, sphere) tests that K16 (``occlusion`` False), K17 or K15's
    spheres (True; K15 without a head) needs on these rays, walked as its
    twin walks them: the live lanes times the head rows, then each segment's
    rows times the lanes whose slab test of its box passes (with
    ``occlusion``, at t_near <= the running best).  Returns (those tests,
    the tests the kernel's threads make: K17's and K15's whole warps,
    ``_warp_counts`` (K17's parts share a warp's rows between them, so
    they make the same tests); K16's, ``_spread_counts``)."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import slab_interval

    n_head, segs, box = meta
    n_head = n_head if head else 0
    t = K.sphere_hit_attrs_plain(None, o, d, tm, T_MIN, rows=rows[:n_head], n_live=n_live)[0]
    live = torch.ones_like(t, dtype=torch.bool) if n_live is None else torch.arange(
        t.shape[0], dtype=torch.int32, device=t.device) < n_live
    ok, t_near = slab_interval(box, o, d, T_MIN)
    needy = ok & live & ((t_near <= t) if occlusion else True)
    count = _warp_counts if occlusion else _spread_counts
    counts = [count(live, n_head)]
    for row0, row1, seg_box in segs:
        ok, t_near = slab_interval(seg_box, o, d, T_MIN)
        cross = needy & ok & ((t_near <= t) if occlusion else True)
        counts.append(count(cross, row1 - row0))
        t_s = K.sphere_hit_attrs_plain(None, o, d, tm, T_MIN, rows=rows[row0:row1])[0]
        t = torch.where(cross & (t_s < t), t_s, t)
    return tuple(sum(x) for x in zip(*counts))


_POOLS: dict = {}


def _pool_rays(scene, nx, ny, spp, dev, iters):
    """(tables, o, d, tm) of ``_staged_pool``'s pool after ``iters``
    iterations, logged."""
    s = _staged_pool(scene, nx, ny, spp, dev, iters)
    pool = s["pool"]
    log(f"  {scene.name} {nx}x{ny} @ {spp} pool after {iters} iterations: R = {s['R']}, "
        f"{int(pool['act'].sum())} live")
    return (scene.tables, (pool["ox"], pool["oy"], pool["oz"]),
            (pool["dx"], pool["dy"], pool["dz"]), pool["tm"])


def _route_pools(dev):
    """The bouncing_spheres 1200x800 and final_scene 800x800 pools 20 staged
    iterations in (R = 2^17), built once for phases 2f and 2g."""
    from art_tpu_torch.models import build_scene

    if not _POOLS:
        for name, nx, ny, spp in (BOUNCING[:4], ("final_scene", 800, 800, 16)):
            _POOLS[name] = _pool_rays(build_scene(name, nx, ny).to(dev), nx, ny, spp, dev, 20)
    return _POOLS


def _route_record(tables, o, d, tm, plain=False, **switches):
    """closest_surface_p's record under the route ``switches``."""
    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops import routes
    from art_tpu_torch.ops.intersect import closest_surface_p

    with routes.using(**switches):
        rec = closest_surface_p(tables, o, d, tm, T_MIN, plain=plain)
    return rec.t, rec.normal, rec.u, rec.v, rec.mat


def cull_checks(checks: Checks, dev, results: dict):
    """K16 and K17 against their twins and the full-table K2, on a
    bouncing_spheres 1200x800 pool (K17's whole-set lattice) and a
    final_scene 800x800 pool (K16 standalone and tail-only with n_live, K17's
    tail lattice), 20 staged iterations in (R = 2^17); K2 bit-equal to its
    twin on both; every opt-in route's closest_surface_p record equal to its
    plain record and to the default route's; times and bounds."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import compact_fetch as cf
    from art_tpu_torch.ops import compact_sphere as cs
    from art_tpu_torch.ops import intersect_kernels as K

    pools = _route_pools(dev)
    fin, fo, fd, ftm = pools["final_scene"]
    # the split's compacted slots on the final_scene pool (phase 2e's)
    needy = cs.tail_box_needy(fin.sph_tail_box, fo, fd, T_MIN)
    cnt = needy.sum(dtype=torch.int32).reshape(1)
    rays_k = torch.stack([*fo, *fd]).index_select(1, cf.compact_ray_ids(needy))
    ko, kd, kz = tuple(rays_k[0:3]), tuple(rays_k[3:6]), torch.zeros_like(rays_k[0])

    def case(tables, o, d, tm, **kw):
        return (lambda: K.sphere_skip_hit_attrs(tables, o, d, tm, **kw),
                lambda: K.sphere_skip_hit_attrs_plain(tables, o, d, tm, **kw))

    bt, bo, bd, btm = pools["bouncing_spheres"]
    cases = [  # (label, kernel, its twin, the full-table K2, rows, meta, occlusion, kw)
        ("K17 whole-set lattice, bouncing_spheres", "sphere_cellbin",
         lambda: K.sphere_cellbin_hit_attrs(bt, bo, bd, btm),
         lambda: K.sphere_cellbin_hit_attrs_plain(bt, bo, bd, btm),
         lambda: K.sphere_hit_attrs(bt, bo, bd, btm),
         lambda: K.sphere_hit_attrs_plain(bt, bo, bd, btm),
         (bt.sph_cellbin_rows, bt.sph_cellbin_meta, bo, bd, btm, True, {})),
        ("K16 skip bins, final_scene", "sphere_skip", *case(fin, fo, fd, ftm),
         lambda: K.sphere_hit_attrs(fin, fo, fd, ftm),
         lambda: K.sphere_hit_attrs_plain(fin, fo, fd, ftm),
         (fin.sph_skip_rows, fin.sph_skip_bins, fo, fd, ftm, False, {})),
        ("K16 tail-only, n_live, final_scene's compacted slots", "sphere_skip",
         *case(fin, ko, kd, kz, tail_only=True, n_live=cnt),
         lambda: K.sphere_hit_attrs(fin, ko, kd, kz, rows=fin.sph_tail_rows, n_live=cnt),
         lambda: K.sphere_hit_attrs_plain(fin, ko, kd, kz, rows=fin.sph_tail_rows,
                                          n_live=cnt),
         (fin.sph_skip_rows, fin.sph_skip_bins, ko, kd, kz, False,
          dict(head=False, n_live=cnt))),
        ("K17 tail lattice, final_scene", "sphere_cellbin",
         lambda: K.sphere_cellbin_hit_attrs(fin, fo, fd, ftm),
         lambda: K.sphere_cellbin_hit_attrs_plain(fin, fo, fd, ftm),
         lambda: K.sphere_hit_attrs(fin, fo, fd, ftm),
         lambda: K.sphere_hit_attrs_plain(fin, fo, fd, ftm),
         (fin.sph_cellbin_rows, fin.sph_cellbin_meta, fo, fd, ftm, True, {}))]
    suffix = {0: "", 1: "", 2: "_tail_only", 3: "_tail_lattice"}
    cull = results.setdefault("_cull", {})
    for n, (label, kname, kern, twin, full, full_p, bound) in enumerate(cases):
        k, p, f, fp = kern(), twin(), full(), full_p()
        torch.cuda.synchronize()
        bad, bad_k2 = _equal(k, p), _equal(f, fp)
        same_t, ties = _ties(k, f)
        hits = int((f[0] < 1e30).sum())
        checks.expect(bad == 0 and bad_k2 == 0 and same_t,
                      f"{label}: {bad} values differ from the twin (K2 against its twin: "
                      f"{bad_k2}); against the full-table K2 t bit-equal {same_t}, {ties} "
                      f"exact ties between segments, {hits} hits")
        rows, meta, o, d, tm, occlusion, kw = bound
        lane_tests, warp_tests = _culled_tests(rows, meta, o, d, tm, occlusion, **kw)
        R = o[0].shape[0]
        ms = _timed_ms(kern, 20)
        entry = dict(ms=ms, plain_ms=_timed_ms(twin, 3), full_k2_ms=_timed_ms(full, 20),
                     ties=ties, hits=hits, R=R, segments=len(meta[1]), head_rows=meta[0],
                     tests=lane_tests, warp_tests=warp_tests,
                     full_tests=R * (meta[0] + sum(b - a for a, b, _ in meta[1])),
                     max_abs_err=max(
                         _max_diff(x, y) for x, y in zip([k[0], *k[1], k[2]],
                                                         [p[0], *p[1], p[2]])))
        # 7 planes in a live lane and 5 out a slot, the table and its
        # segments once; the (ray, sphere) tests these rays need at K2's
        # operations a test
        live = int(kw["n_live"]) if "n_live" in kw else R
        _set_bound(entry, live * 28 + R * 20 + rows.shape[0] * 40 + (len(meta[1]) + 1) * 32,
                   lane_tests * OPS_SPHERE)
        cull[label] = entry
        r = results[kname]
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err"):
            if n in (0, 1):
                r[key] = entry[key]
            else:
                r[key + suffix[n]] = entry[key]
        log(f"  {label}: kernel {ms:.4f} ms, plain {entry['plain_ms']:.4f} ms, full-table K2 "
            f"{entry['full_k2_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}); (ray, sphere) tests: {lane_tests} needed, {warp_tests} "
            f"by the kernel's threads ({'whole warps' if occlusion else 'spread_hit'}), "
            f"{entry['full_tests']} in the full table; {len(meta[1])} segments, "
            f"head {meta[0]} rows")

    skip_tie_checks(checks, dev)

    # every opt-in route through closest_surface_p: the record equal to its
    # plain record and, but for exact ties, to the default route's, with
    # each route's kernels launched
    for label, name, *_, switches in ROUTE_RUNS:
        tables, o, d, tm = pools[name]
        base = _route_record(tables, o, d, tm)
        _build.launches.clear()
        rec = _route_record(tables, o, d, tm, **switches)
        counts = dict(_build.launches)
        rec_p = _route_record(tables, o, d, tm, plain=True, **switches)
        torch.cuda.synchronize()
        bad = _equal(rec, rec_p)
        same_t, ties = _ties((rec[0], rec[1], rec[4]), (base[0], base[1], base[4]))
        want = [k for k in ("sphere_hit", "sphere_skip", "sphere_cellbin")
                if k in PATHS[label]]
        launched = [k for k in ("sphere_hit", "sphere_skip", "sphere_cellbin") if counts.get(k)]
        checks.expect(bad == 0 and same_t and launched == want,
                      f"closest_surface_p under {label} ({switches}): {bad} values differ "
                      f"from its plain record; against the default route t bit-equal "
                      f"{same_t}, {ties} ties; sphere kernels launched {counts}")
        cull[f"closest_surface_p {label}"] = dict(ties=ties, launches=counts)


def skip_tie_checks(checks: Checks, dev):
    """K16 against its twin on ``_tie_table`` (R = 2^17 rays at its sphere
    A, which sits in the head and in two bins under three materials), with
    and without the head: exact ties between segments, the earlier row
    winning (the twin's strict `<`; the kernel's least (t, row) key)."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import sphere_row_t_p
    from art_tpu_torch.scene import cull

    rows, meta = _tie_table()
    seg = cull.seg_table(meta).to(dev)
    rows = rows.to(dev)
    rng = np.random.default_rng(SEED + 14)
    R = 1 << 17
    o_np = rng.uniform(-20.0, 20.0, (3, R)).astype(np.float32)
    d_np = (rng.uniform(-0.5, 0.5, (3, R)) - o_np).astype(np.float32)
    to = tuple(torch.from_numpy(x).to(dev) for x in o_np)
    td = tuple(torch.from_numpy(x).to(dev) for x in d_np)
    ttm = torch.from_numpy(rng.random(R, dtype=np.float32)).to(dev)
    for head in (True, False):
        k = K._culled_launch(K.SKIP, rows, seg, meta[0] if head else 0, to, td, ttm, T_MIN)
        p = K.culled_plain(rows, meta, to, td, ttm, T_MIN, occlusion=False, head=head)
        t_all = sphere_row_t_p(rows, to, td, ttm, T_MIN)
        copies = [1, 3, 5] if head else [3, 5]
        tie = (t_all[:, copies] == t_all[:, copies[:1]]).all(dim=1) & (t_all[:, copies[0]]
                                                                      < BIG)
        torch.cuda.synchronize()
        bad = _equal(k, p)
        first = int((k[2][tie & (k[0] == t_all[:, copies[0]])] == (1 if head else 2)).sum())
        checks.expect(bad == 0 and int(tie.sum()) > R // 2
                      and first == int((tie & (k[0] == t_all[:, copies[0]])).sum()),
                      f"K16 on the tie table (head {head}, R = {R}): {bad} values differ from "
                      f"the twin; {int(tie.sum())} lanes with an exact tie between segments, "
                      f"the earliest copy winning on {first} of those it wins")


def _rotated_field(nx: int, ny: int):
    """A 12x12 field of boxes each turned about y (144 rotated boxes: K6's
    rotated form by default, three box clusters under ART_TPU_CLUSTER; no
    registry scene has 32 or more rotated boxes) under a gradient sky."""
    from art_tpu_torch.scene import materials as M
    from art_tpu_torch.scene import objects as O
    from art_tpu_torch.scene.builder import SceneBuilder

    mats = [M.Lambertian((0.7, 0.6, 0.5)), M.Metal((0.8, 0.8, 0.9), 0.2)]
    b = SceneBuilder().set_name("rotated field")
    for ix in range(12):
        for iz in range(12):
            h = 1.0 + (ix * 5 + iz * 3) % 7
            box = O.Box((0.0, 0.0, 0.0), (2.0, h, 2.0), mats[(ix + iz) % 2])
            b.add(O.Translate(O.RotateY(box, float((ix * 37 + iz * 53) % 90 - 45)),
                              (ix * 4.0, 0.0, iz * 4.0)))
    b.set_camera(lookfrom=(22, 30, -30), lookat=(22, 0, 22), vup=(0, 1, 0),
                 vfov_degrees=50.0, aspect=nx / ny, time0=0.0, time1=1.0)
    b.set_background(gradient=True)
    return b.compile()


def _many_clusters(n: int = 4500, seed: int = SEED + 16):
    """(rows, meta) of a K15 sphere table of ``n`` spheres from a numpy seed
    (radii 0.15-0.6 in a 120 x 8 x 120 slab, a third of them moving up to
    0.5 in y), in BVH-leaf clusters of 64 as ``scene/cull.py`` cuts them:
    ``n`` > 4096 makes more than 64 clusters, past the cells whose boxes
    K17's kernel stages (no registry scene has as many)."""
    import torch

    from art_tpu_torch.ops import bvh
    from art_tpu_torch.scene import cull

    rng = np.random.default_rng(seed)
    c = rng.uniform((-60.0, 0.0, -60.0), (60.0, 8.0, 60.0), (n, 3))
    v = np.zeros((n, 3))
    moving = rng.random(n) < 1 / 3
    v[moving, 1] = rng.uniform(0.0, 0.5, int(moving.sum()))
    r = rng.uniform(0.15, 0.6, n)
    rows = np.concatenate([c, v, r[:, None], rng.integers(0, 8, n)[:, None], (r * r)[:, None],
                           np.zeros((n, 1))], axis=1).astype(np.float32)
    rows[:, 8] = rows[:, 6] * rows[:, 6]  # r2 as sphere_rows rounds it
    lo, hi = bvh.sphere_world_bounds(rows[:, 0:3], rows[:, 3:6], rows[:, 6])
    ordered, meta = cull._clusters(lo, hi, rows, cull.SPHERE_CLUSTER)
    return torch.from_numpy(ordered), meta


def _many_cluster_rays(dev, R: int = 1 << 17):
    """(rows, seg, meta, o, d, tm) on the card: ``_many_clusters``' table and
    R rays from a numpy seed, origins above its slab, 3/4 of them aimed at
    a sphere's centre (within 0.3), the rest in normal directions."""
    import torch

    from art_tpu_torch.scene import cull

    rows, meta = _many_clusters()
    rng = np.random.default_rng(SEED + 17)
    c = rows.numpy()[:, :3].astype(np.float64)
    o = np.stack([rng.uniform(-70.0, 70.0, R), rng.uniform(10.0, 40.0, R),
                  rng.uniform(-70.0, 70.0, R)])
    target = c[rng.integers(0, len(c), R)].T + rng.normal(scale=0.3, size=(3, R))
    d = np.where(rng.random(R) < 0.75, target - o, rng.normal(size=(3, R)))

    def put(x):
        return tuple(torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev) for v in x)

    return (rows.to(dev), cull.seg_table(meta).to(dev), meta, put(o), put(d),
            put([rng.random(R)])[0])


_CLUSTER_POOLS: dict = {}


def _cluster_pools(dev):
    """Phase 2g's pools, built once: 2f's bouncing_spheres and final_scene
    pools, the box field's (160x90 @ 4, 1 iteration in) and a rotated
    field's (320x240 @ 64, 20 staged iterations in)."""
    if not _CLUSTER_POOLS:
        _CLUSTER_POOLS.update(_route_pools(dev))
        _CLUSTER_POOLS["box field"] = _pool_rays(_box_field(160, 90).to(dev), 160, 90, 4, dev,
                                                 1)
        _CLUSTER_POOLS["rotated field"] = _pool_rays(_rotated_field(320, 240).to(dev), 320,
                                                     240, 64, dev, 20)
    return _CLUSTER_POOLS


def _box_cluster_tests(tables, o, d):
    """The (ray, box) tests that K15's boxes need on these rays, walked as
    its twin walks them: each cluster's rows times the lanes whose bounded
    test of the union box and of the cluster's box passes; and the tests the
    kernel's warps make (``csrc/box_cluster.cu``): a warp with such a lane
    scans the cluster's rows, in the folded form only the aligned groups of
    K15B_GROUP rows whose box (its rows' min and max bounds) a lane of it
    passes against its running best (``_warp_counts``)."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN, safe_dir
    from art_tpu_torch.ops.intersect import box_candidates_rows, cluster_slab

    rows, (_, segs, union) = tables.box_cl_rows, tables.box_cl_meta
    rotated = tables.has_rotated_boxes
    inv = tuple(1.0 / safe_dir(c) for c in d)
    t = torch.full_like(o[0], BIG)
    needy = cluster_slab(union, o, inv, T_MIN, t)
    need = made = 0
    for row0, row1, box in segs:
        cross = needy & cluster_slab(box, o, inv, T_MIN, t)
        need += _warp_counts(cross, row1 - row0)[0]
        step = row1 - row0 if rotated else K15B_GROUP
        for g in range(row0 - (0 if rotated else row0 % step), row1, step):
            r0, r1 = max(g, row0), min(g + step, row1)
            passed = cross
            if not rotated:
                grp = rows[g:min(g + step, rows.shape[0])]
                gbox = tuple(grp[:, k].min() for k in range(3)) + tuple(
                    grp[:, k].max() for k in range(3, 6))
                passed = cross & cluster_slab(gbox, o, inv, T_MIN, t)
            made += _warp_counts(passed, r1 - r0)[1]
            t_c = box_candidates_rows(rows[r0:r1], rotated, o, d, T_MIN)[0]
            t = torch.where(cross & (t_c < t), t_c, t)
    return need, made


def cluster_checks(checks: Checks, dev, results: dict):
    """K15's spheres and boxes against their twins and the full-table K2 / K6:
    spheres on the bouncing_spheres 1200x800 and final_scene 800x800 pools of
    2f and on ``_many_cluster_rays``' table of more than 64 clusters; boxes
    on that final_scene pool, on the box field's pool (phase 2e's,
    1 iteration in) and on a rotated field's pool (320x240 @ 64, 20 staged
    iterations in, R = 2^17); their times, the full-table kernel's on the same
    pool, bounds from the (ray, primitive) tests those rays need, the tests
    their warps make, and phase 1b's registers, spills and SASS instructions
    a pair of each kernel's form; then
    closest_surface_p under CLUSTER and under BVH equal to its plain record
    and, in t, to the default route's (boxes against K6's t, not the
    lattice's), launching the route's kernels and, under BVH, no sphere
    kernel; the BVH descent's steps and time a call."""
    import dataclasses

    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops.intersect import bvh_sphere_candidates_p

    pools = _cluster_pools(dev)
    for name, (tables, *_) in pools.items():
        log(f"  {name}: {tables.n_spheres} spheres in {tables.n_sphere_clusters} clusters, "
            f"{tables.n_boxes} boxes (rotated {tables.has_rotated_boxes}) in "
            f"{tables.n_box_clusters} clusters, {tables.n_sph_bvh_nodes} BVH nodes")

    def sphere_case(name):
        t, o, d, tm = pools[name]
        return (f"K15 spheres, {name}", "sphere_cluster", "spheres", t.sph_cl_rows,
                t.sph_cl_meta, None, o, d, tm,
                lambda: K.sphere_cluster_hit_attrs(t, o, d, tm),
                lambda: K.sphere_cluster_hit_attrs_plain(t, o, d, tm),
                lambda: K.sphere_hit_attrs(t, o, d, tm))

    def box_case(name):
        t, o, d, tm = pools[name]
        return (f"K15 boxes, {name}", "box_cluster", "boxes", t.box_cl_rows, t.box_cl_meta, t,
                o, d, tm, lambda: K.box_cluster_hit_attrs(t, o, d),
                lambda: K.box_cluster_hit_attrs_plain(t, o, d),
                lambda: K.box_hit_attrs(t, o, d))

    # K15's spheres past the clusters whose boxes the kernel stages
    rows, seg, meta, mo, md, mtm = _many_cluster_rays(dev)
    many = (f"K15 spheres, {len(meta[1])} clusters ({rows.shape[0]} spheres)",
            "sphere_cluster", "spheres", rows, meta, None, mo, md, mtm,
            lambda: K._culled_launch(K.CLUSTER, rows, seg, 0, mo, md, mtm, T_MIN),
            lambda: K.culled_plain(rows, meta, mo, md, mtm, T_MIN, occlusion=True, head=False),
            lambda: K.sphere_hit_attrs(None, mo, md, mtm, rows=rows))
    # the first case of each kernel gives its row's numbers, the others keys
    # with a suffix
    cases = [sphere_case("bouncing_spheres"), sphere_case("final_scene"), many,
             box_case("final_scene"), box_case("box field"), box_case("rotated field")]
    suffix = ["", "_final_scene", "_many_clusters", "", "_box_field", "_rotated"]
    sass = results.get("_sass", {})
    cl = results.setdefault("_cluster", {})
    for n, (label, kname, kind, rows, meta, t, o, d, tm, kern, twin, full) in enumerate(cases):
        k, p, f = kern(), twin(), full()
        torch.cuda.synchronize()
        bad = _equal(k, p)
        same_t, ties = _ties(k, f)
        hits = int((f[0] < BIG).sum())
        R = o[0].shape[0]
        checks.expect(bad == 0 and same_t and (kind == "boxes" or meta[0] == 0),
                      f"{label} (R = {R}): {bad} values differ from the twin; against the "
                      f"full-table {'K2' if kind == 'spheres' else 'K6'} t bit-equal "
                      f"{same_t}, {ties} lanes with another winner at that t (exact "
                      f"ties), {hits} hits")
        if kind == "spheres":
            tests, warp_tests = _culled_tests(rows, meta, o, d, tm, True, head=False)
            nbytes, nops = R * 48 + rows.shape[0] * 40, tests * OPS_SPHERE
            many = len(meta[1]) > K17_STAGED_CELLS
            r = sass.get(f"sphere_cellbin_kernelILb{int(many)}E", {})
            per_pair = sass.get("sphere_cellbin_many_row" if many else "sphere_cellbin_row", {})
        else:
            tests, warp_tests = _box_cluster_tests(t, o, d)
            nbytes = R * 52 + rows.shape[0] * 48
            nops = tests * OPS_BOX[t.has_rotated_boxes] + hits * OPS_BOX_WINNER
            form = "rotated" if t.has_rotated_boxes else "folded"
            r = sass.get(f"box_cluster_kernelILb{int(t.has_rotated_boxes)}E", {})
            per_pair = sass.get(f"box_cluster_pair_{form}", {})
        entry = dict(ms=_timed_ms(kern, 20), plain_ms=_timed_ms(twin, 3),
                     full_ms=_timed_ms(full, 20), ties=ties, hits=hits, R=R,
                     clusters=len(meta[1]), rows=rows.shape[0], tests=tests,
                     warp_tests=warp_tests, full_tests=R * rows.shape[0],
                     registers=r.get("REG"), spill_bytes=r.get("LOCAL"),
                     sass_a_pair=per_pair,
                     max_abs_err=max(_max_diff(x, y) for x, y in zip(
                         [k[0], *k[1], *k[2:]], [p[0], *p[1], *p[2:]])))
        # 7 (spheres) or 6 (boxes) planes in and 5 or 7 out a ray, the rows
        # and the clusters' rows once
        _set_bound(entry, nbytes + (len(meta[1]) + 1) * 32, nops)
        cl[label] = entry
        res = results[kname]
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "tests",
                    "warp_tests", "registers", "spill_bytes", "sass_a_pair"):
            res[key + suffix[n]] = entry[key]
        log(f"  {label}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
            f"full-table kernel {entry['full_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}); (ray, primitive) tests: {tests} needed, {warp_tests} by "
            f"the warps, {entry['full_tests']} in the full table; {len(meta[1])} clusters; "
            f"{entry['registers']} registers, {entry['spill_bytes']} B spilled, SASS "
            f"instructions a pair {per_pair}")

    # closest_surface_p under each switch: the record equal to its plain
    # record, t equal to the default route's with the boxes through K6
    routed = ("sphere_hit", "sphere_skip", "sphere_cellbin", "sphere_cluster", "box_hit",
              "box_grid", "box_grid_cells", "box_cluster")
    for name, (t, o, d, tm) in pools.items():
        k6 = dataclasses.replace(t, box_grid_kx=0)
        for switch in ("cluster", "bvh"):
            if switch == "bvh" and not t.n_sph_bvh_nodes:
                continue
            base = _route_record(k6 if switch == "cluster" else t, o, d, tm)
            _build.launches.clear()
            rec = _route_record(t, o, d, tm, **{switch: True})
            counts = {k: v for k, v in _build.launches.items() if k in routed}
            rec_p = _route_record(t, o, d, tm, plain=True, **{switch: True})
            torch.cuda.synchronize()
            bad = _equal(rec, rec_p)
            same_t, ties = _ties(rec, base)
            if switch == "cluster":
                want = {k for k, n in (("sphere_cluster", t.n_sphere_clusters),
                                       ("box_cluster", t.n_box_clusters)) if n}
            else:
                want = {"box_grid_cells"} if t.n_boxes else set()
            checks.expect(bad == 0 and same_t and set(counts) == want,
                          f"closest_surface_p under {switch.upper()}, {name}: {bad} values "
                          f"differ from its plain record; against the default route "
                          f"{'(boxes through K6) ' if switch == 'cluster' else ''}t "
                          f"bit-equal {same_t}, {ties} ties; kernels launched {counts}")
            cl[f"closest_surface_p {switch} {name}"] = dict(ties=ties, launches=counts)
        if t.n_sph_bvh_nodes:
            stats = {}
            bvh_sphere_candidates_p(t, o, d, tm, T_MIN, stats=stats)
            ms = _timed_ms(lambda: _route_record(t, o, d, tm, bvh=True), 3)
            full_ms = _timed_ms(lambda: _route_record(t, o, d, tm), 3)
            cl[f"bvh {name}"] = dict(steps=stats["steps"], ms=ms, default_ms=full_ms,
                                     nodes=t.n_sph_bvh_nodes)
            log(f"  BVH descent, {name}: {stats['steps']} steps over {t.n_sph_bvh_nodes} "
                f"nodes; closest_surface_p {ms:.3f} ms under BVH (events, host gaps "
                f"included), {full_ms:.4f} ms by the default route")


def _seam_pool(scene, nx, ny, spp, dev, iters):
    """The pool of a seam-route render of ``scene`` (the R that plan_batches
    picks on the card) after ``iters`` iterations: its dead slots still hold
    the radiance of the deaths K12 flushes next."""
    import torch

    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render.integrator import n_uniform_cols, seam_step
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    tables = scene.tables
    tile_pixels, spp_chunk, R = plan_batches(nx * ny, spp, tables.n_spheres, RenderConfig(),
                                             dev)
    s = dict(R=R, ncols=n_uniform_cols(tables), pool=rk.new_pool(R, dev),
             scal=rk.RefillScal(spp_chunk, tile_pixels, 0, nx * ny, nx, ny),
             q=torch.zeros(2, dtype=torch.int64, device=dev),
             hist=torch.zeros(iters + 2, dtype=torch.int64, device=dev),
             fb=torch.zeros((tile_pixels, 3), device=dev),
             lost=torch.zeros(1, dtype=torch.int32, device=dev))
    for it in range(iters):
        seam_step(s["pool"], scene.camera, s["q"], it % 2, s["hist"], it, s["scal"], tables,
                  scene.background, s["fb"], s["lost"], key=(7, 0, 0), ncols=s["ncols"],
                  max_depth=50, gradient=scene.gradient_bg)
    torch.cuda.synchronize()
    return s


def _expanded_bound(rows, o, d, tm, t):
    """(R,) bound on |t_expanded - t_direct| at the full-table winner of
    ``rows`` (tests/test_torch_static_mxu.py expanded_bound): the expanded
    quadratic rounds c to within 8 eps (|o|^2 + |c|^2) and b to within
    4 eps |d| (|o| + |c|), which move the root by (dc / 2 + |t| db) /
    sqrt(disc); plus 2e-5 t and 1e-5."""
    import torch

    from art_tpu_torch.core.vecmath import T_MIN
    from art_tpu_torch.ops.intersect import sphere_candidates_p

    eps = 2.0 ** -23
    idx = torch.cat([sphere_candidates_p(rows, tuple(x[k:k + 16384] for x in o),
                                         tuple(x[k:k + 16384] for x in d), tm[k:k + 16384],
                                         T_MIN)[1] for k in range(0, tm.shape[0], 16384)])
    row = rows.double()[idx.long()]
    O = torch.stack(o, 1).double()
    D = torch.stack(d, 1).double()
    c = row[:, 0:3] + tm.double()[:, None] * row[:, 3:6]
    oc = O - c
    b = (oc * D).sum(1)
    disc = (b * b - (D * D).sum(1) * ((oc * oc).sum(1) - row[:, 8])).clamp_min(1e-30)
    no2, nc2 = (O * O).sum(1), (c * c).sum(1)
    dc = 8 * eps * (no2 + nc2)
    db = 4 * eps * (D * D).sum(1).sqrt() * (no2.sqrt() + nc2.sqrt())
    tt = t.double()
    return (dc / 2 + tt.abs() * db) / disc.sqrt() + 2e-5 * tt.abs() + 1e-5


def _two_tier(t, want_t, tight_rtol, tight_atol):
    """tests/test_pallas_kernels.py _assert_two_tier as masks: (lanes beyond
    2e-2 / 1e-2, the share within the tight tier, the tight mask)."""
    import torch

    loose = torch.isclose(t, want_t, rtol=2e-2, atol=1e-2)
    tight = torch.isclose(t, want_t, rtol=tight_rtol, atol=tight_atol)
    return ~loose, float(tight.float().mean()) if t.numel() else 1.0, tight


def _parting(rows, o, d, tm, got, ref, part, margin: bool) -> dict:
    """The lanes ``part`` where a sphere kernel's (t, normal, mat) ``got``
    parts from the full-table K2's ``ref`` over the scene-order ``rows``,
    by cause, with eps = 2^-23, at each result's winner c:
    ``self_hit``, the ray's origin lies on the winner's surface (within
    SURFACE_REL of |o| + |c| + |r|: the ray leaves that sphere) and the t is
    at most the distance by which the expanded quadratic's rounding moves
    the root at the origin, dc / (2 |(o - c).d|), dc = 8 eps (|o|^2 + |c|^2):
    a root of the rounding past t_min that the other form does not see;
    ``grazing``, the exact discriminant at the winner is within that
    rounding's, |d|^2 dc + 2 |b| db, db = 4 eps |d| (|o| + |c|) (a tangent
    ray, hit by one form only); ``margin``, with ``margin`` (K14's 2 t_min
    acceptance), K2's t lies in (t_min, 2 t_min].  A lane may have several;
    ``unexplained`` has none.  K2's winner is its candidate index; ``got``'s
    is the sphere whose centre its hit point and normal give (p - r n).
    ``reach`` is the largest share of its bound that a self-hit's t or a
    grazing discriminant takes."""
    import torch

    from art_tpu_torch.core.vecmath import BIG, T_MIN
    from art_tpu_torch.ops.intersect import sphere_candidates_p

    eps = 2.0 ** -23
    counts = dict(self_hit=0, grazing=0, margin=0, explained=0, unexplained=0, reach=0.0)
    R = rows.double()
    for L in part.nonzero()[:, 0].split(4096):
        O, D = (torch.stack([c[L] for c in x], 1).double() for x in (o, d))
        C = R[None, :, 0:3] + tm[L].double()[:, None, None] * R[None, :, 3:6]  # (L, S, 3)
        oc = O[:, None] - C
        b = (oc * D[:, None]).sum(2)
        a = (D * D).sum(1)[:, None]
        disc = b * b - a * ((oc * oc).sum(2) - R[None, :, 8])
        dc = 8 * eps * ((O * O).sum(1)[:, None] + (C * C).sum(2))
        db = 4 * eps * a.sqrt() * (O.norm(dim=1)[:, None] + C.norm(dim=2))
        surf = (oc.norm(dim=2) - R[None, :, 6].abs()).abs() <= SURFACE_REL * (
            O.norm(dim=1)[:, None] + C.norm(dim=2) + R[None, :, 6].abs())
        self_reach = torch.where(surf, 2 * b.abs() / dc, float("inf"))  # 1 / the reach
        graze = disc.abs() / (a * dc + 2 * b.abs() * db)
        t_g, t_r = got[0][L].double(), ref[0][L].double()
        n_g = torch.stack([c[L] for c in got[1]], 1).double()
        p_g = O + torch.where(t_g < BIG * 0.5, t_g, 0.0)[:, None] * D
        j_g = (p_g[:, None] - C - R[None, :, 6, None] * n_g[:, None]).norm(dim=2).argmin(1)
        j_r = sphere_candidates_p(rows, tuple(c[L] for c in o), tuple(c[L] for c in d), tm[L],
                                  T_MIN)[1].long()
        share_s = torch.full_like(t_g, float("inf"))  # the smaller of the two sides'
        share_g = torch.full_like(t_g, float("inf"))
        for t, j in ((t_g, j_g), (t_r, j_r)):
            hit = t < BIG * 0.5
            at = j[:, None]
            share_s = torch.where(hit, torch.minimum(share_s, t * self_reach.gather(1, at)[:, 0]),
                                  share_s)
            share_g = torch.where(hit, torch.minimum(share_g, graze.gather(1, at)[:, 0]), share_g)
        on, tangent = share_s <= 1.0, share_g <= 1.0
        near = (t_r < BIG * 0.5) & (t_r <= 2 * T_MIN) & margin
        for share, mask in ((share_s, on), (share_g, tangent)):
            if bool(mask.any()):
                counts["reach"] = max(counts["reach"], float(share[mask].max()))
        counts["self_hit"] += int(on.sum())
        counts["grazing"] += int(tangent.sum())
        counts["margin"] += int(near.sum())
        counts["explained"] += int((on | tangent | near).sum())
        counts["unexplained"] += int((~on & ~tangent & ~near).sum())
    return counts


def _parting_text(c: dict, bar: int) -> str:
    return (f"{c['explained']} lanes part from it, explained (<= {bar}; {c['self_hit']} "
            f"self-hits, {c['grazing']} grazing, {c['margin']} with K2's t within 2 t_min; "
            f"at most {c['reach']:.3g} of the rounding's bound), {c['unexplained']} "
            f"unexplained (0)")


def slice8_checks(checks: Checks, dev, results: dict):
    """K12 on a bouncing_spheres pool 20 seam iterations in (its dead slots
    given radiance from the seed), with injected and Philox uniforms,
    bit-equal to its twin and, but for the zeroed dead radiance, to K1, its
    framebuffer within 1e-6 relative of the twin's, and its flush-only
    entry likewise; K13 in both forms (phase 1b's builds, ``_static_builds``)
    on the bouncing_spheres and final_scene pools of 2f and a cornell_box
    pool, bit-equal to its twin, in the direct
    form equal to the full-table K2 in t on every lane (exact ties between
    the (moving, main, tail) order and scene order counted), in the
    expanded form within the expanded quadratic's rounding bound; K14 on
    the bouncing_spheres pool, bit-equal to its twin and against K2 at
    tests/test_pallas_kernels.py:643-693's bars; the split's MXU-tail dense
    branch on the final_scene pool, bit-equal to its plain run and against
    K2 at tests/test_compact_sphere.py:204-250's bars.  Where the expanded
    forms part from K2 (a hit flip, t beyond the bar, for K14 a normal), every
    lane must be explained (``_parting``) and their count is held to
    PARTING_BARS.  Then closest_surface_p under each new switch equal to its
    plain record and launching its kernels; times and bounds."""
    import torch

    from art_tpu_torch.core.vecmath import BIG
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.ops import compact_sphere as cs
    from art_tpu_torch.ops import intersect_kernels as K
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.sp_kernel import flush_census

    s8 = results.setdefault("_slice8", {})
    # ---- K13's builds: every scene and form at once (phase 1b's) ----
    libs, nvcc, wall = _static_builds()
    s8["static_nvcc_seconds"] = dict(nvcc, wall=wall)

    # ---- K12: seam flush + refill ----
    scene = build_scene("bouncing_spheres", 1200, 800).to(dev)
    sp = _seam_pool(scene, 1200, 800, 64, dev, 20)
    base, R, cam, scal, ncols = sp["pool"], sp["R"], scene.camera, sp["scal"], sp["ncols"]
    dead = ~base["act"]
    log(f"  K12 pool: bouncing_spheres 1200x800 @ 64 after 20 seam iterations, R = {R}, "
        f"{int(dead.sum())} dead, {int((dead & (base['r0'] != 0)).sum())} with radiance; "
        f"every other dead slot given radiance from the seed")
    rng = np.random.default_rng(SEED + 8)
    for n in ("r0", "r1", "r2"):  # the scene's few lights leave most deaths dark
        extra = torch.from_numpy(rng.random(R, dtype=np.float32)).to(dev)
        base[n].copy_(torch.where(dead & (base[n] == 0), extra, base[n]))
    block = torch.from_numpy(rng.random((ncols, R), dtype=np.float32)).to(dev)
    next_q = int(sp["q"][20 % 2])
    fb0 = sp["fb"].clone()
    P = fb0.shape[0]

    def run(fn, pool, fb=None, **src):
        q = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
        hist = torch.zeros(24, dtype=torch.int64, device=dev)
        lost = torch.zeros(1, dtype=torch.int32, device=dev)
        if fb is None:
            out = fn(pool, cam, q, 0, hist, 20, scal, ncols=ncols, **src)
        else:
            out = fn(pool, cam, q, 0, hist, 20, scal, fb, lost, ncols=ncols, **src)
        torch.cuda.synchronize()
        return q, hist, lost, out

    def fb_rel(a, b):
        return float(((a - b).abs() / (b.abs() + 1e-6)).max())

    k12_err = 0.0
    for mode, src in (("injected", dict(block=block)), ("philox", dict(key=(1984, 3, 1)))):
        kp, pp, k1p = _clone(base), _clone(base), _clone(base)
        kfb, pfb = fb0.clone(), fb0.clone()
        kq, kh, kl, ku = run(rk.fused_refill_flush, kp, kfb, **src)
        pq, ph, pl_, pu = run(rk.fused_refill_flush_plain, pp, pfb, **src)
        q1, h1, _, u1 = run(rk.fused_refill, k1p, **src)
        bad = sum(_bits_equal(kp[n], pp[n]) for n in rk.POOL_F) + sum(
            int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
        u_bad = sum(_bits_equal(a, b) for a, b in zip(ku[0] + (ku[1],) + ku[2],
                                                      pu[0] + (pu[1],) + pu[2]))
        checks.expect(bad == 0 and u_bad == 0 and torch.equal(kq, pq) and torch.equal(kh, ph)
                      and int(kl) == int(pl_) == 0,
                      f"K12 {mode}: {bad} pool values and {u_bad} uniforms differ from the "
                      f"twin; queue head {int(kq[1])}, live {int(kh[20])} equal; lost "
                      f"{int(kl)}")
        # against K1: every plane bit-equal but the dead slots' radiance, zeroed
        k1_bad = sum(_bits_equal(kp[n], torch.where(dead, 0.0, k1p[n])
                                 if n in ("r0", "r1", "r2") else k1p[n]) for n in rk.POOL_F)
        k1_bad += sum(int((kp[n] != k1p[n]).sum()) for n in ("bounce", "pix", "act"))
        checks.expect(k1_bad == 0 and torch.equal(kq, q1) and torch.equal(kh, h1),
                      f"K12 {mode} against K1: {k1_bad} pool values differ (the dead "
                      f"slots' radiance zeroed), queue head and live count equal")
        rel = fb_rel(kfb, pfb)
        checks.expect(rel <= 1e-6 and bool((kfb != fb0).any()),
                      f"K12 {mode}: framebuffer max rel err {rel:.3g} against the twin "
                      f"(<= 1e-6), {int((kfb != fb0).any(dim=1).sum())} pixels added to")
        k12_err = max(k12_err, float((kfb - pfb).abs().max()))
    # the flush-only entry on the same pool
    kp, pp, kfb, pfb = _clone(base), _clone(base), fb0.clone(), fb0.clone()
    kl, pl_ = (torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2))
    rk.flush_dead(kp, kfb, kl)
    rk.flush_dead_plain(pp, pfb, pl_)
    torch.cuda.synchronize()
    bad = sum(_bits_equal(kp[n], pp[n]) for n in rk.POOL_F) + sum(
        int((kp[n] != pp[n]).sum()) for n in ("bounce", "pix", "act"))
    rel = fb_rel(kfb, pfb)
    checks.expect(bad == 0 and int(kl) == int(pl_) == 0 and rel <= 1e-6
                  and bool((kp["r0"][dead] == 0).all()),
                  f"K12's flush-only entry: {bad} pool values differ from the twin (the "
                  f"dead slots' radiance zeroed), lost {int(kl)}, framebuffer max rel err "
                  f"{rel:.3g} (<= 1e-6)")
    work, fb_t = _clone(base), fb0.clone()
    q_t = torch.tensor([next_q, 0], dtype=torch.int64, device=dev)
    hist_t = torch.zeros(24, dtype=torch.int64, device=dev)
    lost_t = torch.zeros(1, dtype=torch.int32, device=dev)

    def reset():
        _restore(work, base)
        fb_t.copy_(fb0)
        q_t[0] = next_q

    r12 = results["refill_flush"]
    for key, fn in (("ms", rk.fused_refill_flush), ("plain_ms", rk.fused_refill_flush_plain)):
        r12[key] = _timed_ms(lambda fn=fn: fn(work, cam, q_t, 0, hist_t, 20, scal, fb_t,
                                              lost_t, ncols=ncols, key=(1984, 3, 1)),
                             20 if key == "ms" else 5, reset=reset)
    r12["k1_ms"] = _timed_ms(lambda: rk.fused_refill(work, cam, q_t, 0, hist_t, 20, scal,
                                                     ncols=ncols, key=(1984, 3, 1)),
                             20, reset=reset)
    r12["max_abs_err"] = k12_err
    # K1's work (_refill_work) plus a dead slot's pix and radiance in (16 B)
    # and radiance out (12 B), and the framebuffer's adds (12 B in, 12 out)
    taken = min(int(dead.sum()), max(0, scal.P * scal.spp - next_q))
    with_rad = int((dead & ((base["r0"] != 0) | (base["r1"] != 0) | (base["r2"] != 0))).sum())
    nbytes, nops = _refill_work(R, ncols, taken)
    _set_bound(r12, nbytes + int(dead.sum()) * 28 + with_rad * 24, nops + with_rad * 3)
    r12.update(R=R, dead=int(dead.sum()), taken=taken, flushed=with_rad, P=P)
    rfd = results["flush_dead"]
    for key, fn in (("ms", rk.flush_dead), ("plain_ms", rk.flush_dead_plain)):
        rfd[key] = _timed_ms(lambda fn=fn: fn(work, fb_t, lost_t), 20 if key == "ms" else 5,
                             reset=reset)
    rfd["max_abs_err"] = float((kfb - pfb).abs().max())
    # the library call: the scatter alone, one index_put_ over every slot,
    # each live one to a spare row of its own past the framebuffer (sent to
    # one spare row, the live slots made one index of ~10^5 duplicates, which
    # index_put_ walks one by one: that timed the spare row, not the scatter;
    # kept beside as library_one_spare_ms)
    lib_rad = torch.stack([base["r0"], base["r1"], base["r2"]], 1)
    for key, rows, live_idx in (("library_ms", P + R, P + torch.arange(R, device=dev)),
                                ("library_one_spare_ms", P + 1, P)):
        spare = torch.zeros((rows, 3), device=dev)
        lib_idx = torch.where(dead, base["pix"].long(), live_idx)
        rfd[key] = _timed_ms(
            lambda: spare.index_put_((lib_idx,), lib_rad, accumulate=True), 20,
            reset=lambda: spare.zero_())
    # how much flush_warp saves: the deaths that add, the pixel adds of the
    # warps, the deaths whose pixel another death of their warp shares (the
    # same lanes for K12 and its flush-only entry on this pool)
    lit = dead & ((base["r0"] != 0) | (base["r1"] != 0) | (base["r2"] != 0))
    census = dict(zip(("deaths", "pixel_adds", "shared"), flush_census(base["pix"], lit, P)))
    r12["flush_census"] = rfd["flush_census"] = census
    # act of every slot in; a dead slot's pix and radiance in and radiance
    # out; the framebuffer's adds
    _set_bound(rfd, R + int(dead.sum()) * 28 + with_rad * 24, with_rad * 3)
    rfd.update(R=R, dead=int(dead.sum()), flushed=with_rad, P=P)
    log(f"  K12: kernel {r12['ms']:.4f} ms (K1 alone {r12['k1_ms']:.4f} ms), plain "
        f"{r12['plain_ms']:.4f} ms, bound {r12['bound_ms']:.4f} ms ({r12['bound_by']}); "
        f"flush-only entry {rfd['ms']:.4f} ms, plain {rfd['plain_ms']:.4f} ms, index_put_ "
        f"{rfd['library_ms']:.4f} ms (every live slot to one spare row: "
        f"{rfd['library_one_spare_ms']:.4f} ms), bound {rfd['bound_ms']:.4f} ms "
        f"({rfd['bound_by']}); flush_warp: {census['deaths']} deaths add, "
        f"{census['pixel_adds']} pixel adds, {census['shared']} share a pixel in their warp")

    # ---- K13: the baked spheres, both forms ----
    pools = dict(_route_pools(dev))
    pools["cornell_box"] = _pool_rays(build_scene("cornell_box", 600, 600).to(dev), 600, 600,
                                      64, dev, 20)
    r13 = results["sphere_static"]
    for name in STATIC_SCENES:
        tables, o, d, tm = pools[name]
        Rn = o[0].shape[0]
        n_moving = len(tables.sph_static_cells[0])
        full = K.sphere_hit_attrs(tables, o, d, tm)
        full_ms = _timed_ms(lambda: K.sphere_hit_attrs(tables, o, d, tm), 20)
        for expand in (False, True):
            form = "expanded" if expand else "direct"
            k = K.sphere_static_hit_attrs(tables, o, d, tm, expand=expand)
            p = K.sphere_static_hit_attrs_plain(tables, o, d, tm, expand=expand)
            torch.cuda.synchronize()
            bad = _equal(k, p)
            hits = int((full[0] < BIG).sum())
            label = f"K13 {form}, {name}"
            if not expand:
                same_t, ties = _ties(k, full)
                checks.expect(bad == 0 and same_t,
                              f"{label} (R = {Rn}): {bad} values differ from the twin; "
                              f"against the full-table K2 t bit-equal {same_t}, {ties} lanes "
                              f"with another winner at that t (exact ties), {hits} hits")
                entry = dict(ties=ties)
            else:
                # the expanded form's own rounding: t within its bound, and
                # there the same material and the normal within the bound
                # over the smallest radius
                kh, fh = k[0] < BIG * 0.5, full[0] < BIG * 0.5
                both = kh & fh
                bound = _expanded_bound(tables.sph_rows, o, d, tm, full[0])
                within = both & ((k[0].double() - full[0].double()).abs() <= bound)
                mats = int((k[2] != full[2])[within].sum())
                r_min = float(tables.sph_rows[:, 6].abs().min())
                d_len = torch.stack(d, 1).double().norm(dim=1)
                n_beyond = int(sum((((k[1][c] - full[1][c]).abs().double()
                                     > d_len * bound / r_min + 2e-3) & within).sum()
                                   for c in range(3)))
                tight = float(torch.isclose(k[0][both], full[0][both], rtol=2e-5,
                                            atol=1e-5).float().mean())
                flips = int((kh != fh).sum())
                parting = _parting(tables.sph_rows, o, d, tm, k, full,
                                   (kh != fh) | (both & ~within), margin=False)
                bar = PARTING_BARS[label]
                checks.expect(bad == 0 and mats == 0 and n_beyond == 0
                              and parting["unexplained"] == 0 and parting["explained"] <= bar,
                              f"{label} (R = {Rn}): {bad} values differ from the twin; "
                              f"against the full-table K2 {flips} hit flips and "
                              f"{int((both & ~within).sum())} t beyond the expanded rounding "
                              f"bound: {_parting_text(parting, bar)}; {mats} materials and "
                              f"{n_beyond} normal components apart within it, {tight:.4f} of "
                              f"the hits within 2e-5 / 1e-5, {hits} hits")
                entry = dict(flips=flips, tight_share=tight,
                             beyond_bound=int((both & ~within).sum()), parting=parting)
            entry.update(
                ms=_timed_ms(lambda: K.sphere_static_hit_attrs(tables, o, d, tm,
                                                               expand=expand), 20),
                plain_ms=_timed_ms(lambda: K.sphere_static_hit_attrs_plain(
                    tables, o, d, tm, expand=expand), 3),
                full_k2_ms=full_ms, R=Rn, spheres=tables.n_spheres, moving=n_moving,
                hits=hits, nvcc_seconds=nvcc[f"{name} {form}"],
                max_abs_err=max(_max_diff(x, y) for x, y in zip([k[0], *k[1], k[2]],
                                                                [p[0], *p[1], p[2]])))
            # 7 planes in and 5 out a ray; no table; every (ray, sphere)
            # test, a moving row's at K2's count, a static row's at its form's
            _set_bound(entry, Rn * 48, Rn * (n_moving * OPS_SPHERE + (
                tables.n_spheres - n_moving) * OPS_STATIC[expand]))
            s8[label] = entry
            log(f"  {label}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
                f"full-table K2 {full_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
                f"({entry['bound_by']}), nvcc {entry['nvcc_seconds']:.1f} s")
            # the row: bouncing_spheres in the builder's form (its render's)
            key = "" if (name == "bouncing_spheres" and expand == tables.sph_expand) \
                else f"_{name}_{form}"
            for field in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err"):
                r13[field + key] = entry[field]
    r13["nvcc_seconds"] = nvcc

    # ---- K14: the bilinear-feature spheres ----
    bt, bo, bd, btm = pools["bouncing_spheres"]
    F, A = bt.sph_mxu_feat, bt.sph_mxu_attr
    k = K.sphere_mxu_hit_attrs(F, A, bo, bd, btm)
    p = K.sphere_mxu_hit_attrs_plain(F, A, bo, bd, btm)
    full = K.sphere_hit_attrs(bt, bo, bd, btm)
    torch.cuda.synchronize()
    bad = _equal(k, p)
    kh, fh = k[0] < BIG * 0.5, full[0] < BIG * 0.5
    agree = float((kh == fh).float().mean())
    both = kh & fh
    out_b, tight_share, tight_b = _two_tier(k[0][both], full[0][both], 2e-5, 1e-3)
    loose_out, tight = torch.zeros_like(both), torch.zeros_like(both)
    loose_out[both], tight[both] = out_b, tight_b
    mats = int((k[2] != full[2])[tight].sum())
    n_apart = torch.zeros_like(both)
    for c in range(3):
        n_apart |= tight & ~torch.isclose(k[1][c], full[1][c], rtol=1e-3, atol=4e-3)
    parting = _parting(bt.sph_rows, bo, bd, btm, k, full, (kh != fh) | loose_out | n_apart,
                       margin=True)
    bar = PARTING_BARS["K14, bouncing_spheres"]
    checks.expect(bad == 0 and agree > 0.999 and tight_share >= 0.98 and mats == 0
                  and parting["unexplained"] == 0 and parting["explained"] <= bar,
                  f"K14, bouncing_spheres (R = {bo[0].shape[0]}): {bad} values differ from "
                  f"the twin; against the full-table K2 hits agree on {agree:.5f} (> 0.999), "
                  f"{tight_share:.4f} within 2e-5 / 1e-3 (>= 0.98), {mats} materials apart "
                  f"there; {int((kh != fh).sum())} hit flips, {int(loose_out.sum())} lanes "
                  f"beyond 2e-2 / 1e-2 and {int(n_apart.sum())} normals beyond 1e-3 / 4e-3 "
                  f"within 2e-5 / 1e-3: {_parting_text(parting, bar)}")
    Rb, s_pad = bo[0].shape[0], bt.mxu_sphere_pad
    r14 = results["sphere_mxu"]
    r14.update(ms=_timed_ms(lambda: K.sphere_mxu_hit_attrs(F, A, bo, bd, btm), 20),
               plain_ms=_timed_ms(lambda: K.sphere_mxu_hit_attrs_plain(F, A, bo, bd, btm),
                                  3),
               max_abs_err=max(_max_diff(x, y) for x, y in zip([k[0], *k[1], k[2]],
                                                               [p[0], *p[1], p[2]])),
               full_k2_ms=_timed_ms(lambda: K.sphere_hit_attrs(bt, bo, bd, btm), 20),
               hit_agree=agree, tight_share=tight_share, loose_lanes=int(loose_out.sum()),
               parting=parting, R=Rb, s_pad=s_pad)
    # the feature product alone as one float32 matmul (no TF32), for scale
    rf = torch.stack([*bd, *(btm * c for c in bd), *bo, *(btm * c for c in bo),
                      torch.ones_like(btm), btm, btm * btm, torch.zeros_like(btm)])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    r14["feature_matmul_ms"] = _timed_ms(lambda: torch.matmul(F, rf), 20)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    # the function's least work, K2's bound on this pool: 7 planes in and 5
    # out a ray, the sphere table once, every (ray, sphere) test at K2's count
    _set_bound(r14, Rb * 48 + bt.n_spheres * 40, Rb * bt.n_spheres * OPS_SPHERE)
    log(f"  K14: kernel {r14['ms']:.4f} ms, plain {r14['plain_ms']:.4f} ms, full-table K2 "
        f"{r14['full_k2_ms']:.4f} ms, the feature matmul alone {r14['feature_matmul_ms']:.4f}"
        f" ms, bound {r14['bound_ms']:.4f} ms ({r14['bound_by']})")

    # ---- the split's MXU-tail dense branch on final_scene's pool ----
    ft, fo, fd, ftm = pools["final_scene"]
    k = cs.sphere_hit_attrs_mxu_tail(ft, fo, fd, ftm)
    p = cs.sphere_hit_attrs_mxu_tail(ft, fo, fd, ftm, plain=True)
    full = K.sphere_hit_attrs(ft, fo, fd, ftm)
    torch.cuda.synchronize()
    bad = _equal(k, p)
    ka, fa = k[0] < 1e9, full[0] < 1e9
    m = ka & fa
    rel = ((k[0] - full[0]).abs() / full[0].clamp_min(1e-6))[m]
    p99 = float(torch.quantile(rel.double(), 0.99)) if rel.numel() else 0.0
    n_far = float(((torch.stack(k[1], 1) - torch.stack(full[1], 1)).abs().max(1).values
                   > 1e-2)[m].float().mean())
    mats = m & (k[2] != full[2])
    parting = _parting(ft.sph_rows, fo, fd, ftm, k, full, (ka != fa) | mats, margin=True)
    bar = PARTING_BARS["MXU-tail dense branch, final_scene"]
    checks.expect(bad == 0 and p99 < 1e-3 and n_far < 0.005
                  and parting["unexplained"] == 0 and parting["explained"] <= bar,
                  f"MXU-tail dense branch, final_scene (R = {fo[0].shape[0]}): {bad} values "
                  f"differ from its plain run; against the full-table K2 t 99th-percentile "
                  f"rel err {p99:.3g} (< 1e-3), normals beyond 1e-2 on {n_far:.5f} (< 0.005); "
                  f"{int((ka != fa).sum())} hit flips and {int(mats.sum())} materials apart: "
                  f"{_parting_text(parting, bar)}")
    og = tuple(c - g for c, g in zip(fo, ft.sph_tail_centroid))
    Ft, At = ft.sph_mxu_tail_feat, ft.sph_mxu_tail_attr
    tail = dict(ms=_timed_ms(lambda: cs.sphere_hit_attrs_mxu_tail(ft, fo, fd, ftm), 20),
                plain_ms=_timed_ms(lambda: cs.sphere_hit_attrs_mxu_tail(ft, fo, fd, ftm,
                                                                        plain=True), 3),
                k14_ms=_timed_ms(lambda: K.sphere_mxu_hit_attrs(Ft, At, og, fd, ftm), 20),
                full_k2_ms=_timed_ms(lambda: K.sphere_hit_attrs(ft, fo, fd, ftm), 20),
                p99=p99, normals_beyond=n_far, mats_apart=int(mats.sum()),
                flips=int((ka != fa).sum()), parting=parting)
    # its K14 over the tail, bounded as K2 over the tail's rows
    _set_bound(tail, fo[0].shape[0] * 48 + ft.sph_n_tail * 40,
               fo[0].shape[0] * ft.sph_n_tail * OPS_SPHERE)
    s8["mxu tail dense branch, final_scene"] = tail
    for field in ("ms", "bound_ms", "bound_by"):
        r14[field + "_tail"] = tail["k14_ms" if field == "ms" else field]
    log(f"  MXU-tail dense branch: {tail['ms']:.4f} ms (its K14 over the "
        f"{ft.mxu_tail_pad}-row tail {tail['k14_ms']:.4f} ms, bound {tail['bound_ms']:.4f} "
        f"ms), plain {tail['plain_ms']:.4f} ms, full-table K2 {tail['full_k2_ms']:.4f} ms")

    # ---- closest_surface_p under each new switch ----
    sph = ("sphere_hit", "sphere_static", "sphere_mxu", "sphere_cellbin", "sphere_skip",
           "sphere_cluster")
    for name, switches, want in (
            ("bouncing_spheres", dict(sph_static=True), {"sphere_static"}),
            ("final_scene", dict(sph_static=True), {"sphere_static"}),
            ("cornell_box", dict(sph_static=True), {"sphere_static"}),
            ("bouncing_spheres", dict(mxu_spheres=True), {"sphere_mxu"}),
            ("final_scene", dict(compact_sph=True, force_branch="dense", mxu_tail=True),
             {"sphere_hit", "sphere_mxu"})):
        tables, o, d, tm = pools[name]
        _build.launches.clear()
        rec = _route_record(tables, o, d, tm, **switches)
        counts = {k_: v for k_, v in _build.launches.items() if k_ in sph}
        rec_p = _route_record(tables, o, d, tm, plain=True, **switches)
        torch.cuda.synchronize()
        bad = _equal(rec, rec_p)
        checks.expect(bad == 0 and set(counts) == want,
                      f"closest_surface_p under {switches}, {name}: {bad} values differ "
                      f"from its plain record; sphere kernels launched {counts}")


# the refill core's scan (phase 2i): K1, K12 and K11 on pools of these dead
# shares at R = 2^17, and on a pool too large for every block to be
# resident at once (2^22 slots and a ragged last block: 16,385 blocks)
SCAN_DEAD = (0.0, 0.3, 1.0)
SCAN_BIG_R = (1 << 22) + 100


def _scan_case(checks, dev, label, kind, base, ctx, src):
    """``kind`` (refill: K1, refill_flush: K12, sp_step: K11) and its twin
    from ``base``, each on its own pool: two consecutive calls of one
    dispatch (it 6, then 7 from the head the first wrote on the device),
    then a new dispatch at it = 0 with another key (Philox) and queue head,
    all on the kernel pool's one look-back scratch; for K1 and K12 the same
    30% of the slots die before each later call (K11 kills its own).  After
    each call the pools, queue head, live count and the kind's outputs must
    agree (the framebuffer within 1e-6 relative), the scratch's ticket
    counter be back at 0 and every block's word its inclusive prefix."""
    import torch

    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.ops.sp_kernel import sp_step, sp_step_plain

    fns = {"refill": (rk.fused_refill, rk.fused_refill_plain),
           "refill_flush": (rk.fused_refill_flush, rk.fused_refill_flush_plain),
           "sp_step": (sp_step, sp_step_plain)}[kind]
    R, P = base["act"].shape[0], ctx["P"]
    rng = np.random.default_rng(SEED + 20)
    sides = [dict(fn=fn, pool=_clone(base), q=torch.zeros(2, dtype=torch.int64, device=dev),
                  hist=torch.zeros(8, dtype=torch.int64, device=dev),
                  fb=torch.zeros((P, 3), device=dev),
                  lost=torch.zeros(1, dtype=torch.int32, device=dev)) for fn in fns]
    ok = True
    for step, (it, q0) in enumerate(((6, ctx["q0"]), (7, None), (0, ctx["q0_new"]))):
        if step and kind != "sp_step":
            dies = torch.from_numpy(rng.random(R) < 0.3).to(dev)
            for sd in sides:
                sd["pool"]["act"] &= ~dies
        call_src = dict(src)
        if "key" in call_src and step == 2:
            call_src["key"] = (1984, 4, 2)  # another (tile, chunk)
        dead = ~sides[0]["pool"]["act"]
        outs = []
        for sd in sides:
            if q0 is not None:
                sd["q"].copy_(torch.tensor([q0, 0], dtype=torch.int64))
                sd["hist"].zero_()
            args = (sd["pool"], ctx["cam"], sd["q"], it % 2, sd["hist"], it, ctx["scal"])
            if kind == "refill":
                outs.append(sd["fn"](*args, ncols=ctx["ncols"], **call_src))
            elif kind == "refill_flush":
                outs.append(sd["fn"](*args, sd["fb"], sd["lost"], ncols=ctx["ncols"],
                                     **call_src))
            else:
                scene = ctx["scene"]
                outs.append(sd["fn"](*args, scene.tables, scene.background, sd["fb"],
                                     sd["lost"], ncols=ctx["ncols"], max_depth=50,
                                     gradient=scene.gradient_bg, **call_src))
        torch.cuda.synchronize()
        (k, p), (ko, po) = sides, outs
        bad = sum(_bits_equal(k["pool"][n], p["pool"][n]) for n in rk.POOL_F)
        bad += sum(int((k["pool"][n] != p["pool"][n]).sum()) for n in ("bounce", "pix", "act"))
        if kind == "sp_step":
            bad += int((ko != po).sum())
        else:
            bad += sum(_bits_equal(a, b) for a, b in zip(ko[0] + (ko[1],) + ko[2],
                                                         po[0] + (po[1],) + po[2]))
        fb_rel = float(((k["fb"] - p["fb"]).abs() / (p["fb"].abs() + 1e-6)).max())
        scratch = k["pool"]["act"].scan_scratch
        words, nb = scratch[:-1], scratch.shape[0] - 1
        counts = torch.zeros(nb * 256, dtype=torch.int64, device=dev)
        counts[:R] = dead.to(torch.int64)
        prefix = torch.cumsum(counts.view(nb, 256).sum(dim=1), 0)
        scan_ok = (int(scratch[-1]) == 0 and bool(((words >> 30) & 3 == 2).all())
                   and torch.equal(words & ((1 << 30) - 1), prefix)
                   and (words >> 32).unique().numel() == 1)
        same = (bad == 0 and torch.equal(k["q"], p["q"]) and torch.equal(k["hist"], p["hist"])
                and torch.equal(k["lost"], p["lost"]) and fb_rel <= 1e-6 and scan_ok)
        ok &= same
        checks.expect(same, f"{label} {kind} call {step + 1} (it {it}): {bad} values differ "
                            f"from the twin; queue head {int(k['q'][1 - it % 2])} (twin "
                            f"{int(p['q'][1 - it % 2])}), live {int(k['hist'][it])} "
                            f"({int(p['hist'][it])}), framebuffer max rel err {fb_rel:.3g} "
                            f"(<= 1e-6); scratch: ticket {int(scratch[-1])}, every word a "
                            f"prefix {scan_ok}")
    return ok


def refill_scan_checks(checks: Checks, dev, results: dict):
    """Phase 2i: K1 and K12 (bouncing_spheres 1200x800's camera and queue)
    and K11 (quads 1200x600) against their twins by ``_scan_case`` on pools
    of 0%, 30% and 100% dead slots at R = 2^17 (the 30% pool also with
    injected uniforms) and a 30%-dead pool of SCAN_BIG_R slots; then K1
    timed on each dead share, every dead slot taking a queue element."""
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches

    rng = np.random.default_rng(SEED + 21)
    scene = build_scene("bouncing_spheres", 1200, 800)
    tile_pixels, spp, R = plan_batches(1200 * 800, 64, scene.tables.n_spheres, RenderConfig(),
                                       dev)
    s = _short_setup(dev)

    def ctx(kind, n):
        if kind == "sp_step":
            scene_, (scal, P) = s["scenes"]["quads"], (
                (s["scal"], s["tile_pixels"]) if n == s["R"] else
                (rk.RefillScal(64, 1200 * 600, 0, 1200 * 600, 1200, 600), 1200 * 600))
        else:
            scene_, (scal, P) = scene, (
                (rk.RefillScal(spp, tile_pixels, 3 * tile_pixels, 1200 * 800, 1200, 800),
                 tile_pixels) if n == R else
                (rk.RefillScal(64, 1200 * 800, 0, 1200 * 800, 1200, 800), 1200 * 800))
        n_q = scal.P * scal.spp  # the queue runs out in the first call
        return dict(cam=scene_.camera, scene=scene_, scal=scal, P=P, ncols=10,
                    q0=max(0, n_q - n // 2), q0_new=max(0, n_q - n // 3))

    ok = True
    for label, n, dead in ([(f"{round(100 * x)}% dead", R, x) for x in SCAN_DEAD]
                           + [(f"{SCAN_BIG_R} slots, 30% dead", SCAN_BIG_R, 0.3)]):
        log(f"  {label}: R = {n}, {-(-n // 256)} blocks")
        for kind in ("refill", "refill_flush", "sp_step"):
            c = ctx(kind, n)
            base = _random_pool(rng, n, dev)
            base["act"] = torch.from_numpy(rng.random(n) >= dead).to(dev)
            for name in ("r0", "r1", "r2"):
                base[name].abs_()
            base["pix"].remainder_(c["P"])
            modes = [("philox", dict(key=(1984, 3, 1)))]
            if dead == 0.3 and n == R:
                modes.append(("injected", dict(block=torch.from_numpy(
                    rng.random((10, n), dtype=np.float32)).to(dev))))
            for mode, src in modes:
                ok &= _scan_case(checks, dev, f"{label} {mode}", kind, base, c, src)
    results["_scan"] = dict(ok=ok, R=R, big_R=SCAN_BIG_R, dead_shares=list(SCAN_DEAD))

    # ---- K1 timed on each dead share (queue head 0: every dead slot taken) ----
    r1, c = results["refill"], ctx("refill", R)
    for dead in SCAN_DEAD:
        base = _random_pool(rng, R, dev)
        base["act"] = torch.from_numpy(rng.random(R) >= dead).to(dev)
        work = _clone(base)
        q_t = torch.zeros(2, dtype=torch.int64, device=dev)
        hist_t = torch.zeros(8, dtype=torch.int64, device=dev)

        def reset():
            _restore(work, base)
            q_t.zero_()

        tag = f"dead_{round(100 * dead)}"
        r1[f"ms_{tag}"] = _timed_ms(lambda: rk.fused_refill(
            work, c["cam"], q_t, 0, hist_t, 3, c["scal"], ncols=10, key=(1984, 3, 1)), 20,
            reset=reset)
        entry = {}
        _set_bound(entry, *_refill_work(R, 10, int((~base["act"]).sum())))
        r1[f"bound_ms_{tag}"] = entry["bound_ms"]
        log(f"  K1 on {round(100 * dead)}% dead: {r1[f'ms_{tag}']:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")


def philox_checks(checks: Checks, dev):
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import refill_kernel as rk

    R = 1 << 17
    cam = build_scene("bouncing_spheres", 1200, 800).camera
    scal = rk.RefillScal(64, 64000, 0, 960000, 1200, 800)
    planes = []
    for it in (0, 1):
        pool = rk.new_pool(R, dev)
        q = torch.zeros(2, dtype=torch.int64, device=dev)
        ball, choice, media = rk.fused_refill(
            pool, cam, q, 0, torch.zeros(2, dtype=torch.int64, device=dev), it, scal,
            key=(1984, 0, 0), ncols=10)
        planes.append(torch.stack(ball + (choice,) + media))
    u = planes[0]
    mean, var = u.mean(dim=1), u.var(dim=1)
    checks.expect(float(u.min()) >= 0.0 and float(u.max()) < 1.0,
                  f"Philox: {u.shape[0]} planes of {R} values in [0, 1)")
    checks.expect(bool(((mean - 0.5).abs() <= 0.005).all()),
                  f"Philox: means {[round(float(m), 5) for m in mean]} (0.5 +- 0.005)")
    checks.expect(bool(((var - 1 / 12).abs() <= 0.003).all()),
                  f"Philox: variances {[round(float(v), 5) for v in var]} "
                  "(1/12 +- 0.003)")
    same_it = float((planes[0] == planes[1]).float().mean())
    same_slot = float((u[:, 1:] == u[:, :-1]).float().mean())
    checks.expect(same_it < 1e-3 and same_slot < 1e-3,
                  f"Philox: equal fraction across iterations {same_it:.2e}, "
                  f"across neighbouring slots {same_slot:.2e}")


def _down(img, grid=(8, 16)):
    """tests/test_parity.py:_down without PIL: clip, quantize to uint8, then a
    box average onto the 16x8 grid (the renders here are multiples of it)."""
    q = (np.clip(img, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
    h, w = img.shape[0] // grid[0], img.shape[1] // grid[1]
    return q.reshape(grid[0], h, grid[1], w, 3).mean(axis=(1, 3))


def _light_rows(scene, ny: int):
    """The framebuffer rows (bottom-up) onto which cornell_box's ceiling
    light (x 213..343, y 554, z 227..332) projects through the camera."""
    cam = scene.camera
    origin, w = np.asarray(cam.origin, np.float64), np.asarray(cam.w, np.float64)
    llc = np.asarray(cam.lower_left_corner, np.float64) - origin
    vert = np.asarray(cam.vertical, np.float64)
    focus = -(llc @ w)
    ts = []
    for x in (213.0, 343.0):
        for z in (227.0, 332.0):
            rel = np.array([x, 554.0, z]) - origin
            on_plane = rel * focus / -(rel @ w)  # the point's ray at the viewport
            ts.append((on_plane - llc) @ vert / (vert @ vert))
    return int(np.floor(min(ts) * ny)), int(np.ceil(max(ts) * ny))


def _render(checks, dev, name, nx, ny, spp, results, counts_by_render, scene=None,
            label=None, short_path=None):
    """One render with the launch counts set to 0 just before it and read
    just after; checks that it launched every kernel of its path (PATHS
    under ``label``, by default the scene's name) and no other."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.render.renderer import RenderConfig, render_scene

    label = label or name
    scene = scene or build_scene(name, nx, ny)
    _build.launches.clear()
    fb, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp), device=dev,
                          short_path=short_path)
    counts = dict(_build.launches)
    counts_by_render[label] = counts
    unused = [k for k in KERNELS if k not in PATHS[label] and counts.get(k, 0)]
    checks.expect(all(counts.get(k, 0) > 0 for k in PATHS[label]) and not unused,
                  f"{label} {nx}x{ny} @ {spp} launched {PATHS[label]} and no other "
                  f"kernel: {counts}")
    checks.expect(bool(np.isfinite(fb).all() and (fb >= 0).all()),
                  f"{label} {nx}x{ny} @ {spp}: finite, >= 0")
    log(f"  {label} {nx}x{ny} @ {spp}: {st['seconds']:.3f} s, {st['rays']:.0f} rays, "
        f"{st['mrays_per_sec']:.2f} Mrays/s, {st['iterations']} iterations, occupancy "
        f"{st['occupancy']:.3f}, R {st['n_slots']}, {st['tile_pixels']} px tiles, "
        f"short path {st['short_path']}")
    results["_renders"][f"{label} {nx}x{ny} @ {spp}"] = {
        k: st[k] for k in ("seconds", "rays", "mrays_per_sec", "iterations", "occupancy",
                           "short_path")}
    return fb, st


def _statistics(a, b):
    """16x8 luminance correlation and channel-mean difference of two
    renders (tests/test_parity.py:_compare)."""
    a, b = _down(a[::-1]), _down(b[::-1])
    corr = float(np.corrcoef(a.mean(-1).ravel(), b.mean(-1).ravel())[0, 1])
    return corr, float(np.abs(a.mean((0, 1)) - b.mean((0, 1))).max())


def _same_uniforms(checks, dev, label, name, short_path):
    """The kernel path against the plain path on the same injected uniforms
    (``n_uniform_cols`` rows) at SAME_UNIFORMS[name]'s size: iterations
    equal, >= 98% of the pixels within 1e-3."""
    from art_tpu_torch.render.integrator import n_uniform_cols
    from art_tpu_torch.render.renderer import RenderConfig, plan_batches, render_scene

    nx, ny, spp = SAME_UNIFORMS[label if label in SAME_UNIFORMS else name]
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp)
    R = plan_batches(nx * ny, spp, 488, cfg, dev)[2]
    scene = _scene(name, nx, ny)
    ncols = n_uniform_cols(scene.tables)  # 9 + the media (at least one column)

    def uniforms(tile, chunk, it):
        return np.random.default_rng([SEED, tile, chunk, it]).random((ncols, R),
                                                                     dtype=np.float32)

    kfb, kst = render_scene(scene, cfg, device=dev, uniforms=uniforms, short_path=short_path)
    pfb, pst = render_scene(scene, cfg, device=dev, uniforms=uniforms, plain=True,
                            short_path=short_path)
    close = float((np.abs(kfb - pfb).max(axis=-1) <= 1e-3).mean())
    checks.expect(kst["iterations"] == pst["iterations"] and close >= 0.98,
                  f"{label} {nx}x{ny} @ {spp}, same uniforms: iterations "
                  f"{kst['iterations']} vs {pst['iterations']}, {close:.4f} of "
                  f"pixels within 1e-3, rays {kst['rays']:.0f} vs {pst['rays']:.0f}, "
                  f"short path {kst['short_path']}")


def render_checks(checks: Checks, dev, smi: str, results: dict):
    import torch

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.render.renderer import RenderConfig, render_scene

    counts_by_render: dict = {}
    results["_renders"] = {}
    name, nx, ny, spp = THREE
    fb, _ = _render(checks, dev, name, nx, ny, spp, results, counts_by_render)
    top = fb[-1].mean(axis=0)
    checks.expect(top[2] > top[0], f"three_spheres: top row blue-ish (mean rgb {top})")

    name, nx, ny, spp = BOUNCING
    _render(checks, dev, name, nx, ny, spp, results, counts_by_render)

    name, nx, ny, spp = CORNELL
    scene = build_scene(name, nx, ny)
    fb, st = _render(checks, dev, name, nx, ny, spp, results, counts_by_render, scene)
    lum = fb.mean(axis=(1, 2))
    lo, hi = _light_rows(scene, ny)
    brightest = int(np.argmax(lum))
    checks.expect(lo <= brightest <= hi,
                  f"{name}: brightest row {brightest} (mean {lum[brightest]:.3f}) lies in "
                  f"the ceiling light's rows {lo}..{hi} (frame mean {lum.mean():.3f})")
    label, nx, ny, spp = BOXES_ALONE
    _render(checks, dev, label, nx, ny, spp, results, counts_by_render,
            _box_scene(checker=False, floor=False))

    images = {}
    for label, name, nx, ny, spp, short in SHORT:
        images[label], _ = _render(checks, dev, name, nx, ny, spp, results,
                                   counts_by_render, label=label, short_path=short)
    corr, mean_diff = _statistics(images["perlin"], images["perlin staged"])
    checks.expect(corr >= 0.98 and mean_diff <= 0.02,
                  f"perlin 1200x600 @ 64, short path against staged: luminance corr "
                  f"{corr:.4f} (>= 0.98), channel mean diff {mean_diff:.4f} (<= 0.02)")

    # the image scenes, three renders each; the launch counts are the first's
    for label, name, nx, ny, spp, short in IMAGE:
        scene = build_scene(name, nx, ny)
        seconds = []
        for rep in range(IMAGE_RENDERS):
            counts = {}
            images[label], st = _render(checks, dev, name, nx, ny, spp, results, counts,
                                        scene=scene, label=label, short_path=short)
            seconds.append(st["seconds"])
            if rep == 0:
                counts_by_render.update(counts)
        results["_renders"][f"{label} {nx}x{ny} @ {spp}"]["seconds_each"] = seconds
    fb = images["earth"]
    h, w = fb.shape[0] // 2, fb.shape[1] // 2
    top, mid = fb[-1].mean(axis=0), fb[h - 20:h + 20, w - 20:w + 20].mean(axis=(0, 1))
    checks.expect(top[2] > top[0] and float(mid.max() - mid.min()) > 0.02,
                  f"earth: top row blue-ish sky (mean rgb {top}), the globe's centre "
                  f"textured, not grey (mean rgb {mid})")

    # the big scenes (box grid, sphere tail, media); the launch counts are
    # each path's first render's
    for label, name, nx, ny, spp, reps in BIG_SCENES:
        scene = _box_field(nx, ny) if name == "box field" else build_scene(name, nx, ny)
        seconds = []
        for rep in range(reps):
            counts = {}
            images[label], st = _render(checks, dev, name, nx, ny, spp, results, counts,
                                        scene=scene, label=label)
            seconds.append(st["seconds"])
            if rep == 0:
                counts_by_render.update(counts)
        results["_renders"][f"{label} {nx}x{ny} @ {spp}"]["seconds_each"] = seconds
        fb = images[label]
        checks.expect(bool(np.isfinite(fb).all() and (fb >= 0).all()) and fb.mean() > 1e-3,
                      f"{label}: finite, >= 0 and not black (mean {fb.mean():.4f}, max "
                      f"{fb.max():.3f})")

    # the opt-in routes at full width against the default route: the
    # cluster slice's (CLUSTER_RUNS) off / on / on / off, the others
    # (ROUTE_RUNS, SLICE8_RUNS) on / off; the first "on" render is the
    # route's path render (its launch counts)
    from art_tpu_torch.ops import routes

    results["_routes"] = {}
    for label, name, nx, ny, spp, switches in ROUTE_RUNS + CLUSTER_RUNS + SLICE8_RUNS:
        scene = _scene(name, nx, ny)
        turns = (("default", "route", "route", "default") if label in [
            r[0] for r in CLUSTER_RUNS] else ("route", "default"))
        seconds = []
        for n, mode in enumerate(turns):
            with routes.using(**(switches if mode == "route" else {})):
                if n == turns.index("route"):
                    fb, st = _render(checks, dev, name, nx, ny, spp, results, counts_by_render,
                                     scene=scene, label=label)
                    checks.expect(fb.mean() > 1e-3, f"{label}: not black (mean {fb.mean():.4f})")
                else:
                    _, st = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp), device=dev)
            seconds.append(st["seconds"])
        results["_routes"][label] = dict(switches=switches, turns=turns, seconds=seconds)
        log(f"  {label} {nx}x{ny} @ {spp}, {' / '.join(turns)}: "
            f"{' / '.join(f'{x:.3f}' for x in seconds)} s")
    # the BVH descent: one render (plain PyTorch intersection, no sphere kernel)
    label, name, nx, ny, spp, switches = BVH_RUN
    with routes.using(**switches):
        fb, st = _render(checks, dev, name, nx, ny, spp, results, counts_by_render,
                         label=label)
    checks.expect(fb.mean() > 1e-3, f"{label}: not black (mean {fb.mean():.4f})")
    results["_routes"][label] = dict(switches=switches, seconds=st["seconds"],
                                     iterations=st["iterations"])

    label, name, nx, ny, spp, _ = BIG_SCENES[0]
    results["_render"] = dict(results["_renders"][f"{label} {nx}x{ny} @ {spp}"],
                              scene=f"{label} {nx}x{ny} @ {spp}", card=smi)
    # the main path runs no split: one K2 an iteration, as one K1
    c = counts_by_render[label]
    checks.expect(c.get("sphere_hit") == c.get("refill"),
                  f"{label}: the full-table K2 once an iteration ({c.get('sphere_hit')} "
                  f"launches, K1 {c.get('refill')})")
    # and the media in one launch an iteration, on every scene with media
    for name in MEDIA_SCENES:
        c = counts_by_render[name]
        checks.expect(c.get("media") == c.get("refill"),
                      f"{name}: K18 once an iteration ({c.get('media')} launches, K1 "
                      f"{c.get('refill')})")
    # each kernel's count is that of the first default-route render that
    # runs it: bouncing_spheres (bench.py's headline), final_scene,
    # cornell_box, the image scenes, the short-path scenes, then the other
    # default renders; a kernel that only an opt-in route runs takes that
    # route's count: the plain split (K4's compaction form), the slice-8
    # routes (SLICE8_RUNS),
    # K15's, then the culling slice's
    order = (["bouncing_spheres", "final_scene", "cornell_box"]
             + [lab for lab, *_ in IMAGE + SHORT]
             + ["three_spheres"] + [lab for lab, *_ in BIG_SCENES[1:]] + [BOXES_ALONE[0]]
             + ["final_scene split"]  # K4's compaction form: the plain split's
             + [lab for lab, *_ in SLICE8_RUNS] + [lab for lab, *_ in CLUSTER_RUNS]
             + ["bouncing_spheres cellbin", "final_scene skip"]
             + [lab for lab, *_ in ROUTE_RUNS] + [BVH_RUN[0]])
    for k in KERNELS:
        results[k]["launches_by_render"] = {
            lab: c.get(k, 0) for lab, c in counts_by_render.items()}
        path = next((lab for lab in order if k in PATHS[lab]), None)
        # K8 and K4's flush form are on no render's path (their calls are
        # phase 2d's checks)
        results[k]["launches"] = counts_by_render[path].get(k, 0) if path else 0
        results[k]["launches_path"] = path or "no render's path"

    independent = {}  # default-route renders with seed 2, per scene
    runs = ROUTE_RUNS + CLUSTER_RUNS + [BVH_RUN] + SLICE8_RUNS
    for label in list(SAME_UNIFORMS) + [lab for lab, *_ in runs]:
        route = next((r for r in runs if r[0] == label), None)
        name = route[1] if route else label.split()[0]
        if label == "box field":
            name = label
        short_path = False if "staged" in label else None
        with routes.using(**(route[-1] if route else {})):
            _same_uniforms(checks, dev, label, name, short_path)
            # the box field's default path: its same-uniform render alone
            if route is None and (label not in INDEPENDENT or label == "box field"):
                continue
            # independent seeds: kernels with Philox seed 1 against the plain
            # path (or, for a route, the default route's kernels) with seed 2
            nx, ny, spp = INDEPENDENT[name]
            scene = _scene(name, nx, ny)
            kfb, _ = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp, seed=1),
                                  device=dev)
        if route is None:
            pfb, _ = render_scene(scene, RenderConfig(nx=nx, ny=ny, spp=spp, seed=2),
                                  device=dev, plain=True)
            against = "plain"
        else:
            if name not in independent:
                independent[name] = render_scene(
                    scene, RenderConfig(nx=nx, ny=ny, spp=spp, seed=2), device=dev)[0]
            pfb, against = independent[name], "the default route"
        corr, mean_diff = _statistics(kfb, pfb)
        checks.expect(corr >= 0.98 and mean_diff <= 0.02,
                      f"{label} {nx}x{ny} @ {spp}, independent seeds against {against}: "
                      f"luminance corr {corr:.4f} (>= 0.98), channel mean diff "
                      f"{mean_diff:.4f} (<= 0.02)")
    torch.cuda.synchronize()


class _Interrupt(Exception):
    pass


def checkpoint_checks(checks: Checks, dev, results: dict):
    """Checkpoint and resume through ``render_scene(..., checkpoint_path)``:
    CHECKPOINT rendered uninterrupted, then interrupted after
    CHECKPOINT_STOP dispatches by an exception from a wrapped
    ``render_wavefront``, then resumed (with the launch counts set to 0
    just before it and read just after); the resumed image held to the
    uninterrupted one per pixel within 1e-5 relative and 1e-6 absolute (the
    flush's float32 atomics add in a run-dependent order), its rays equal,
    only the remaining dispatches run; the seconds of one save."""
    import os
    import tempfile

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.render import renderer

    name, nx, ny, spp = CHECKPOINT
    scene = build_scene(name, nx, ny)
    cfg = renderer.RenderConfig(nx=nx, ny=ny, spp=spp)
    full, fst = renderer.render_scene(scene, cfg, device=dev)
    wavefront, save = renderer.render_wavefront, renderer.save_checkpoint
    calls, saves, stop = [0], [], [CHECKPOINT_STOP]

    def stopping(*a, **kw):
        if stop[0] is not None and calls[0] >= stop[0]:
            raise _Interrupt()
        calls[0] += 1
        return wavefront(*a, **kw)

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        save(*a, **kw)
        saves.append(time.perf_counter() - t0)

    renderer.render_wavefront, renderer.save_checkpoint = stopping, timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "render")
            interrupted = False
            try:
                renderer.render_scene(scene, cfg, checkpoint_path=path, device=dev)
            except _Interrupt:
                interrupted = True
            first, calls[0], stop[0] = calls[0], 0, None
            _build.launches.clear()
            fb, st = renderer.render_scene(scene, cfg, checkpoint_path=path, device=dev)
            counts = dict(_build.launches)
            size = os.path.getsize(path + ".npz")
    finally:
        renderer.render_wavefront, renderer.save_checkpoint = wavefront, save
    n = -(-nx * ny // fst["tile_pixels"]) * -(-spp // fst["spp_chunk"])  # the dispatches
    diff = np.abs(fb - full)
    rel = diff / np.maximum(np.abs(full), 1e-30)
    within = bool((diff <= 1e-6 + 1e-5 * np.abs(full)).all())
    unused = [k for k in KERNELS if k not in PATHS[name] and counts.get(k, 0)]
    checks.expect(interrupted and first == CHECKPOINT_STOP and calls[0] == n - CHECKPOINT_STOP
                  and all(counts.get(k, 0) > 0 for k in PATHS[name]) and not unused,
                  f"checkpoint: {name} {nx}x{ny} @ {spp} in {n} dispatches, interrupted after "
                  f"{first}, resumed with {calls[0]}, launching {PATHS[name]} and no other "
                  f"kernel: {counts}")
    checks.expect(within and st["rays"] == fst["rays"] and bool(np.isfinite(fb).all()),
                  f"checkpoint: the resumed image within 1e-5 relative and 1e-6 absolute of "
                  f"the uninterrupted one on every pixel: {within} (max abs {diff.max():.3g}, "
                  f"max rel {rel.max():.3g}); rays {st['rays']:.0f} and {fst['rays']:.0f}")
    results["_checkpoint"] = dict(
        scene=f"{name} {nx}x{ny} @ {spp}", dispatches=n, interrupted_after=first,
        resumed_dispatches=calls[0], max_abs=float(diff.max()), max_rel=float(rel.max()),
        save_s=saves, save_mean_s=float(np.mean(saves)), file_bytes=size,
        seconds_uninterrupted=fst["seconds"], seconds_resumed=st["seconds"])
    log(f"  {n} dispatches; resumed after {first}: max abs {diff.max():.3g}, max rel "
        f"{rel.max():.3g}; a save {np.mean(saves):.4f} s (each {[round(x, 4) for x in saves]}), "
        f"{size} bytes; uninterrupted {fst['seconds']:.3f} s, resumed {st['seconds']:.3f} s")


def _allreduce_ms(mesh, tile_pixels: int, reps: int = 5) -> float:
    """Median ms of one all-reduce of a (tile_pixels, 3) float32 tile on the
    mesh's collective device, each after a barrier (so without the wait for
    the slowest rank that a render's collectives include)."""
    import torch
    import torch.distributed as dist

    buf = torch.zeros((tile_pixels, 3), dtype=torch.float32, device=mesh.comm_device)
    times = []
    for _ in range(reps + 1):  # the first warms up
        dist.barrier(group=mesh.group)
        if buf.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group)
        if buf.is_cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:]) * 1e3)


def _mesh_one_rank(rank: int, world: int, device: str, name: str, nx: int, ny: int,
                   spp: int, pairs: int) -> dict:
    """Phase 6's world of one (NCCL on the card): ``pairs`` interleaved
    ``render_scene`` / ``render_scene_sharded`` renders after a warm-up,
    each sharded render's launch counts set to 0 just before it and read
    just after; the last pair's images."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.parallel import make_mesh, render_scene_sharded
    from art_tpu_torch.render.renderer import RenderConfig, render_scene

    mesh = make_mesh(device=device)
    scene, cfg = build_scene(name, nx, ny), RenderConfig(nx=nx, ny=ny, spp=spp)
    # warm-up: the first collective sets up the communicator
    render_scene_sharded(build_scene(name, 64, 64), RenderConfig(nx=64, ny=64, spp=2), mesh)
    render_scene(scene, cfg, device=mesh.device)
    out = {"single": [], "sharded": [], "counts": []}
    for _ in range(pairs):
        fb, st = render_scene(scene, cfg, device=mesh.device)
        _build.launches.clear()
        sfb, sst = render_scene_sharded(scene, cfg, mesh)
        out["counts"].append(dict(_build.launches))
        out["single"].append(st)
        out["sharded"].append(sst)
    out["fb"], out["fb_sharded"] = fb, sfb
    out["allreduce_ms"] = _allreduce_ms(mesh, sst["tile_pixels"])
    return out


def _mesh_nccl_shared(rank: int, world: int, device: str) -> None:
    """Two NCCL ranks on one card: the first collective."""
    import torch
    import torch.distributed as dist

    from art_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=device)
    x = torch.ones(4, device=mesh.device)
    dist.all_reduce(x)
    torch.cuda.synchronize()


def _mesh_gloo_rank(rank: int, world: int, device: str, scenes, shapes, ckpt, stop: int,
                    ckpt_dir: str) -> dict:
    """Phase 6's two ranks on the one card (gloo, each on cuda:0): a warm-up
    render, then each of ``scenes`` on each mesh of ``shapes`` (the launch
    counts set to 0 just before each and read just after, and this rank's
    partial radiance sum of each dispatch), then ``ckpt`` on a 1x2 mesh
    uninterrupted, interrupted after ``stop`` dispatches, and resumed."""
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.parallel import make_mesh, render_scene_sharded, sharding
    from art_tpu_torch.render.renderer import RenderConfig

    wavefront = sharding.render_wavefront
    calls, partial, halt = [0], [], [None]

    def recording(*a, **kw):
        if halt[0] is not None and calls[0] >= halt[0]:
            raise _Interrupt()
        calls[0] += 1
        rad, rays, iters = wavefront(*a, **kw)
        partial.append(float(rad.double().sum()))
        return rad, rays, iters

    sharding.render_wavefront = recording
    out = {}
    try:
        meshes = {shape: make_mesh(shape, device=device) for shape in shapes}
        warm = build_scene(scenes[0][0], 64, 64)
        render_scene_sharded(warm, RenderConfig(nx=64, ny=64, spp=2), meshes[shapes[0]])
        for shape in shapes:
            for name, nx, ny, spp in scenes:
                scene = build_scene(name, nx, ny)
                partial.clear()
                _build.launches.clear()
                fb, st = render_scene_sharded(scene, RenderConfig(nx=nx, ny=ny, spp=spp),
                                              meshes[shape])
                out[(shape, name)] = dict(stats=st, counts=dict(_build.launches),
                                          partial=list(partial),
                                          fb=fb if rank == 0 else None,
                                          allreduce_ms=_allreduce_ms(meshes[shape],
                                                                     st["tile_pixels"]))
        name, nx, ny, spp = ckpt
        scene, cfg = build_scene(name, nx, ny), RenderConfig(nx=nx, ny=ny, spp=spp)
        mesh = meshes[(1, 2)]
        full, fst = render_scene_sharded(scene, cfg, mesh)
        path = f"{ckpt_dir}/sharded"
        calls[0], halt[0] = 0, stop
        try:
            render_scene_sharded(scene, cfg, mesh, checkpoint_path=path)
            interrupted = False
        except _Interrupt:
            interrupted = True
        first, calls[0], halt[0] = calls[0], 0, None
        _build.launches.clear()
        fb, st = render_scene_sharded(scene, cfg, mesh, checkpoint_path=path)
        out["checkpoint"] = dict(full=full, fst=fst, fb=fb, st=st, first=first,
                                 second=calls[0], interrupted=interrupted,
                                 counts=dict(_build.launches))
    finally:
        sharding.render_wavefront = wavefront
    return out


def _mesh_text(st: dict) -> str:
    return (f"{st['seconds']:.3f} s, {st['mrays_per_sec']:.2f} Mrays/s, {st['rays']:.0f} "
            f"rays, collective {st['collective_ms']:.3f} ms a dispatch x {st['dispatches']} "
            f"({st['backend']}, world {st['world']}, mesh {st['mesh']})")


def mesh_checks(checks: Checks, dev, results: dict):
    """Multi-device rendering (``art_tpu_torch.parallel``) on the one card,
    every run at full scene size, every world of child processes started by
    ``spawn_ranks`` with a timeout (a failed or late rank fails the phase):
    a world of one on NCCL (MESH_ONE sharded against ``render_scene``:
    rays equal, every pixel within 1e-5 relative and 1e-6 absolute); the
    error NCCL gives two ranks on one device; two ranks on gloo, each on
    cuda:0, with 2x1 and 1x2 meshes over MESH_SCENES, each held to
    ``render_scene`` by the gate for independent renders, ``spp`` at least
    the config's, the two spp shards' partial sums apart, each render
    launching its scene's kernels (PATHS) and no other; a 1x2 MESH_CHECKPOINT
    interrupted and resumed within phase 5's bars.  Every rank renders on
    ``dev``."""
    import os
    import tempfile

    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build
    from art_tpu_torch.parallel import spawn_ranks
    from art_tpu_torch.render.renderer import RenderConfig, render_scene

    _build.library()  # built before the ranks start: they load it
    record = results["_mesh"] = {}

    # ---- a world of one on NCCL ----
    device = str(dev)
    name, nx, ny, spp = MESH_ONE
    t0 = time.perf_counter()
    [one] = spawn_ranks(_mesh_one_rank, 1, (device, name, nx, ny, spp, MESH_PAIRS),
                        backend="nccl", timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    full, sfb = one["fb"], one["fb_sharded"]
    diff = np.abs(sfb - full)
    within = bool((diff <= 1e-6 + 1e-5 * np.abs(full)).all())
    single, sharded = one["single"][-1], one["sharded"][-1]
    checks.expect(within and sharded["rays"] == single["rays"]
                  and sharded["mesh"] == {"px": 1, "spp": 1},
                  f"mesh 1x1 (nccl) {name} {nx}x{ny} @ {spp}: rays {sharded['rays']:.0f} "
                  f"(render_scene {single['rays']:.0f}), every pixel within 1e-5 relative and "
                  f"1e-6 absolute: {within} (max abs {diff.max():.3g})")
    for counts in one["counts"]:
        unused = [k for k in KERNELS if k not in PATHS[name] and counts.get(k, 0)]
        checks.expect(all(counts.get(k, 0) > 0 for k in PATHS[name]) and not unused,
                      f"mesh 1x1 (nccl) {name}: launched {PATHS[name]} and no other kernel: "
                      f"{counts}")
    secs = [st["seconds"] for st in one["single"]], [st["seconds"] for st in one["sharded"]]
    record["one"] = dict(scene=f"{name} {nx}x{ny} @ {spp}", backend="nccl", world=1,
                         render_scene_s=secs[0], sharded_s=secs[1],
                         ratio=float(np.median(secs[1]) / np.median(secs[0])),
                         collective_ms=[st["collective_ms"] for st in one["sharded"]],
                         allreduce_ms=one["allreduce_ms"],
                         mrays_per_sec=[st["mrays_per_sec"] for st in one["sharded"]],
                         max_abs=float(diff.max()), world_wall_s=wall)
    log(f"  mesh 1x1 {name} {nx}x{ny} @ {spp}: render_scene "
        f"{' / '.join(f'{x:.3f}' for x in secs[0])} s, sharded "
        f"{' / '.join(f'{x:.3f}' for x in secs[1])} s (median ratio "
        f"{record['one']['ratio']:.4f}); last sharded: {_mesh_text(sharded)}; an all-reduce "
        f"of the tile alone {one['allreduce_ms']:.3f} ms; the world {wall:.1f} s")

    # ---- two NCCL ranks on one device: the error ----
    try:
        spawn_ranks(_mesh_nccl_shared, 2, (device,), backend="nccl",
                    timeout=NCCL_SHARED_TIMEOUT)
        record["nccl_two_ranks_one_device"] = "no error"
    except (RuntimeError, TimeoutError) as exc:
        text = str(exc)
        at = text.find("Duplicate GPU")
        record["nccl_two_ranks_one_device"] = text[at:at + 300] if at >= 0 else text[-600:]
    log(f"  two NCCL ranks on cuda:0: {record['nccl_two_ranks_one_device']!r}")

    # ---- two ranks on the one card, gloo ----
    refs = {}
    for sname, snx, sny, sspp in MESH_SCENES:
        scene, cfg = build_scene(sname, snx, sny), RenderConfig(nx=snx, ny=sny, spp=sspp)
        render_scene(scene, cfg, device=dev)  # warm
        refs[sname] = render_scene(scene, cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_mesh_gloo_rank, 2, (device, MESH_SCENES, MESH_SHAPES,
                                                 MESH_CHECKPOINT, CHECKPOINT_STOP, tmp),
                            backend="gloo", timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tmp, "sharded.npz"))
    record["two"] = {}
    for shape in MESH_SHAPES:
        for sname, snx, sny, sspp in MESH_SCENES:
            r0, r1 = ranks[0][(shape, sname)], ranks[1][(shape, sname)]
            st, (rfb, rst) = r0["stats"], refs[sname]
            # the 16x8 grid of _statistics over the largest part of the frame
            # it tiles (600 is no multiple of 16)
            h, w = sny // 8 * 8, snx // 16 * 16
            corr, mean_diff = _statistics(r0["fb"][:h, :w], rfb[:h, :w])
            label = f"mesh {shape[0]}x{shape[1]} (gloo, 2 ranks on {device}) {sname}"
            checks.expect(corr >= 0.98 and mean_diff <= 0.02 and st["spp"] >= sspp
                          and st["rays"] == r1["stats"]["rays"],
                          f"{label} {snx}x{sny} @ {sspp} against render_scene: luminance corr "
                          f"{corr:.4f} (>= 0.98), channel mean diff {mean_diff:.4f} (<= 0.02), "
                          f"spp {st['spp']} (>= {sspp}), rays {st['rays']:.0f} on both ranks")
            if shape[1] > 1:
                apart = all(a != b for a, b in zip(r0["partial"], r1["partial"]))
                checks.expect(apart and len(r0["partial"]) == len(r1["partial"]) > 0,
                              f"{label}: the two spp shards' partial sums differ in every "
                              f"dispatch: {r0['partial'][:3]} vs {r1['partial'][:3]}")
            for r, rr in enumerate((r0, r1)):
                counts = rr["counts"]
                unused = [k for k in KERNELS if k not in PATHS[sname] and counts.get(k, 0)]
                checks.expect(all(counts.get(k, 0) > 0 for k in PATHS[sname]) and not unused,
                              f"{label}, rank {r}: launched {PATHS[sname]} and no other "
                              f"kernel: {counts}")
            record["two"][f"{shape[0]}x{shape[1]} {sname}"] = dict(
                seconds=st["seconds"], render_scene_s=rst["seconds"],
                ratio=st["seconds"] / rst["seconds"], mrays_per_sec=st["mrays_per_sec"],
                render_scene_mrays_per_sec=rst["mrays_per_sec"],
                collective_ms=st["collective_ms"], dispatches=st["dispatches"],
                allreduce_ms=r0["allreduce_ms"],
                backend=st["backend"], world=st["world"], corr=corr, mean_diff=mean_diff)
            log(f"  {label} {snx}x{sny} @ {sspp}: {_mesh_text(st)}; an all-reduce of the "
                f"tile alone {r0['allreduce_ms']:.3f} ms; render_scene "
                f"{rst['seconds']:.3f} s ({rst['mrays_per_sec']:.2f} Mrays/s), ratio "
                f"{st['seconds'] / rst['seconds']:.3f}")
    ck = ranks[0]["checkpoint"]
    cname, cnx, cny, cspp = MESH_CHECKPOINT
    full, fst, fb, st = ck["full"], ck["fst"], ck["fb"], ck["st"]
    n = fst["dispatches"]
    diff = np.abs(fb - full)
    within = bool((diff <= 1e-6 + 1e-5 * np.abs(full)).all())
    unused = [k for k in KERNELS if k not in PATHS[cname] and ck["counts"].get(k, 0)]
    checks.expect(ck["interrupted"] and ck["first"] == CHECKPOINT_STOP
                  and ck["second"] == n - CHECKPOINT_STOP and within
                  and st["rays"] == fst["rays"] and not unused
                  and all(ck["counts"].get(k, 0) > 0 for k in PATHS[cname])
                  and ranks[1]["checkpoint"]["second"] == n - CHECKPOINT_STOP,
                  f"mesh 1x2 checkpoint {cname} {cnx}x{cny} @ {cspp}: {n} dispatches, "
                  f"interrupted after {ck['first']}, resumed with {ck['second']} (rank 1 "
                  f"{ranks[1]['checkpoint']['second']}), launching {PATHS[cname]} and no "
                  f"other kernel ({ck['counts']}); within 1e-5 relative and 1e-6 absolute "
                  f"of the uninterrupted render: {within} (max abs {diff.max():.3g}); rays "
                  f"{st['rays']:.0f} and {fst['rays']:.0f}")
    record["checkpoint"] = dict(scene=f"{cname} {cnx}x{cny} @ {cspp}", dispatches=n,
                                interrupted_after=ck["first"], resumed=ck["second"],
                                max_abs=float(diff.max()), file_bytes=size,
                                seconds_uninterrupted=fst["seconds"],
                                seconds_resumed=st["seconds"])
    record["two_ranks_world_wall_s"] = wall
    log(f"  mesh 1x2 checkpoint: max abs {diff.max():.3g}, {size} bytes; the two-rank "
        f"world {wall:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a "
              "CUDA device", file=sys.stderr)
        return 1
    import art_tpu_torch  # noqa: F401 — fails outside the repository

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    checks = Checks()
    results = {name: {"launches": 0, "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None,
                      # no single PyTorch call computes these functions but K4's
                      # and K8's (index_put_, index_select: phase 2d; K8's fetch
                      # form beside the dense where(needy, index_select))
                      "library_ms": None}
               for name in KERNELS}
    smi = checks.phase("1. card, toolchain, kernel build", card_info, checks, dev) or ""
    checks.phase("1b. registers, spills and hot loops of K2, K9, K10, K7, K11, K1, K12, K5, "
                 "K6, K3, K14, K16, K17; K18's registers; K13's per-scene builds, code size "
                 "and loops",
                 sass_report, checks, results)
    checks.phase("2a. K1, K2, K3 against their plain twins", kernel_checks, checks, dev,
                 results)
    checks.phase("2b. K5, K6 (both forms), baked K3 against their plain twins",
                 quad_box_checks,
                 checks, dev, results)
    checks.phase("2c. K7, K11 against their plain twins", turb_sp_checks, checks, dev,
                 results)
    checks.phase("2d. K4, K8 (both forms) and the compacted fetch against their plain twins",
                 compact_checks, checks, dev, results)
    checks.phase("2e. K9, K10, the split sphere pass and K18, the media", grid_split_checks,
                 checks, dev, results)
    checks.phase("2f. K16 and K17, the culling sphere kernels, and the opt-in routes",
                 cull_checks, checks, dev, results)
    checks.phase("2g. K15, the cluster-culled spheres and boxes, and the BVH route",
                 cluster_checks, checks, dev, results)
    checks.phase("2h. K12, K13 and K14, the seam flush, the baked and the bilinear-feature "
                 "spheres, and the split's MXU tail", slice8_checks, checks, dev, results)
    checks.phase("2i. the refill core's look-back scan: K1, K12 and K11 on 0/30/100% dead "
                 "pools and a 2^22-slot pool, consecutive calls, a new dispatch",
                 refill_scan_checks, checks, dev, results)
    checks.phase("3. Philox uniforms", philox_checks, checks, dev)
    checks.phase("4. renders", render_checks, checks, dev, smi, results)
    checks.phase("5. checkpoint and resume", checkpoint_checks, checks, dev, results)
    checks.phase("6. multi-device: a world of one on NCCL, two ranks on the one card on "
                 "gloo (2x1, 1x2), a sharded checkpoint", mesh_checks, checks, dev, results)
    extra = {key: results.pop(f"_{key}", {}) for key in (
        "render", "renders", "compact_fetch", "noise_p", "grid", "split", "split_parent",
        "media", "cull", "checkpoint",
        "cluster", "slice8", "scan", "routes", "sass", "mesh")}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, **results[name]}
        for name, (src, rep) in KERNELS.items()], **extra, "card": smi}))
    if checks.failed:
        log(f"FAILED: {checks.failed}")
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: {checks.failed}",
              file=sys.stderr, flush=True)
        return 1
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
