// K6 — closest oriented-box hit with winner attributes, one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:box_hit_attrs_planar (:2139;
// _box_kernel:1943, _box_write_winner_attrs:2053).  Box rows are
// [min(3) max(3) cos sin off(3) mat] (scene/tables.py box_rows, the layout of
// pack_boxes: with no rotated box the offsets are folded into min/max).
// Per ray and box: the ray in the box frame (o - off, then R(-theta), only
// in the rotated form), the slab test with the 1e-12 division guard
// (_safe_div_dir), t = t_entry if through and > t_min, else t_exit if
// through and > t_min, else BIG; the scan keeps the first box in scene
// order with a strict `<`.  Then, for the winner only, the slab is run once
// more to find the face: the entry face if |t - t_entry| <= |t - t_exit|,
// else the exit face; the normal faces against the ray and is rotated back
// to world; u, v are make_box's per-face coordinates (src/quad.cuh:145-162).
// The candidate (box_test), the winner's attributes and the output are
// shared with K15's boxes (box_cluster.cu), the slab guard and the
// attributes with K9/K10, through box_attrs.cuh.  Output (t, normal x3, u,
// v, mat); a miss writes t = BIG, normal (1, 0, 0), u = v = 0, material 0
// (the values closest_surface_p blends in for misses).
// The guard keeps every slab factor finite (|1/d| <= 1e12), so min/max see
// no NaN.  Both forms are templates: kRotated (cornell_box) and the folded
// axis-aligned one.  Plain twin: ops/intersect_kernels.py box_hit_attrs_plain
// (= intersect.box_candidates_p + box_attributes_p over the same rows), same
// operations in the same order; the twin always applies the rotation, which
// for an unrotated box (cos 1, sin 0) changes at most the sign of a zero.
//
// Bound on the H100: at B = 2 (cornell_box) memory — 6 planes in and 7 out
// per ray, 52 B, 6.8 MB at R = 2^17 — against ~40 flops per (ray, box).
// Design: box rows staged through shared memory in tiles of kTile rows, read
// as broadcasts; the scan carries only (t, index) and the winner's row is
// re-read from global memory (48 B, cached) for its attributes.

#include "box_attrs.cuh"

namespace {

constexpr int kTile = 512;

template <bool kRotated>
__global__ void __launch_bounds__(art::kBlock)
box_hit_kernel(const float* __restrict__ rows, int B, int R, float t_min,
               art::BoxPlanes p) {
  __shared__ float sh[kTile * art::kBoxRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;

  float best = art::kBig;
  int best_b = -1;
  for (int base = 0; base < B; base += kTile) {
    const int n = min(kTile, B - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * art::kBoxRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * art::kBoxRow + k];
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float t = art::box_test<kRotated>(sh + b * art::kBoxRow, ox, oy, oz, dx, dy, dz,
                                              t_min);
      if (t < best) {
        best = t;
        best_b = base + b;
      }
    }
  }
  if (!live) return;
  art::write_box_hit<kRotated>(p, i, rows, best_b, best, ox, oy, oz, dx, dy, dz);
}

}  // namespace

// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out); all (R,)
extern "C" int art_box_hit(const float* rows, int B, int R, float t_min, int rotated,
                           void* const* planes, void* stream) {
  const art::BoxPlanes p = art::box_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0) {
    if (rotated)
      box_hit_kernel<true><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, B, R, t_min, p);
    else
      box_hit_kernel<false><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, B, R, t_min, p);
  }
  return (int)cudaGetLastError();
}
