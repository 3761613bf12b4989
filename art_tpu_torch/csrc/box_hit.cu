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
// The slab guard and the winner's attributes are shared with K9/K10 through
// box_attrs.cuh.  Output (t, normal x3, u, v, mat); a miss writes t = BIG,
// normal (1, 0, 0), u = v = 0, material 0 (the values closest_surface_p
// blends in for misses).
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

constexpr int kRow = 12;
constexpr int kTile = 512;

struct BoxPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float *t, *nx, *ny, *nz, *u, *v;
  int* mat;
};

template <bool kRotated>
__global__ void __launch_bounds__(art::kBlock)
box_hit_kernel(const float* __restrict__ rows, int B, int R, float t_min,
               BoxPlanes p) {
  __shared__ float sh[kTile * kRow];
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
    for (int k = threadIdx.x; k < n * kRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * kRow + k];
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float* r = sh + b * kRow;
      float lox, loy, loz, ldx, ldy, ldz;
      art::to_box_frame<kRotated>(r[6], r[7], r[8], r[9], r[10], ox, oy, oz, dx, dy, dz,
                                  lox, loy, loz, ldx, ldy, ldz);
      const float ix = art::safe_inv(ldx), iy = art::safe_inv(ldy),
                  iz = art::safe_inv(ldz);
      const float tax = (r[0] - lox) * ix, tbx = (r[3] - lox) * ix;
      const float tay = (r[1] - loy) * iy, tby = (r[4] - loy) * iy;
      const float taz = (r[2] - loz) * iz, tbz = (r[5] - loz) * iz;
      const float t0 = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
      const float t1 = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
      const bool through = t0 < t1;
      const float t = (through && t0 > t_min) ? t0
                      : ((through && t1 > t_min) ? t1 : art::kBig);
      if (t < best) {
        best = t;
        best_b = base + b;
      }
    }
  }
  if (!live) return;
  p.t[i] = best;
  if (best_b < 0) {
    p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f;
    p.u[i] = 0.f; p.v[i] = 0.f; p.mat[i] = 0;
    return;
  }
  // ---- winner attributes (_box_write_winner_attrs, box_attrs.cuh) ----
  const float* r = rows + (size_t)best_b * kRow;
  const art::BoxAttrs at = art::box_winner_attrs<kRotated>(
      ox, oy, oz, dx, dy, dz, best, r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
      r[8], r[9], r[10]);
  p.nx[i] = at.nx; p.ny[i] = at.ny; p.nz[i] = at.nz;
  p.u[i] = at.u; p.v[i] = at.v;
  p.mat[i] = (int)r[11];
}

}  // namespace

// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out); all (R,)
extern "C" int art_box_hit(const float* rows, int B, int R, float t_min, int rotated,
                           void* const* planes, void* stream) {
  BoxPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6]; p.nx = (float*)planes[7]; p.ny = (float*)planes[8];
  p.nz = (float*)planes[9]; p.u = (float*)planes[10]; p.v = (float*)planes[11];
  p.mat = (int*)planes[12];
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
