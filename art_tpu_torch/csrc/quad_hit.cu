// K5 — closest quad hit (t and index), one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:quad_closest_hit_planar (:1890,
// _quad_kernel:1842).  For every ray and every quad row [n(3) D avec(3) ca
// bvec(3) cb] (scene/tables.py quad_rows, the layout of pack_quads): the
// plane hit t = (D - n.o) / (n.d), then the interior test
// alpha = avec.o + t avec.d - ca, beta = bvec.o + t bvec.d - cb, both in
// [0, 1] (src/quad.cuh:60-90).  A quad counts when |n.d| >= 1e-8 and
// t > t_min (t_min a run-time argument, as in K2); the scan keeps the first
// quad in scene order with a strict `<`, so an exact tie goes to the lower
// index, as the TPU kernel and argmin.  A miss writes t = BIG and index -1.
// n.d == 0 makes t inf or NaN: every test on it is false, so it is masked,
// never trapped, and a NaN cannot win the `<`.  The winner's normal and
// (alpha, beta) come from ops/intersect.py:quad_attributes_p, as in art_tpu.
// Plain twin: ops/intersect.py quad_candidates_p, same operations in the same
// order (the division is IEEE on both sides, tensor by tensor in the twin).
//
// Bound on the H100: at Q = 6 (cornell_box) memory — 6 planes in and 2 out
// per ray, 32 B, 4.2 MB at R = 2^17 — against ~30 flops per (ray, quad).
// Design: the quad rows are staged through shared memory in tiles of kTile
// rows (24 KB), so any Q fits; every thread of a warp reads the same row,
// so each shared load is a broadcast.

#include "common.cuh"

namespace {

constexpr int kRow = 12;
constexpr int kTile = 512;

struct QuadPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float* t;
  int* idx;
};

__global__ void __launch_bounds__(art::kBlock)
quad_hit_kernel(const float* __restrict__ rows, int Q, int R, float t_min,
                QuadPlanes p) {
  __shared__ float sh[kTile * kRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;

  float best = art::kBig;
  int best_i = -1;
  for (int base = 0; base < Q; base += kTile) {
    const int n = min(kTile, Q - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * kRow + k];
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float* r = sh + q * kRow;
      const float nd = dx * r[0] + dy * r[1] + dz * r[2];
      const float no = ox * r[0] + oy * r[1] + oz * r[2];
      const float t = (r[3] - no) / nd;
      const float alpha = (ox * r[4] + oy * r[5] + oz * r[6]) +
                          t * (dx * r[4] + dy * r[5] + dz * r[6]) - r[7];
      const float beta = (ox * r[8] + oy * r[9] + oz * r[10]) +
                         t * (dx * r[8] + dy * r[9] + dz * r[10]) - r[11];
      const bool valid = fabsf(nd) >= 1e-8f && t > t_min && alpha >= 0.0f &&
                         alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
      if (valid && t < best) {
        best = t;
        best_i = base + q;
      }
    }
  }
  if (!live) return;
  p.t[i] = best;
  p.idx[i] = best_i;
}

}  // namespace

// planes: ox oy oz dx dy dz (in), t (f32) idx (i32) (out); all (R,)
extern "C" int art_quad_hit(const float* rows, int Q, int R, float t_min,
                            void* const* planes, void* stream) {
  QuadPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6];
  p.idx = (int*)planes[7];
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    quad_hit_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(rows, Q, R,
                                                                    t_min, p);
  return (int)cudaGetLastError();
}
