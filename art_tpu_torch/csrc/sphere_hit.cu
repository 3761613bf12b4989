// K2 — closest sphere hit with winner attributes, one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_planar
// (_sphere_kernel:45).  Computes, per ray, the closest t > t_min over every
// sphere (center at the ray's shutter time), then the hit's signed-radius
// normal (p - c) / r and material id; a miss writes t = BIG, normal
// (1, 0, 0), material 0.  Plain twin: ops/intersect_kernels.py
// sphere_hit_attrs_plain (= intersect.sphere_candidates_p +
// sphere_attributes_p), whose rules (sphere.cuh, shared with K16 and K17)
// this follows rather than the TPU kernel's.
// An optional device count n_live makes every lane at or past *n_live a miss
// (the compacted tail pass of ops/compact_sphere.py, whose needy count stays
// on the device): a block wholly past it writes misses and tests no sphere.
//
// Bound on the H100: FP32 throughput — about 25 flops per (ray, sphere), so
// R x S x 25 ≈ 1.6 GFLOP per call at R = 2^17, S = 488; memory traffic is
// 7 planes in and 5 out per ray.  Design: the sphere rows are staged through
// shared memory in tiles of kTile rows ([c(3) v(3) r mat r2 0], 40 B each;
// 488 rows fit one tile).  Every thread of a warp reads the same row, so
// each shared load is a broadcast.  The running best carries (t, c, r, mat)
// so no second pass or table gather is needed for the attributes.  The
// TPU's expanded-quadratic, tail-loop and unroll-padding devices are left
// out (they cut TPU vector op counts).

#include "sphere.cuh"

namespace {

constexpr int kTile = 512;

__global__ void __launch_bounds__(art::kBlock)
sphere_hit_kernel(const float* __restrict__ rows, int S, int R, float t_min,
                  const int* __restrict__ n_live, art::SpherePlanes p) {
  __shared__ float sh[kTile * art::kSphRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_live ? min(*n_live, R) : R;
  if ((int)(blockIdx.x * blockDim.x) >= n) {  // the whole block misses
    if (i < R) {
      p.t[i] = art::kBig; p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
    }
    return;
  }
  const bool live = i < n;
  const art::SphereRay q = art::load_ray(p, i, live);
  art::SphereBest best = art::no_hit();
  for (int base = 0; base < S; base += kTile) {
    const int m = min(kTile, S - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m * art::kSphRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * art::kSphRow + k];
    __syncthreads();
    for (int s = 0; s < m; ++s) art::sphere_test(sh + s * art::kSphRow, q, t_min, best);
  }
  if (i >= R) return;
  if (!live) best = art::no_hit();
  art::write_hit(p, i, q, best);
}

}  // namespace

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out); all (R,);
// n_live: a device int or null (every lane live)
extern "C" int art_sphere_hit(const float* rows, int S, int R, float t_min,
                              const int* n_live, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_hit_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, S, R, t_min, n_live, p);
  return (int)cudaGetLastError();
}
