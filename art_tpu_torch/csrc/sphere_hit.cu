// K2 — closest sphere hit with winner attributes, one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_planar
// (_sphere_kernel:45).  Computes, per ray, the closest t > t_min over every
// sphere (center at the ray's shutter time), then the hit's signed-radius
// normal (p - c) / r and material id; a miss writes t = BIG, normal
// (1, 0, 0), material 0.  Plain twin: ops/intersect_kernels.py
// sphere_hit_attrs_plain (= intersect.sphere_candidates_p +
// sphere_attributes_p), whose rules this follows rather than the TPU
// kernel's:
//  * misses are `disc > 0` strict (the TPU kernel rejects by NaN and so
//    accepts disc == 0); the near root if > t_min, else the far root;
//  * spheres are scanned in scene order with a strict `<`, so an exact tie
//    goes to the lower index, as argmin (the TPU table puts moving spheres
//    first, which would change who wins a tie);
//  * the normal is the generic (p - c) / r, not the TPU's rsqrt form;
//  * t_min is an argument (the TPU kernel bakes T_MIN in at compile time,
//    so art_tpu sends any other t_min down its jnp path).
// An optional device count n_live makes every lane at or past *n_live a miss
// (the compacted tail pass of ops/compact_sphere.py, whose needy count stays
// on the device): a block wholly past it writes misses and tests no sphere.
//
// Bound on the H100: FP32 issue — about 25 flops per (ray, sphere), so
// R x S x 25 ≈ 1.6 GFLOP per call at R = 2^17, S = 488; memory traffic is
// 7 planes in and 5 out per ray.  Design: the sphere rows are staged through
// shared memory in tiles of kTile rows ([c(3) v(3) r mat r2 0], 40 B each;
// 488 rows fit one tile).  Every thread of a warp reads the same row, so
// each shared load is a broadcast.  The running best carries (t, c, r, mat)
// so no second pass or table gather is needed for the attributes.  The
// TPU's expanded-quadratic, tail-loop and unroll-padding devices are left
// out (they cut TPU vector op counts).

#include "common.cuh"

namespace {

constexpr int kRow = 10;
constexpr int kTile = 512;

struct SpherePlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  float *t, *nx, *ny, *nz;
  int *mat;
};

__global__ void __launch_bounds__(art::kBlock)
sphere_hit_kernel(const float* __restrict__ rows, int S, int R, float t_min,
                  const int* __restrict__ n_live, SpherePlanes p) {
  __shared__ float sh[kTile * kRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_live ? min(*n_live, R) : R;
  if ((int)(blockIdx.x * blockDim.x) >= n) {  // the whole block misses
    if (i < R) {
      p.t[i] = art::kBig; p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
    }
    return;
  }
  const bool live = i < n;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;
  const float tm = live ? p.tm[i] : 0.f;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;

  float best = art::kBig, bcx = 0.f, bcy = 0.f, bcz = 0.f, br = 1.f, bm = 0.f;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * kRow + k];
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float* row = sh + s * kRow;
      const float cx = row[0] + tm * row[3];
      const float cy = row[1] + tm * row[4];
      const float cz = row[2] + tm * row[5];
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - row[8];
      const float disc = b * b - a * c;
      if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float t1 = (-b - sq) * inv_a;
        const float t2 = (-b + sq) * inv_a;
        const float t = t1 > t_min ? t1 : (t2 > t_min ? t2 : art::kBig);
        if (t < best) {
          best = t; bcx = cx; bcy = cy; bcz = cz; br = row[6]; bm = row[7];
        }
      }
    }
  }
  if (i >= R) return;
  if (!live) best = art::kBig;
  p.t[i] = best;
  if (best < art::kBig) {
    const float inv_r = 1.0f / br;
    p.nx[i] = (ox + best * dx - bcx) * inv_r;
    p.ny[i] = (oy + best * dy - bcy) * inv_r;
    p.nz[i] = (oz + best * dz - bcz) * inv_r;
    p.mat[i] = (int)bm;
  } else {
    p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
  }
}

}  // namespace

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out); all (R,);
// n_live: a device int or null (every lane live)
extern "C" int art_sphere_hit(const float* rows, int S, int R, float t_min,
                              const int* n_live, void* const* planes, void* stream) {
  SpherePlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.tm = (const float*)planes[6];
  p.t = (float*)planes[7]; p.nx = (float*)planes[8];
  p.ny = (float*)planes[9]; p.nz = (float*)planes[10];
  p.mat = (int*)planes[11];
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_hit_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, S, R, t_min, n_live, p);
  return (int)cudaGetLastError();
}
