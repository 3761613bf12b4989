// The sphere kernels' shared parts: one (ray, sphere) candidate with its
// strict-< merge (in the direct form, and in K13's expanded form), the
// hit's output, the conservative slab test of a box, and the
// head-then-segments scan of the culling kernels K16 (sphere_skip.cu) and
// K17 (sphere_cellbin.cu).  K13 (sphere_static.cu) uses the candidates and
// the output, K2 (sphere_hit.cu) the ray and the output.
//
// Rules (those of the plain twins, ops/intersect_kernels.py, not the TPU
// kernels'):
//  * a miss is `disc > 0` strict (the TPU kernels reject by NaN and so
//    accept disc == 0); the near root if > t_min, else the far root;
//  * rows are scanned in table order with a strict `<`, so an exact tie goes
//    to the earlier row, as argmin;
//  * the normal is the generic (p - c) / r, not the TPU's rsqrt form;
//  * t_min is an argument (the TPU kernels bake T_MIN in at compile time).
// Rows are [c(3) v(3) r mat r2 0] (scene/tables.py sphere_rows); a row's
// centre is c + tm * v at the ray's shutter time (c for a static row).
#pragma once

#include "common.cuh"

namespace art {

constexpr int kSphRow = 10;  // floats a sphere row
constexpr int kSegRow = 8;   // floats a segment row: row0 row1 box(6)

struct SpherePlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  float *t, *nx, *ny, *nz;
  int *mat;
};

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out)
inline SpherePlanes sphere_planes(void* const* planes) {
  SpherePlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.tm = (const float*)planes[6];
  p.t = (float*)planes[7]; p.nx = (float*)planes[8];
  p.ny = (float*)planes[9]; p.nz = (float*)planes[10];
  p.mat = (int*)planes[11];
  return p;
}

struct SphereRay {
  float ox, oy, oz, dx, dy, dz, tm, a, inv_a;
};

// lane i's ray; a lane that is not live reads a dummy ray (0, 0, 1)
__device__ __forceinline__ SphereRay load_ray(const SpherePlanes& p, int i, bool live) {
  SphereRay q;
  q.ox = live ? p.ox[i] : 0.f; q.oy = live ? p.oy[i] : 0.f; q.oz = live ? p.oz[i] : 0.f;
  q.dx = live ? p.dx[i] : 0.f; q.dy = live ? p.dy[i] : 0.f; q.dz = live ? p.dz[i] : 1.f;
  q.tm = live ? p.tm[i] : 0.f;
  q.a = q.dx * q.dx + q.dy * q.dy + q.dz * q.dz;
  q.inv_a = 1.0f / q.a;
  return q;
}

// the closest hit so far: its t and the winner's centre, radius, material
struct SphereBest {
  float t, cx, cy, cz, r, mat;
};

__device__ __forceinline__ SphereBest no_hit() {
  return SphereBest{kBig, 0.f, 0.f, 0.f, 1.f, 0.f};
}

// one candidate: the sphere of centre (cx, cy, cz) (at the ray's time),
// radius r, material mat and r2 = r * r replaces `b` if its root is
// strictly closer
__device__ __forceinline__ void sphere_test_at(float cx, float cy, float cz, float r,
                                               float mat, float r2, const SphereRay& q,
                                               float t_min, SphereBest& b) {
  const float ocx = q.ox - cx, ocy = q.oy - cy, ocz = q.oz - cz;
  const float bq = ocx * q.dx + ocy * q.dy + ocz * q.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  const float disc = bq * bq - q.a * c;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t1 = (-bq - sq) * q.inv_a;
    const float t2 = (-bq + sq) * q.inv_a;
    const float t = t1 > t_min ? t1 : (t2 > t_min ? t2 : kBig);
    if (t < b.t) b = SphereBest{t, cx, cy, cz, r, mat};
  }
}

// one candidate of a table row [c(3) v(3) r mat r2 .]
__device__ __forceinline__ void sphere_test(const float* row, const SphereRay& q,
                                            float t_min, SphereBest& b) {
  sphere_test_at(row[0] + q.tm * row[3], row[1] + q.tm * row[4], row[2] + q.tm * row[5],
                 row[6], row[7], row[8], q, t_min, b);
}

// A ray's terms of the expanded quadratic (K13's expand form,
// art_tpu/ops/pallas_kernels.py:433-443): |o|^2, o.d and 2 o.
struct ExpandedRay {
  float oo, od, ox2, oy2, oz2;
};

__device__ __forceinline__ ExpandedRay expanded_ray(const SphereRay& q) {
  return ExpandedRay{q.ox * q.ox + q.oy * q.oy + q.oz * q.oz,
                     q.ox * q.dx + q.oy * q.dy + q.oz * q.dz,
                     2.0f * q.ox, 2.0f * q.oy, 2.0f * q.oz};
}

// sphere_test_at in the expanded form of a static sphere with
// K = |c|^2 - r^2: bq = o.d - c.d, c = (|o|^2 + K) - c.(2 o)
__device__ __forceinline__ void sphere_test_expanded(float cx, float cy, float cz, float r,
                                                     float mat, float K, const SphereRay& q,
                                                     const ExpandedRay& e, float t_min,
                                                     SphereBest& b) {
  const float bq = e.od - (cx * q.dx + cy * q.dy + cz * q.dz);
  const float c = (e.oo + K) - (cx * e.ox2 + cy * e.oy2 + cz * e.oz2);
  const float disc = bq * bq - q.a * c;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t1 = (-bq - sq) * q.inv_a;
    const float t2 = (-bq + sq) * q.inv_a;
    const float t = t1 > t_min ? t1 : (t2 > t_min ? t2 : kBig);
    if (t < b.t) b = SphereBest{t, cx, cy, cz, r, mat};
  }
}

// t, the normal (p - c) / r and the material of lane i; a miss writes
// t = BIG, normal (1, 0, 0), material 0
__device__ __forceinline__ void write_hit(const SpherePlanes& p, int i, const SphereRay& q,
                                          const SphereBest& b) {
  p.t[i] = b.t;
  if (b.t < kBig) {
    const float inv_r = 1.0f / b.r;
    p.nx[i] = (q.ox + b.t * q.dx - b.cx) * inv_r;
    p.ny[i] = (q.oy + b.t * q.dy - b.cy) * inv_r;
    p.nz[i] = (q.oz + b.t * q.dz - b.cz) * inv_r;
    p.mat[i] = (int)b.mat;
  } else {
    p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
  }
}

// Could the ray's (t_min, inf) segment meet the box (x0 y0 z0 x1 y1 z1)?
// Sets t_near, the entry t (ops/compact_sphere.py tail_box_interval, op for
// op): a zero direction component becomes 1e-20, which errs toward "meets".
__device__ __forceinline__ bool slab(const float* box, const SphereRay& q, float t_min,
                                     float& t_near) {
  const float o[3] = {q.ox, q.oy, q.oz}, d[3] = {q.dx, q.dy, q.dz};
  float t_far = kBig;
  t_near = t_min;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = 1.0f / (d[k] == 0.0f ? 1e-20f : d[k]);
    const float ta = (__ldg(box + k) - o[k]) * inv;
    const float tb = (__ldg(box + 3 + k) - o[k]) * inv;
    t_near = nan_max(t_near, nan_min(ta, tb));
    t_far = nan_min(t_far, nan_max(ta, tb));
  }
  return t_far >= t_near;
}

// A warp's scan of rows [r0, r1), each row read once by the whole warp
// (one address a load: an L1 broadcast); unrolled so that the loads of
// several rows are in flight at once.
__device__ __forceinline__ void scan_rows(const float* __restrict__ rows, int r0, int r1,
                                          const SphereRay& q, float t_min, SphereBest& b) {
#pragma unroll 4
  for (int s = r0; s < r1; ++s) {
    float row[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) row[k] = __ldg(rows + (size_t)s * kSphRow + k);
    sphere_test(row, q, t_min, b);
  }
}

// K16 (kOcclusion false) and K17 (true), one thread a ray.  The head rows
// [0, n_head) for every live lane; then, for lanes whose segment can meet
// seg's row-0 box (and, with kOcclusion, enter it at t_near <= the best t
// so far), each segment k whose box the lane crosses (kOcclusion: at
// t_near <= the running best t), its closest merged with a strict `<`.
// The skip unit is the warp: a warp scans a segment's rows when one of its
// lanes crosses the segment's box (__any_sync), and a lane that does not
// keeps its best (the twin's per-lane mask).  Lanes at or past *n_live
// (when given) are misses; a warp wholly past it tests no sphere.
template <bool kOcclusion>
__device__ __forceinline__ void segmented_hit(const float* __restrict__ rows,
                                              const float* __restrict__ seg, int n_seg,
                                              int n_head, int R, float t_min,
                                              const int* __restrict__ n_live,
                                              const SpherePlanes& p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = n_live ? min(*n_live, R) : R;
  const bool live = i < n;
  const SphereRay q = load_ray(p, i, live);
  SphereBest b = no_hit();
  if (__any_sync(0xffffffffu, live)) {
    scan_rows(rows, 0, n_head, q, t_min, b);
    float t_near;
    bool needy = live && slab(seg + 2, q, t_min, t_near);
    if (kOcclusion) needy = needy && t_near <= b.t;
    if (__any_sync(0xffffffffu, needy)) {
      for (int k = 1; k <= n_seg; ++k) {
        const float* m = seg + (size_t)k * kSegRow;
        bool cross = needy && slab(m + 2, q, t_min, t_near);
        if (kOcclusion) cross = cross && t_near <= b.t;
        if (__any_sync(0xffffffffu, cross)) {
          SphereBest c = no_hit();
          scan_rows(rows, (int)__ldg(m), (int)__ldg(m + 1), q, t_min, c);
          if (cross && c.t < b.t) b = c;
        }
      }
    }
  }
  if (i >= R) return;
  if (!live) b = no_hit();
  write_hit(p, i, q, b);
}

}  // namespace art
