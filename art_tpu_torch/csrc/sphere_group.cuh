// The staged row scans of K13 (sphere_static.cu) and K17 (sphere_cellbin.cu,
// also K15's spheres with no head):
// K2's group structure (sphere_hit.cu) over rows staged in shared memory as
// float4s, c = (cx, cy, cz, w) and v = (vx, vy, vz, 0), w being r2 (the
// direct quadratic) or K = |c|^2 - r^2 (K13's expanded one):
//  * rows are tested kGroup at a time, one ray or more a thread; a warp
//    votes once a group on the AND of its discriminants' bits (a clear sign
//    bit where one may be > 0) and then once a row, so the roots are taken
//    only where a lane of the warp has disc > 0;
//  * the running best is a (t, row) carry: rows go in table order with a
//    strict `<`, so an exact tie keeps the earlier row, and the winner's
//    centre, radius and material are read from its row after the scan with
//    the plain twin's operations, so the normal keeps its bits;
//  * a lane's `on` flag masks its roots (K17's lanes that do not cross a
//    cell keep their best).
// slab_staged is K17's test of a cell's box.
// The candidates are sphere.cuh sphere_test_at's direct quadratic, op for
// op, and the expanded one of art_tpu's K13 on sphere.cuh ExpandedRay:
// bq = o.d - c.d, c = (|o|^2 + K) - c.(2 o), as the plain twin computes it.  A moving row's centre is
// c + tm * v over the velocity components of kVel (bit k: component k); a
// component left out is c, which a row whose component is 0 gives exactly,
// and c + tm * 0 is c for finite tm up to the sign of a zero, which moves
// neither t nor the winner (sphere_hit.cu's note).
#pragma once

#include "sphere.cuh"

namespace art {

constexpr int kGroup = 8;  // rows a group: one vote

// how a row's candidate is formed (module note)
enum RowForm { kMovingRow, kDirectRow, kExpandedRow };

// the half-b and the discriminant of ray q against the staged row (c, v)
template <int kForm, unsigned kVel>
__device__ __forceinline__ float row_disc(const SphereRay& q, const ExpandedRay& e, float4 c,
                                          float4 v, float& bq) {
  float cc;
  if (kForm == kExpandedRow) {
    bq = e.od - (c.x * q.dx + c.y * q.dy + c.z * q.dz);
    cc = (e.oo + c.w) - (c.x * e.ox2 + c.y * e.oy2 + c.z * e.oz2);
  } else {
    const bool mv = kForm == kMovingRow;
    const float cx = mv && (kVel & 1u) ? c.x + q.tm * v.x : c.x;
    const float cy = mv && (kVel & 2u) ? c.y + q.tm * v.y : c.y;
    const float cz = mv && (kVel & 4u) ? c.z + q.tm * v.z : c.z;
    const float ocx = q.ox - cx, ocy = q.oy - cy, ocz = q.oz - cz;
    bq = ocx * q.dx + ocy * q.dy + ocz * q.dz;
    cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w;
  }
  return bq * bq - q.a * cc;
}

// row s's root replaces (best, idx) where disc > 0 and it is strictly closer
__device__ __forceinline__ void take_root(const SphereRay& q, float bq, float disc,
                                          float t_min, int s, float& best, int& idx) {
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t1 = (-bq - sq) * q.inv_a;
    const float t2 = (-bq + sq) * q.inv_a;
    const float t = t1 > t_min ? t1 : (t2 > t_min ? t2 : kBig);
    if (t < best) {
      best = t;
      idx = s;
    }
  }
}

// row s's roots for the lanes `on`, where a lane of the warp has disc > 0
template <int kRays>
__device__ __forceinline__ void take_row(const SphereRay (&q)[kRays], const bool (&on)[kRays],
                                         const float (&d)[kRays], const float (&bq)[kRays],
                                         float t_min, int s, float (&best)[kRays],
                                         int (&idx)[kRays]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < kRays; ++k) any = any || (on[k] && d[k] > 0.0f);
  if (__any_sync(kFullWarp, any)) {
#pragma unroll
    for (int k = 0; k < kRays; ++k)
      if (on[k]) take_root(q[k], bq[k], d[k], t_min, s, best[k], idx[k]);
  }
}

// the kGroup staged rows at (sc, sv), table rows row0.., with one vote
// (call with every lane of the warp)
template <int kForm, unsigned kVel, int kRays>
__device__ __forceinline__ void scan_group(const float4* sc, const float4* sv,
                                           const SphereRay (&q)[kRays],
                                           const ExpandedRay (&e)[kRays],
                                           const bool (&on)[kRays], float t_min, int row0,
                                           float (&best)[kRays], int (&idx)[kRays]) {
  float d[kGroup][kRays], bq[kGroup][kRays];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const float4 c = sc[r];
    const float4 v = kForm == kMovingRow ? sv[r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kRays; ++k) d[r][k] = row_disc<kForm, kVel>(q[k], e[k], c, v, bq[r][k]);
  }
  // a disc > 0 has a clear sign bit: the AND of the group's discs has a
  // clear sign bit if one may be > 0 (a +0 or a NaN only costs a vote)
  unsigned all = ~0u;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int k = 0; k < kRays; ++k) all &= on[k] ? __float_as_uint(d[r][k]) : 0x80000000u;
  if (__any_sync(kFullWarp, (int)all >= 0)) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) take_row(q, on, d[r], bq[r], t_min, row0 + r, best, idx);
  }
}

// one row (c, v), table row `row` (call with every lane of the warp)
template <int kForm, unsigned kVel, int kRays>
__device__ __forceinline__ void scan_one(float4 c, float4 v, const SphereRay (&q)[kRays],
                                         const ExpandedRay (&e)[kRays], const bool (&on)[kRays],
                                         float t_min, int row, float (&best)[kRays],
                                         int (&idx)[kRays]) {
  float d[kRays], bq[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) d[k] = row_disc<kForm, kVel>(q[k], e[k], c, v, bq[k]);
  take_row(q, on, d, bq, t_min, row, best, idx);
}

// The conservative slab test of the box (lo.xyz, hi.xyz) on the ray's
// hoisted guarded inverses (a zero direction component becomes 1e-20, which
// errs toward "meets"; ops/intersect.py slab_interval, op for op): the same
// t_near and the same answer (both only ever compared, so a NaN's payload is
// moot; common.cuh min_nan / max_nan)
__device__ __forceinline__ bool slab_staged(float4 lo, float4 hi, const SlabRay& s,
                                            float t_min, float& t_near) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  float t_far = kBig;
  t_near = t_min;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = (l[k] - s.o[k]) * s.inv[k];
    const float tb = (h[k] - s.o[k]) * s.inv[k];
    t_near = max_nan(t_near, min_nan(ta, tb));
    t_far = min_nan(t_far, max_nan(ta, tb));
  }
  return t_far >= t_near;
}

}  // namespace art
