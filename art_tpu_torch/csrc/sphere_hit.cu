// K2 — closest sphere hit with winner attributes, two rays a thread.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_planar
// (_sphere_kernel:45).  Computes, per ray, the closest t > t_min over every
// sphere (center at the ray's shutter time), then the hit's signed-radius
// normal (p - c) / r and material id; a miss writes t = BIG, normal
// (1, 0, 0), material 0.  Plain twin: ops/intersect_kernels.py
// sphere_hit_attrs_plain (= intersect.sphere_candidates_p +
// sphere_attributes_p), whose rules (sphere.cuh) this follows rather than
// the TPU kernel's.
// An optional device count n_live makes every lane at or past *n_live a miss
// (the compacted tail pass of ops/compact_sphere.py, whose needy count stays
// on the device): a block wholly past it writes misses and tests no sphere.
//
// Bound on the H100: FP32 issue — 25 operations a (ray, moving sphere), 19
// a (ray, static sphere); memory traffic is 7 planes in and 5 out a ray.
// Built with -fmad=false for bit equality, so the kernel's own ceiling is
// half the FP32 rate, and the time goes to the instructions issued a
// (ray, sphere) pair.  The design issues as few as the twin's arithmetic
// allows:
//  * the block stages the rows into shared memory repacked as 16-byte
//    float4s, (cx, cy, cz, r2) and (vx, vy, vz, 0), with a byte flag of
//    v != 0, in tiles of kRows rows; every thread reads the same row, so a
//    row is an LDS.128 broadcast of each;
//  * the rows are taken in groups of kGroup, unrolled: a group whose rows
//    are all static takes c as the centre (the twin's c + tm * 0 is c for
//    finite tm, up to the sign of a zero centre, which moves neither t nor
//    the winner) and skips the velocity loads; a group with a moving row
//    takes the twin's c + tm * v on every row.  The test is warp-uniform
//    (every thread reads the same flags);
//  * each thread tests kRays rays (lanes i, i + kThreads, ...) against each
//    staged row, so a shared load serves them all; each ray's operations
//    are the twin's in its order (sphere.cuh sphere_test_at), no FMA, IEEE
//    sqrtf;
//  * the roots are computed only where a lane of the warp may have disc > 0:
//    one vote a group on the AND of its discriminants' bits (a clear sign
//    bit), then a vote a row; the running best carries (t, row index), so
//    the merge is a compare and two selects.  After the loop the winner's
//    centre at tm, r and material come from its global row with the twin's
//    operations (sphere_attributes_p takes them by index too), so the normal
//    keeps its bits;
//  * a block is kSplit parts of kThreads threads over the same rays, each
//    over a part of a tile's groups (the last part also takes the rows past
//    the full groups, one at a time); part 0 then takes another part's
//    winner where it is closer, or as close and earlier (the twin's argmin
//    takes the first row on an exact tie; within a part rows go in table
//    order with a strict `<`).  Two rays a thread halve the warps (R = 2^17:
//    65536 threads), two parts double them again: 512 blocks of 256 threads,
//    3.9 a SM, one wave.  The compacted tail call (with n_live) takes one ray
//    a thread, as its live lanes fill fewer blocks, and a table of fewer than
//    two groups one ray a thread in one part with a tile of its size, as its
//    few rows cannot pay for the parts' merge or a block's 33 KB of tile.

#include "sphere.cuh"

namespace {

constexpr int kThreads = 128;  // threads a part of a block (its rays)
constexpr int kGroup = 8;      // rows a group: one moving test and one vote
constexpr int kRows = 1024;    // rows a shared-memory tile (a multiple of kGroup)
constexpr unsigned kAll = 0xffffffffu;

// the half-b and the discriminant of ray q against the sphere of centre
// (cx, cy, cz) and r2, in sphere_test_at's operations and order
__device__ __forceinline__ float discriminant(const art::SphereRay& q, float cx, float cy,
                                              float cz, float r2, float& bq) {
  const float ocx = q.ox - cx, ocy = q.oy - cy, ocz = q.oz - cz;
  bq = ocx * q.dx + ocy * q.dy + ocz * q.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  return bq * bq - q.a * c;
}

// row s's root replaces (best, idx) where disc > 0 and it is strictly closer
__device__ __forceinline__ void take_root(const art::SphereRay& q, float bq, float disc,
                                          float t_min, int s, float& best, int& idx) {
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float t1 = (-bq - sq) * q.inv_a;
    const float t2 = (-bq + sq) * q.inv_a;
    const float t = t1 > t_min ? t1 : (t2 > t_min ? t2 : art::kBig);
    if (t < best) {
      best = t;
      idx = s;
    }
  }
}

// lane i's output: the winner's centre at tm, radius and material from its
// global row (sphere_attributes_p), or a miss
__device__ __forceinline__ void write_winner(const art::SpherePlanes& p, int i,
                                             const art::SphereRay& q, float best, int idx,
                                             const float* __restrict__ rows) {
  art::SphereBest b = art::no_hit();
  if (best < art::kBig) {
    const float* row = rows + (size_t)idx * art::kSphRow;
    b = art::SphereBest{best, row[0] + q.tm * row[3], row[1] + q.tm * row[4],
                        row[2] + q.tm * row[5], row[6], row[7]};
  }
  art::write_hit(p, i, q, b);
}

// the discriminants and half-b's of a group's rows (sc, sv at its first):
// kMoving, the twin's centre c + tm * v on every row; else c, for a group
// whose rows are all static (c + tm * 0 is c for finite tm, up to the sign
// of a zero, which moves neither t nor the winner)
template <bool kMoving, int kRays>
__device__ __forceinline__ void group_discs(const float4* sc, const float4* sv,
                                            const art::SphereRay (&q)[kRays],
                                            float (&d)[kGroup][kRays],
                                            float (&bq)[kGroup][kRays]) {
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const float4 c = sc[r];
    const float4 v = kMoving ? sv[r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float tm = q[k].tm;
      d[r][k] = kMoving ? discriminant(q[k], c.x + tm * v.x, c.y + tm * v.y, c.z + tm * v.z,
                                       c.w, bq[r][k])
                        : discriminant(q[k], c.x, c.y, c.z, c.w, bq[r][k]);
    }
  }
}

// row s's roots (index s) where a lane of the warp has disc > 0
template <int kRays>
__device__ __forceinline__ void take_row(const art::SphereRay (&q)[kRays],
                                         const float (&d)[kRays], const float (&bq)[kRays],
                                         float t_min, int s, float (&best)[kRays],
                                         int (&idx)[kRays]) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < kRays; ++k) any = any || d[k] > 0.0f;
  if (__any_sync(kAll, any)) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) take_root(q[k], bq[k], d[k], t_min, s, best[k], idx[k]);
  }
}

template <int kRays, int kSplit, int kTile>
__global__ void __launch_bounds__(kThreads * kSplit)
sphere_hit_kernel(const float* __restrict__ rows, int S, int R, float t_min,
                  const int* __restrict__ n_live, art::SpherePlanes p) {
  __shared__ float4 sc[kTile];                    // (cx, cy, cz, r2)
  __shared__ float4 sv[kTile];                    // (vx, vy, vz, 0)
  __shared__ __align__(8) unsigned char mv[kTile];  // 1 where v != 0
  constexpr int kParked = (kSplit > 1 ? kSplit - 1 : 1) * kRays * kThreads;
  __shared__ float part_best[kParked];  // the winners of parts 1.. at their end
  __shared__ int part_idx[kParked];
  const int first = blockIdx.x * (kThreads * kRays);
  const int lane = threadIdx.x % kThreads, part = threadIdx.x / kThreads;
  const int n = n_live ? min(*n_live, R) : R;
  art::SphereRay q[kRays];
  if (first >= n) {  // the whole block misses
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int i = first + k * kThreads + lane;
      if (part == 0 && i < R) art::write_hit(p, i, q[k], art::no_hit());
    }
    return;
  }
  float best[kRays];
  int idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    q[k] = art::load_ray(p, i, i < n);
    best[k] = art::kBig;
    idx[k] = -1;
  }
  for (int base = 0; base < S; base += kTile) {
    const int m = min(kTile, S - base);
    const int groups = m / kGroup;  // full groups; the rows past them one by one
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += kThreads * kSplit) {
      const float* row = rows + (size_t)(base + k) * art::kSphRow;
      const float vx = row[3], vy = row[4], vz = row[5];
      sc[k] = make_float4(row[0], row[1], row[2], row[8]);
      sv[k] = make_float4(vx, vy, vz, 0.0f);
      mv[k] = !(vx == 0.0f && vy == 0.0f && vz == 0.0f);
    }
    __syncthreads();
    for (int g = groups * part / kSplit; g < groups * (part + 1) / kSplit; ++g) {
      const int r0 = g * kGroup;
      float d[kGroup][kRays], bq[kGroup][kRays];
      const uint2 moving = *reinterpret_cast<const uint2*>(mv + r0);  // the rows' flags
      if (moving.x | moving.y)
        group_discs<true>(sc + r0, sv + r0, q, d, bq);
      else
        group_discs<false>(sc + r0, sv + r0, q, d, bq);
      // a disc > 0 has a clear sign bit: the AND of the group's discs has a
      // clear sign bit if one may be > 0 (a +0 or a NaN only costs a vote)
      unsigned all = ~0u;
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
#pragma unroll
        for (int k = 0; k < kRays; ++k) all &= __float_as_uint(d[r][k]);
      if (__any_sync(kAll, (int)all >= 0)) {  // rows in table order, each voted again
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          take_row(q, d[r], bq[r], t_min, base + r0 + r, best, idx);
      }
    }
    // the last part takes the rows past the full groups, one at a time
    for (int r = groups * kGroup; part == kSplit - 1 && r < m; ++r) {
      const float4 c = sc[r], v = sv[r];
      float d[kRays], bq[kRays];
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        const float tm = q[k].tm;
        d[k] = mv[r] ? discriminant(q[k], c.x + tm * v.x, c.y + tm * v.y, c.z + tm * v.z, c.w,
                                    bq[k])
                     : discriminant(q[k], c.x, c.y, c.z, c.w, bq[k]);
      }
      take_row(q, d, bq, t_min, base + r, best, idx);
    }
  }
  // part 0 takes a later part's winner where it is closer, or as close and
  // earlier
  if (part > 0)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      part_best[((part - 1) * kRays + k) * kThreads + lane] = best[k];
      part_idx[((part - 1) * kRays + k) * kThreads + lane] = idx[k];
    }
  __syncthreads();
  if (part > 0) return;
  for (int o = 0; o < kSplit - 1; ++o)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float b = part_best[(o * kRays + k) * kThreads + lane];
      const int j = part_idx[(o * kRays + k) * kThreads + lane];
      if (b < best[k] || (b == best[k] && b < art::kBig && j < idx[k])) {
        best[k] = b;
        idx[k] = j;
      }
    }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    if (i < R) write_winner(p, i, q[k], i < n ? best[k] : art::kBig, idx[k], rows);
  }
}

template <int kRays, int kSplit, int kTile = kRows>
int launch(const float* rows, int S, int R, float t_min, const int* n_live,
           const art::SpherePlanes& p, cudaStream_t stream) {
  const int grid = (R + kThreads * kRays - 1) / (kThreads * kRays);
  if (grid > 0)
    sphere_hit_kernel<kRays, kSplit, kTile>
        <<<grid, kThreads * kSplit, 0, stream>>>(rows, S, R, t_min, n_live, p);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out); all (R,);
// n_live: a device int or null (every lane live)
extern "C" int art_sphere_hit(const float* rows, int S, int R, float t_min,
                              const int* n_live, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (S < 2 * kGroup)  // a few rows: one tile of them
    return launch<1, 1, 2 * kGroup>(rows, S, R, t_min, n_live, p, s);
  return n_live ? launch<1, 2>(rows, S, R, t_min, n_live, p, s)
                : launch<2, 2>(rows, S, R, t_min, n_live, p, s);
}
