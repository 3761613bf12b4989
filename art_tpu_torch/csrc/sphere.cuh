// The sphere kernels' shared parts: one (ray, sphere) candidate with its
// strict-< merge, a ray's terms of the expanded quadratic, the hit's
// output, and spread_hit, K16's scan of a head and segments (sphere_skip.cu),
// a ray tile's segments split across the grid with each block's (lane, row)
// pairs spread over its threads.  K2 (sphere_hit.cu) uses the ray and the
// output; K13 (sphere_static.cu) and K17 (sphere_cellbin.cu, which also runs
// K15's spheres with no head) the ray and the output through their staged
// group scans (sphere_group.cuh).
//
// Rules (those of the plain twins, ops/intersect_kernels.py, not the TPU
// kernels'):
//  * a miss is `disc > 0` strict (the TPU kernels reject by NaN and so
//    accept disc == 0); the near root if > t_min, else the far root;
//  * rows are scanned in table order with a strict `<`, so an exact tie goes
//    to the earlier row, as argmin (spread_hit: the least (t, row) key, the
//    same winner);
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
// art_tpu/ops/pallas_kernels.py:433-443): |o|^2, o.d and 2 o
// (sphere_group.cuh row_disc).
struct ExpandedRay {
  float oo, od, ox2, oy2, oz2;
};

__device__ __forceinline__ ExpandedRay expanded_ray(const SphereRay& q) {
  return ExpandedRay{q.ox * q.ox + q.oy * q.oy + q.oz * q.oz,
                     q.ox * q.dx + q.oy * q.dy + q.oz * q.dz,
                     2.0f * q.ox, 2.0f * q.oy, 2.0f * q.oz};
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

// ---- spread_hit: K16's scan ----
//
// The invariant that frees the order.  The twin (culled_plain) merges the
// head, then each crossed segment in order, with a strict `<`, and each
// segment's closest is its first row among equal t; rows of later segments
// have larger indices.  So its result is the least (t, row index), in that
// lexicographic order, over every row of every segment that the lane's slab
// predicates admit.  Any order of (ray, segment) work that tests exactly
// the same (ray, row) pairs and keeps the least (t, row) is bit-equal to it;
// no appeal to the boxes being conservative is needed.  (An occlusion form,
// K17's or K15's, that bounds a segment by a stale best t admits more rows
// than its twin, whose bound is the running best.  The least (t, row) over
// them is the same only because the boxes are conservative: a row the twin
// passes over lies in a box entered past a t the lane already holds, so its
// own t is larger.  K17, and K15's spheres through it, keep the twin's
// running bound instead.)
//
// The key: order_bits(t) << 32 | row, where order_bits maps a float32 to a
// uint32 that orders like float `<` (both zeros one value: the twin's `<`
// ties them), so unsigned 64-bit `<` is the lexicographic order; the final
// write re-reads the winner's row and recomputes its candidate, so a zero
// t keeps its sign.  kMissKey (t = BIG, row 0xffffffff) is above every
// candidate the twin takes (t < BIG).

constexpr int kSpreadChunk = 64;                      // rows a block stages at a time
constexpr unsigned long long kArrive = 1ull << 32;    // the ticket sum that means "all in"

__device__ __forceinline__ uint32_t order_bits(float t) {
  const uint32_t u = t == 0.0f ? 0u : __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long order_key(float t, uint32_t row) {
  return ((unsigned long long)order_bits(t) << 32) | row;
}

__device__ __forceinline__ unsigned long long miss_key() { return order_key(kBig, 0xffffffffu); }

// a ray's slab inputs: o and its three guarded inverses, hoisted (a zero
// direction component becomes 1e-20, which errs toward "meets"; each the same
// IEEE quotient that ops/intersect.py slab_interval computes per box)
struct SlabRay {
  float o[3], inv[3];
};

// slab_interval's test (t_min, inf) of the box, op for op, on the hoisted
// inverses
__device__ __forceinline__ bool slab_hits(const float* box, const SlabRay& s, float t_min) {
  float t_far = kBig, t_near = t_min;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ta = (__ldg(box + k) - s.o[k]) * s.inv[k];
    const float tb = (__ldg(box + 3 + k) - s.o[k]) * s.inv[k];
    t_near = nan_max(t_near, nan_min(ta, tb));
    t_far = nan_min(t_far, nan_max(ta, tb));
  }
  return t_far >= t_near;
}

// sphere_test_at's candidate t (kBig for none) of a staged row, c = (cx0,
// cy0, cz0, r2) and v = (vx, vy, vz, 0), for a staged ray, o = (ox, oy, oz,
// tm) and d = (dx, dy, dz, a)
__device__ __forceinline__ float staged_t(float4 c, float4 v, float4 o, float4 d, float inv_a,
                                          float t_min) {
  const float cx = c.x + o.w * v.x, cy = c.y + o.w * v.y, cz = c.z + o.w * v.z;
  const float ocx = o.x - cx, ocy = o.y - cy, ocz = o.z - cz;
  const float bq = ocx * d.x + ocy * d.y + ocz * d.z;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w;
  const float disc = bq * bq - d.w * cc;
  if (!(disc > 0.0f)) return kBig;
  const float sq = sqrtf(disc);
  const float t1 = (-bq - sq) * inv_a;
  const float t2 = (-bq + sq) * inv_a;
  return t1 > t_min ? t1 : (t2 > t_min ? t2 : kBig);
}

constexpr int kIlp = 4;  // rows a thread of spread_hit tests at once

// K16's scan (the head and segments of culled_plain without the occlusion
// bound, the same predicates), one launch of (R / kBlock tiles) x G blocks, G = 1 +
// ceil(n_seg / kBins), block b taking tile b / G and group b % G:
//  * group 0 is the head: every live lane of the tile tests the head rows
//    [0, n_head); group g >= 1 takes bins (g - 1) kBins + 1 .. g kBins in
//    turn, each tested by the lanes whose slab tests of the union box and
//    of the bin pass.  A bin with no such lane is passed over at once
//    (uniformly, by __syncthreads_or);
//  * for a bin, the block compacts its testing lanes (their rays into
//    shared memory), stages the rows kSpreadChunk at a time, and gives each
//    testing lane kBlock / lanes threads, each taking every such row of a
//    chunk, kIlp at a time, with the lane's ray in registers and its best
//    (t, row) kept with a strict `<` in row order; each thread's best goes
//    to its lane's least order_key in shared memory (64-bit atomicMin);
//  * a head block whose tile has no testing lane in any bin (W = 0 below)
//    writes the tile's hits from those keys itself.  Otherwise each block
//    that tested a row puts its lanes' keys into keys[i] in global memory
//    (atomicMin), and the last of them to finish writes t, the normal and
//    the material from the winner's row and resets the tile's keys and
//    ticket for the next call.  It learns that it is last from a ticket
//    taken after __threadfence(): the head block adds kArrive - W, W the
//    groups with a testing lane (the head evaluates their predicates too),
//    each such group's block adds 1, so the sum reaches kArrive at the last
//    arrival and never before; a group with no testing lane takes none;
//  * lanes at or past *n_live (when given) are misses; a tile wholly past
//    it is written as misses by its head block, and no key of it is
//    touched.
// keys (>= R, each kMissKey) and tickets (>= R / kBlock tiles, each 0)
// are a scratch that every call leaves as it found it (the wrapper keeps
// it across calls on one stream).
template <int kBins>
__device__ __forceinline__ void spread_hit(const float* __restrict__ rows,
                                           const float* __restrict__ seg, int n_seg,
                                           int n_head, int R, float t_min,
                                           const int* __restrict__ n_live,
                                           unsigned long long* keys,
                                           unsigned long long* tickets,
                                           const SpherePlanes& p) {
  __shared__ float4 s_o[kBlock], s_d[kBlock];  // (ox, oy, oz, tm), (dx, dy, dz, a)
  __shared__ float s_inv_a[kBlock];
  __shared__ float4 s_row[kSpreadChunk][2];  // (cx0, cy0, cz0, r2), (vx, vy, vz, 0)
  __shared__ unsigned long long s_key[kBlock];  // a lane's least key
  __shared__ int s_lane[kBlock];                // the testing lanes, compacted
  __shared__ int s_warp[kBlock / 32];
  __shared__ int s_last;
  const int G = 1 + (n_seg + kBins - 1) / kBins;
  const int tile = blockIdx.x / G, k = blockIdx.x - tile * G;
  const int n = n_live ? min(*n_live, R) : R;
  const int base = tile * kBlock;
  const int i = base + threadIdx.x;
  if (base >= n) {  // the tile misses whole
    if (k == 0 && i < R) write_hit(p, i, load_ray(p, i, false), no_hit());
    return;
  }
  const bool live = i < n;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f;
  const float dz = live ? p.dz[i] : 1.f;
  SlabRay sr;  // o and the guarded inverses of d
  sr.o[0] = live ? p.ox[i] : 0.f;
  sr.o[1] = live ? p.oy[i] : 0.f;
  sr.o[2] = live ? p.oz[i] : 0.f;
  {
    const float d[3] = {dx, dy, dz};
#pragma unroll
    for (int c = 0; c < 3; ++c) sr.inv[c] = 1.0f / (d[c] == 0.0f ? 1e-20f : d[c]);
  }
  const bool needy = live && slab_hits(seg + 2, sr, t_min);
  int W = 0;  // the head: the groups with a testing lane
  if (k == 0)
    for (int g = 1; g < G; ++g) {
      bool any = false;
      for (int b = (g - 1) * kBins + 1; needy && b <= min(n_seg, g * kBins); ++b)
        any = any || slab_hits(seg + (size_t)b * kSegRow + 2, sr, t_min);
      W += __syncthreads_or(any) ? 1 : 0;
    }
  s_key[threadIdx.x] = miss_key();
  bool took = false;
  const int b1 = k == 0 ? 1 : min(n_seg, k * kBins) + 1;
  for (int b = k == 0 ? 0 : (k - 1) * kBins + 1; b < b1; ++b) {
    bool cross;
    int r0 = 0, r1 = n_head;
    if (b == 0) {
      cross = live && n_head > 0;
    } else {
      const float* m = seg + (size_t)b * kSegRow;
      cross = needy && slab_hits(m + 2, sr, t_min);
      r0 = (int)__ldg(m);
      r1 = (int)__ldg(m + 1);
    }
    if (!__syncthreads_or(cross)) continue;  // uniform
    took = true;
    const unsigned ballot = __ballot_sync(kFullWarp, cross);
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    if (l == 0) s_warp[w] = __popc(ballot);
    __syncthreads();
    int off = 0, nc = 0;
#pragma unroll
    for (int x = 0; x < kBlock / 32; ++x) {
      const int c = s_warp[x];
      off += x < w ? c : 0;
      nc += c;
    }
    if (cross) {  // sphere.cuh load_ray's tm, a and 1 / a
      const int j = off + __popc(ballot & ((1u << l) - 1u));
      const float a = dx * dx + dy * dy + dz * dz;
      s_o[j] = make_float4(sr.o[0], sr.o[1], sr.o[2], p.tm[i]);
      s_d[j] = make_float4(dx, dy, dz, a);
      s_inv_a[j] = 1.0f / a;
      s_lane[j] = threadIdx.x;
    }
    // each testing lane j gets hn = kBlock / nc threads (thread j + nc h,
    // h < hn), thread h taking the rows h, h + hn, ... of each chunk
    const int hn = kBlock / nc;
    const int j = threadIdx.x % nc, h = threadIdx.x / nc;
    float4 ro = make_float4(0.f, 0.f, 0.f, 0.f), rd = ro;
    float rinv = 0.f, bt = kBig;
    int brow = 0;
    for (int c0 = r0; c0 < r1; c0 += kSpreadChunk) {
      const int cn = min(kSpreadChunk, r1 - c0);
      __syncthreads();  // the rays are in, the last chunk's rows read
      if (threadIdx.x < cn) {
        const float* row = rows + (size_t)(c0 + threadIdx.x) * kSphRow;
        s_row[threadIdx.x][0] = make_float4(row[0], row[1], row[2], row[8]);
        s_row[threadIdx.x][1] = make_float4(row[3], row[4], row[5], 0.0f);
      }
      __syncthreads();
      if (c0 == r0) {
        ro = s_o[j];
        rd = s_d[j];
        rinv = s_inv_a[j];
      }
      if (h < hn) {
        for (int r = h; r < cn; r += kIlp * hn) {
          float tt[kIlp];
#pragma unroll
          for (int u = 0; u < kIlp; ++u) {
            const int ru = min(r + u * hn, cn - 1);
            tt[u] = staged_t(s_row[ru][0], s_row[ru][1], ro, rd, rinv, t_min);
          }
#pragma unroll
          for (int u = 0; u < kIlp; ++u)
            if (r + u * hn < cn && tt[u] < bt) {
              bt = tt[u];
              brow = c0 + r + u * hn;
            }
        }
      }
    }
    if (h < hn && bt < kBig) atomicMin(&s_key[s_lane[j]], order_key(bt, (uint32_t)brow));
    __syncthreads();  // the keys in; s_o, s_lane and s_warp free for the next bin
  }
  if (k != 0 && !took) return;  // uniform; the head counted no ticket for it
  __syncthreads();  // the keys in (a head with no row to test)
  unsigned long long key = s_key[threadIdx.x];
  const bool alone = k == 0 && W == 0;  // the head's keys are the tile's
  if (!alone) {
    if (key != miss_key()) atomicMin(&keys[i], key);
    __threadfence();  // the keys before the ticket
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long add = k == 0 ? kArrive - (unsigned long long)W : 1ull;
      s_last = atomicAdd(&tickets[tile], add) + add == kArrive;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();  // the ticket before the keys
    if (i < R) {
      key = *(volatile unsigned long long*)(keys + i);
      keys[i] = miss_key();
    }
    if (threadIdx.x == 0) tickets[tile] = 0;
  }
  if (i < R) {
    const SphereRay q = load_ray(p, i, live);
    SphereBest bw = no_hit();
    if (key != miss_key()) sphere_test(rows + (size_t)(uint32_t)key * kSphRow, q, t_min, bw);
    write_hit(p, i, q, bw);
  }
}

}  // namespace art
