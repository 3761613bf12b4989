// K15, boxes — closest oriented-box hit with the boxes in BVH-leaf clusters,
// one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:box_hit_attrs_clustered (:2601;
// _box_cluster_kernel:2482).  The table (scene/cull.py cluster_tables) is
// box_rows in the leaf order of a BVH over the boxes' world AABBs (their 8
// rotated corners; ops/bvh.py), cut into clusters of 64 rows (the last one
// shorter, no inert padding rows); the metadata `seg` is (1 + n_clusters, 8)
// floats: row 0 (0, 0, the clusters' union box), then (row0, row1, box) per
// cluster, each box art_tpu's box_cl_box bit for bit.  Per ray: the guarded
// inverses of the world direction; when art_tpu's bounded cluster test of
// the union box passes, each cluster whose test passes against the running
// best t (`max(t0, t_min) <= min(t1, best)`, :2563, with NaN-propagating
// max / min as the twin's torch.maximum), the cluster's rows scanned with
// K6's candidate (box_attrs.cuh slab_candidate) and merged with a strict
// `<`, keeping the winner's row; then K6's winner attributes once
// (write_box_hit).  The union-box pre-test is not in art_tpu's kernel: a
// ray that passes a cluster's test passes the union's (the slab arithmetic
// is monotone in the box bounds), so it changes no result.  The boxes are
// rounded to nearest, so the test is conservative only to half an ulp.
// Both forms are templates, as K6's: kRotated (the rays in each box's frame)
// and the folded axis-aligned one.  Output (t, normal x3, u, v, mat) as K6;
// the plain twin is ops/intersect_kernels.py box_cluster_hit_attrs_plain.
//
// Bound on the H100: operations, ~40-55 a (ray, box) test that the rays'
// clusters need (the bytes, 6 planes in and 7 out a ray, bound it only on a
// pool that mostly misses the clusters).
// Design: the order is the twin's, lane by lane (each cluster in table
// order, its test bounded by the lane's running best), and the warp is the
// skip unit (it scans a cluster when a lane of it passes the cluster's
// test; a lane that does not keeps its best, the twin's per-lane mask), as
// K17 (sphere_cellbin.cu).  The earlier form read each row as scalar
// __ldg's and each cluster's box as six; nvcc had already hoisted the
// folded form's divisions, so a pair cost ~37 SASS instructions folded and
// ~87 rotated, and the time was the warps' row scans.  Here:
//  * a block stages the rows into shared memory kTile at a time as the
//    row's three float4s (min and max.x; max.yz, cos, sin; off, mat), so a
//    row is two LDS.128 broadcasts in the folded form and three in the
//    rotated one, and the boxes and row ranges of the first kMaxClusters
//    clusters beside them (a later cluster's from global memory);
//  * the ray's three guarded inverses are computed once: in the folded form
//    they are the very quotients K6's candidate divides out a pair, and in
//    the rotated form the frame keeps dy, so the y inverse is too (x and z
//    are divided a pair, as the twin does); a cluster's test is two LDS.128
//    and min / max that propagate NaN in one instruction;
//  * the folded form splits a cluster's scan into groups of kGroup rows,
//    each with a box made when its tile is staged, and a warp takes a
//    group's rows only where a lane passes the bounded test of that box
//    (exact: scan_cluster's note);
//  * the scan carries (t, row) only, and the winner's attributes are
//    computed once from its row; a block no lane of which passes the union
//    box's test stages nothing.
// Measured on an H100 (PERF.md §6), 2^17-ray pools: final_scene's 400-box
// field ~0.053 ms (the earlier form 0.097), a 1600-box field 0.063 (0.178),
// 144 rotated boxes 0.063 (0.073).  Without the groups the folded form took
// 0.075 at 62 registers; unbounded, the groups' unrolled scan took 159
// registers and ran no faster than without them.  Two rays a thread, a warp
// vote on the y slab before the rotated form's divisions, groups of 4 or
// 16 rows, and caps of 48, 40 or 80 registers were slower on some pool and
// faster on none but one (16-row groups on the 1600-box field).

#include "box_attrs.cuh"

namespace {

constexpr int kTile = 512;         // rows a shared-memory tile (24 KB of float4s)
constexpr int kMaxClusters = 64;   // clusters whose boxes and ranges a block stages
constexpr int kGroup = 8;          // rows a group of the folded form's vote
constexpr int kSegRow = 8;         // floats a segment row: row0 row1 box(6)
// rays a thread.  The lane's ray, flags and carry are arrays of one, as K17's
// (sphere_group.cuh): at the 64-register cap ptxas spilled the same code
// written with scalars, and not this form.
constexpr int kRays = 1;

struct ClusterRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // o, d and d's guarded inverses
};

// art_tpu's bounded cluster test of the box (lo.xyz, hi.xyz) on the hoisted
// inverses (ops/intersect.py cluster_slab); only ever compared, so a NaN's
// payload is moot
__device__ __forceinline__ bool cluster_test(float4 lo, float4 hi, const ClusterRay& q,
                                             float t_min, float best) {
  const float tax = (lo.x - q.ox) * q.ix, tbx = (hi.x - q.ox) * q.ix;
  const float tay = (lo.y - q.oy) * q.iy, tby = (hi.y - q.oy) * q.iy;
  const float taz = (lo.z - q.oz) * q.iz, tbz = (hi.z - q.oz) * q.iz;
  const float t0 = art::max_nan(art::max_nan(art::min_nan(tax, tbx), art::min_nan(tay, tby)),
                                art::min_nan(taz, tbz));
  const float t1 = art::min_nan(art::min_nan(art::max_nan(tax, tbx), art::max_nan(tay, tby)),
                                art::max_nan(taz, tbz));
  return art::max_nan(t0, t_min) <= art::min_nan(t1, best);
}

// K6's candidate (box_test) of the staged row (a, b, c) = (min, max.x),
// (max.yz, cos, sin), (off, mat) on the hoisted inverses
template <bool kRotated>
__device__ __forceinline__ float staged_test(float4 a, float4 b, float4 c, const ClusterRay& q,
                                             float t_min) {
  if (!kRotated)
    return art::slab_candidate(a.x, a.y, a.z, a.w, b.x, b.y, q.ox, q.oy, q.oz, q.ix, q.iy,
                               q.iz, t_min);
  float lox, loy, loz, ldx, ldy, ldz;
  art::to_box_frame<true>(b.z, b.w, c.x, c.y, c.z, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, lox,
                          loy, loz, ldx, ldy, ldz);
  return art::slab_candidate(a.x, a.y, a.z, a.w, b.x, b.y, lox, loy, loz, art::safe_inv(ldx),
                             q.iy, art::safe_inv(ldz), t_min);
}

// staged row r (tile row s) for the lanes `on`: a strict `<` into the
// (t, row) carry
template <bool kRotated>
__device__ __forceinline__ void take_row(int r, int s, const float4* st,
                                         const ClusterRay (&q)[kRays], const bool (&on)[kRays],
                                         float t_min, float (&best)[kRays], int (&idx)[kRays]) {
  const float4* g = st + 3 * s;
  const float4 a = g[0], b = g[1];
  const float4 c = kRotated ? g[2] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const float t = staged_test<kRotated>(a, b, c, q[j], t_min);
    if (on[j] && t < best[j]) {
      best[j] = t;
      idx[j] = r;
    }
  }
}

// rows [lo, hi) of the staged tile at `base` for the lanes `on` (call with
// every lane of the warp).  The folded form goes by the aligned groups of
// kGroup rows that overlap them, taking a group's rows only where a lane of
// the warp passes the bounded cluster test of the group's box (sg: the min
// and max of its rows' bounds, so a row that a lane would take lies in it
// at a t that the test admits, and skipping the group changes nothing).
template <bool kRotated>
__device__ __forceinline__ void scan_cluster(int lo, int hi, int base, const float4* st,
                                             const float4* sg, const ClusterRay (&q)[kRays],
                                             const bool (&on)[kRays], float t_min,
                                             float (&best)[kRays], int (&idx)[kRays]) {
  if (!kRotated) {
    for (int g = lo & ~(kGroup - 1); g < hi; g += kGroup) {
      const int s = g - base;  // base is a multiple of kGroup
      bool pass = false;
#pragma unroll
      for (int j = 0; j < kRays; ++j)
        pass = pass || (on[j] && cluster_test(sg[2 * (s / kGroup)], sg[2 * (s / kGroup) + 1],
                                              q[j], t_min, best[j]));
      if (!__any_sync(art::kFullWarp, pass)) continue;
      const int r0 = max(g, lo), r1 = min(g + kGroup, hi);
      if (r1 - r0 == kGroup) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          take_row<kRotated>(g + u, s + u, st, q, on, t_min, best, idx);
      } else {
        for (int r = r0; r < r1; ++r)
          take_row<kRotated>(r, r - base, st, q, on, t_min, best, idx);
      }
    }
    return;
  }
#pragma unroll 4
  for (int r = lo; r < hi; ++r) take_row<kRotated>(r, r - base, st, q, on, t_min, best, idx);
}

// cluster k's row range and box: staged for k <= kMaxClusters, else from `seg`
__device__ __forceinline__ int2 cluster_range(int k, const int2* srange,
                                              const float* __restrict__ seg) {
  if (k <= kMaxClusters) return srange[k];
  const float* m = seg + (size_t)k * kSegRow;
  return make_int2((int)__ldg(m), (int)__ldg(m + 1));
}

__device__ __forceinline__ void cluster_box(int k, const float4* sbox,
                                            const float* __restrict__ seg, float4& lo,
                                            float4& hi) {
  if (k <= kMaxClusters) {
    lo = sbox[2 * k];
    hi = sbox[2 * k + 1];
    return;
  }
  const float* m = seg + (size_t)k * kSegRow;
  lo = make_float4(__ldg(m + 2), __ldg(m + 3), __ldg(m + 4), 0.0f);
  hi = make_float4(__ldg(m + 5), __ldg(m + 6), __ldg(m + 7), 0.0f);
}

// at most 64 registers: four blocks an SM (nvcc takes 76 in the rotated form
// and, with the folded form's unrolled groups, 159 unbounded)
template <bool kRotated>
__global__ void __launch_bounds__(art::kBlock, 4)
box_cluster_kernel(const float* __restrict__ rows, const float* __restrict__ seg, int n_seg,
                   int R, float t_min, art::BoxPlanes p) {
  __shared__ float4 st[3 * kTile];                          // a row's three float4s
  __shared__ float4 sg[!kRotated ? 2 * kTile / kGroup : 1];  // the folded groups' boxes
  __shared__ float4 sbox[2 * (kMaxClusters + 1)];           // (x0, y0, z0, .), (x1, y1, z1, .)
  __shared__ int2 srange[kMaxClusters + 1];                 // (row0, row1)
  ClusterRay q[kRays];
  bool live[kRays], needy[kRays], cross[kRays];
  float best[kRays];
  int idx[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = (blockIdx.x * kRays + j) * art::kBlock + threadIdx.x;
    live[j] = i < R;
    q[j].ox = live[j] ? p.ox[i] : 0.f;
    q[j].oy = live[j] ? p.oy[i] : 0.f;
    q[j].oz = live[j] ? p.oz[i] : 0.f;
    q[j].dx = live[j] ? p.dx[i] : 0.f;
    q[j].dy = live[j] ? p.dy[i] : 0.f;
    q[j].dz = live[j] ? p.dz[i] : 1.f;
    q[j].ix = art::safe_inv(q[j].dx);
    q[j].iy = art::safe_inv(q[j].dy);
    q[j].iz = art::safe_inv(q[j].dz);
    best[j] = art::kBig;
    idx[j] = -1;
    cross[j] = false;
  }
  for (int k = threadIdx.x; k <= min(n_seg, kMaxClusters); k += art::kBlock) {
    const float* m = seg + (size_t)k * kSegRow;
    srange[k] = make_int2((int)m[0], (int)m[1]);
    sbox[2 * k] = make_float4(m[2], m[3], m[4], 0.0f);
    sbox[2 * k + 1] = make_float4(m[5], m[6], m[7], 0.0f);
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    needy[j] = live[j] && cluster_test(sbox[0], sbox[1], q[j], t_min, art::kBig);
    any = any || needy[j];
  }
  const bool warp_needy = __any_sync(art::kFullWarp, any);
  if (__syncthreads_or(any)) {  // block-uniform
    const int n_rows = n_seg > 0 ? (int)__ldg(seg + (size_t)n_seg * kSegRow + 1) : 0;
    const float4* g = reinterpret_cast<const float4*>(rows);
    bool scan = false;
    int k = 1;  // the next cluster
    for (int base = 0; base < n_rows; base += kTile) {
      const int m = min(kTile, n_rows - base);
      __syncthreads();  // the last tile read
      for (int r = threadIdx.x; r < m; r += art::kBlock) {
        const float4* row = g + 3 * (size_t)(base + r);
        st[3 * r] = row[0];
        st[3 * r + 1] = row[1];
        if (kRotated) st[3 * r + 2] = row[2];
      }
      __syncthreads();
      if (!kRotated) {  // each group's box: its rows' min and max bounds
        for (int h = threadIdx.x; h * kGroup < m; h += art::kBlock) {
          float4 lo = st[3 * h * kGroup], hi = make_float4(lo.w, st[3 * h * kGroup + 1].x,
                                                           st[3 * h * kGroup + 1].y, 0.f);
          for (int r = h * kGroup + 1; r < min(m, (h + 1) * kGroup); ++r) {
            const float4 a = st[3 * r], b = st[3 * r + 1];
            lo = make_float4(fminf(lo.x, a.x), fminf(lo.y, a.y), fminf(lo.z, a.z), 0.f);
            hi = make_float4(fmaxf(hi.x, a.w), fmaxf(hi.y, b.x), fmaxf(hi.z, b.y), 0.f);
          }
          sg[2 * h] = lo;
          sg[2 * h + 1] = hi;
        }
        __syncthreads();
      }
      if (!warp_needy) continue;  // warp-uniform; every thread reaches the barriers
      for (; k <= n_seg; ++k) {
        const int2 rr = cluster_range(k, srange, seg);
        if (rr.x >= base + m) break;  // starts in a later tile
        if (rr.x >= base) {  // opens here: its bound is the lane's running best
          float4 lo, hi;
          cluster_box(k, sbox, seg, lo, hi);
          bool a = false;
#pragma unroll
          for (int j = 0; j < kRays; ++j) {
            cross[j] = needy[j] && cluster_test(lo, hi, q[j], t_min, best[j]);
            a = a || cross[j];
          }
          scan = __any_sync(art::kFullWarp, a);
        }
        if (scan)
          scan_cluster<kRotated>(max(rr.x, base), min(rr.y, base + m), base, st, sg, q, cross,
                                 t_min, best, idx);
        if (rr.y > base + m) break;  // goes on in the next tile
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    if (!live[j]) continue;
    const int i = (blockIdx.x * kRays + j) * art::kBlock + threadIdx.x;
    const float* r = idx[j] < 0 ? nullptr : rows + (size_t)idx[j] * art::kBoxRow;
    art::write_box_hit<kRotated>(p, i, r, best[j], q[j].ox, q[j].oy, q[j].oz, q[j].dx,
                                 q[j].dy, q[j].dz);
  }
}

}  // namespace

// rows: (N, 12), 16-byte aligned; seg: (1 + n_seg, 8); planes as art_box_hit
extern "C" int art_box_cluster(const float* rows, const float* seg, int n_seg, int R,
                               float t_min, int rotated, void* const* planes, void* stream) {
  if (reinterpret_cast<uintptr_t>(rows) % 16) return (int)cudaErrorMisalignedAddress;
  const art::BoxPlanes p = art::box_planes(planes);
  const int per_block = art::kBlock * kRays;
  const int grid = (R + per_block - 1) / per_block;
  if (grid > 0) {
    if (rotated)
      box_cluster_kernel<true><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, seg, n_seg, R, t_min, p);
    else
      box_cluster_kernel<false><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, seg, n_seg, R, t_min, p);
  }
  return (int)cudaGetLastError();
}
