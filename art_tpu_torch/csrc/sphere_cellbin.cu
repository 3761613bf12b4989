// K17 — closest sphere hit with the spheres in lattice cells, pruned by an
// occlusion bound, one thread per ray; with no head, K15's spheres.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_cellbin_hit_attrs
// (_sphere_cellbin_kernel:1613) and, called with n_head = 0 on K15's cluster
// table, sphere_hit_attrs_clustered (:896; _sphere_cluster_kernel:778).
// K17's table (scene/cull.py) is the head rows, then the cells of a
// lattice, each a contiguous row range: the whole sphere set in a 4x4
// lattice over its two largest extents (bouncing_spheres; the ground sphere
// and any sphere spanning more than 1.5 cells stay in the head), or a tail
// cluster in a 3x3x3 lattice (final_scene, original_scene).  K15's
// (scene/cull.py cluster_tables) is sphere_rows in the leaf order of a BVH
// over the spheres' swept boxes, cut into clusters of 64 rows (the last one
// shorter), with no head: its clusters are the cells.  The metadata `seg` is
// (1 + n_cells, 8) floats: row 0 (0, n_head, the union box of the cells),
// then (row0, row1, box) per cell.  Per ray: the closest hit over the head
// rows; then, when the ray crosses the union box at t_near <= its best t,
// each cell that it crosses at t_near <= its running best t (the occlusion
// bound of art_tpu's _slab_interval_tmax:1596, and of its cluster kernel's
// `max(t0, t_min) <= min(t1, best_t)`, :857), the cell's closest merged with
// a strict `<`.  Outputs and rules are K2's (sphere.cuh); the plain twins are
// ops/intersect_kernels.py sphere_cellbin_hit_attrs_plain and
// sphere_cluster_hit_attrs_plain, both culled_plain with the occlusion bound
// (K15's with no head).  For K15 the union box is a pre-test that art_tpu's
// kernel does not have: a ray that crosses a cluster's box crosses the union
// (the slab arithmetic is monotone in the box bounds), so it changes no
// result; the slab guard (a zero direction component becomes 1e-20) is
// art_tpu's 1e-12 elsewhere, both erring toward "crosses", so neither
// changes a result but at a box's rounding edge (half an ulp).
//
// Bound on the H100: FP32 throughput, ~25 flops per (ray, sphere) tested: R x
// head rows, plus each cell's rows x the rays whose bounded slab test
// passes; on bouncing_spheres' and final_scene's pools the bytes (7 planes
// in and 5 out a ray) bound it.
// Design: the earlier form (one thread a ray reading rows from global
// memory) read each row as nine scalar __ldg's, took a root under a per-lane
// branch into a six-value carry, and ran a slab test of every cell with six
// loads and three divisions a lane; a test cost 6-32x K2's.  Here the order
// is the twin's, lane by lane (the head, then each cell in order, its bound
// the lane's running best), and the warp stays the skip unit (it scans a
// cell when a lane of it crosses the cell), but the work a test is K2's:
//  * a block stages the table into shared memory once, kStage rows a tile,
//    as K2's float4 pairs (cx, cy, cz, r2) and (vx, vy, vz, 0) with a byte
//    flag of v != 0, and the boxes and row ranges of the first kMaxCells
//    cells beside them; a later cell's (a K15 table of more than
//    kMaxCells x 64 spheres) is read from global memory when the scan
//    reaches it, in the kernel's kMany instance, so any number of cells
//    is taken;
//  * a crossed cell is scanned with K2's group structure
//    (sphere_group.cuh): groups of eight rows, a warp vote on the
//    discriminants before any root, a (t, row) carry, a group with no
//    moving row on c (one ballot of its flags); the winner's attributes are
//    read from its row after the scan (sphere_attributes_p's operations);
//  * the ray's three guarded inverses are computed once, and a cell's slab
//    test is two LDS.128 of its box and min/max that propagate NaN as
//    torch's do (slab_staged: the same t_near and answer as
//    slab_interval).
// Row indices ride in `seg` as float32, exact below 2^24 rows.
// Measured on an H100 (PERF.md §6), a 2^17-ray pool takes ~0.037 ms on
// bouncing_spheres' and final_scene's tables: ~6 us of the rays' loads and
// stores, 3-5 us of staging and the head, 5-8 us of cell slabs and 19-23 us
// of cell scans, set by the warps' uneven work (a warp scans 56 or 29 rows
// on average, the heaviest 279 or 458) and by the warp as the skip unit
// (1.9x and 4.4x the tests the rays need).  Two or four warps a ray (their
// carries merged at a named barrier after each cell), two rays a thread,
// and spread_hit with the bound read stale from its keys were all slower.
// K16 runs sphere.cuh spread_hit.

#include "sphere_group.cuh"

namespace {

constexpr int kStage = 1024;   // rows a shared-memory tile
constexpr int kMaxCells = 64;  // cells whose boxes and ranges a block stages

// rows [lo, hi) of the staged tile at `base` for the lanes `on` (call with
// every lane of the warp): full groups, then the rows past them one by one
__device__ __forceinline__ void scan_range(int lo, int hi, int base, const float4* sc,
                                           const float4* sv, const unsigned char* mv,
                                           const art::SphereRay (&q)[1],
                                           const art::ExpandedRay (&e)[1],
                                           const bool (&on)[1], float t_min, float (&best)[1],
                                           int (&idx)[1]) {
  const int lane = threadIdx.x & 31;
  int r = lo;
  for (; r + art::kGroup <= hi; r += art::kGroup) {
    const int s = r - base;
    const bool moving =
        __ballot_sync(art::kFullWarp, lane < art::kGroup && mv[s + min(lane, art::kGroup - 1)]);
    if (moving)
      art::scan_group<art::kMovingRow, 7u, 1>(sc + s, sv + s, q, e, on, t_min, r, best, idx);
    else
      art::scan_group<art::kDirectRow, 0u, 1>(sc + s, sv + s, q, e, on, t_min, r, best, idx);
  }
  for (; r < hi; ++r) {
    const int s = r - base;
    if (mv[s])
      art::scan_one<art::kMovingRow, 7u, 1>(sc[s], sv[s], q, e, on, t_min, r, best, idx);
    else
      art::scan_one<art::kDirectRow, 0u, 1>(sc[s], sv[s], q, e, on, t_min, r, best, idx);
  }
}

// cell k's row range and box: staged for k <= kMaxCells, else (kMany) from
// `seg`
template <bool kMany>
__device__ __forceinline__ int2 cell_range(int k, const int2* srange,
                                           const float* __restrict__ seg) {
  if (!kMany || k <= kMaxCells) return srange[k];
  const float* m = seg + (size_t)k * art::kSegRow;
  return make_int2((int)__ldg(m), (int)__ldg(m + 1));
}

template <bool kMany>
__device__ __forceinline__ void cell_box(int k, const float4* sbox, const float* __restrict__ seg,
                                         float4& lo, float4& hi) {
  if (!kMany || k <= kMaxCells) {
    lo = sbox[2 * k];
    hi = sbox[2 * k + 1];
    return;
  }
  const float* m = seg + (size_t)k * art::kSegRow;
  lo = make_float4(__ldg(m + 2), __ldg(m + 3), __ldg(m + 4), 0.0f);
  hi = make_float4(__ldg(m + 5), __ldg(m + 6), __ldg(m + 7), 0.0f);
}

// kMany: a table of more than kMaxCells cells (its own instance, so that
// the tables that fit keep the code without the fallback)
template <bool kMany>
__global__ void __launch_bounds__(art::kBlock)
sphere_cellbin_kernel(const float* __restrict__ rows, const float* __restrict__ seg,
                      int n_seg, int n_head, int R, float t_min, art::SpherePlanes p) {
  __shared__ float4 sc[kStage];  // (cx, cy, cz, r2)
  __shared__ float4 sv[kStage];  // (vx, vy, vz, 0)
  __shared__ unsigned char mv[kStage];  // 1 where v != 0
  __shared__ float4 sbox[2 * (kMaxCells + 1)];  // (x0, y0, z0, .), (x1, y1, z1, .)
  __shared__ int2 srange[kMaxCells + 1];        // (row0, row1)
  const int i = blockIdx.x * art::kBlock + threadIdx.x;
  const bool live[1] = {i < R};
  const art::SphereRay q[1] = {art::load_ray(p, i, live[0])};
  const art::ExpandedRay e[1] = {art::ExpandedRay{0.f, 0.f, 0.f, 0.f, 0.f}};  // unused
  art::SlabRay s;  // o and the guarded inverses of d, once
  s.o[0] = q[0].ox; s.o[1] = q[0].oy; s.o[2] = q[0].oz;
  {
    const float d[3] = {q[0].dx, q[0].dy, q[0].dz};
#pragma unroll
    for (int c = 0; c < 3; ++c) s.inv[c] = 1.0f / (d[c] == 0.0f ? 1e-20f : d[c]);
  }
  for (int k = threadIdx.x; k <= min(n_seg, kMaxCells); k += art::kBlock) {
    const float* m = seg + (size_t)k * art::kSegRow;
    srange[k] = make_int2((int)m[0], (int)m[1]);
    sbox[2 * k] = make_float4(m[2], m[3], m[4], 0.0f);
    sbox[2 * k + 1] = make_float4(m[5], m[6], m[7], 0.0f);
  }
  const int n_rows = n_seg > 0 ? (int)__ldg(seg + (size_t)n_seg * art::kSegRow + 1) : n_head;
  float best[1] = {art::kBig};
  int idx[1] = {-1};
  bool needy = false, opened = false, scan = false;
  bool cross[1] = {false};
  const bool warp_live = __any_sync(art::kFullWarp, live[0]);
  int k = 1;  // the next cell
  for (int base = 0; base < n_rows; base += kStage) {
    const int m = min(kStage, n_rows - base);
    __syncthreads();  // the boxes in; the last tile read
    for (int r = threadIdx.x; r < m; r += art::kBlock) {
      const float* row = rows + (size_t)(base + r) * art::kSphRow;
      const float vx = row[3], vy = row[4], vz = row[5];
      sc[r] = make_float4(row[0], row[1], row[2], row[8]);
      sv[r] = make_float4(vx, vy, vz, 0.0f);
      mv[r] = !(vx == 0.0f && vy == 0.0f && vz == 0.0f);
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform; every thread reaches the barriers
    const int h1 = min(n_head, base + m);
    if (base < h1) scan_range(base, h1, base, sc, sv, mv, q, e, live, t_min, best, idx);
    if (!opened && n_head <= base + m) {  // the head done: the union box's gate
      opened = true;
      float t_near;
      needy = live[0] && art::slab_staged(sbox[0], sbox[1], s, t_min, t_near) &&
              t_near <= best[0];
    }
    for (; k <= n_seg; ++k) {
      const int2 rr = cell_range<kMany>(k, srange, seg);
      if (rr.x >= base + m) break;  // starts in a later tile
      if (rr.x >= base) {  // opens here: its bound is the lane's running best
        float4 lo, hi;
        cell_box<kMany>(k, sbox, seg, lo, hi);
        float t_near;
        cross[0] = needy && art::slab_staged(lo, hi, s, t_min, t_near) && t_near <= best[0];
        scan = __any_sync(art::kFullWarp, cross[0]);
      }
      if (scan)
        scan_range(max(rr.x, base), min(rr.y, base + m), base, sc, sv, mv, q, e, cross, t_min,
                   best, idx);
      if (rr.y > base + m) break;  // goes on in the next tile
    }
  }
  if (!live[0]) return;
  art::SphereBest b = art::no_hit();
  if (best[0] < art::kBig) {  // the winner's row (sphere_attributes_p)
    const float* row = rows + (size_t)idx[0] * art::kSphRow;
    const float tm = q[0].tm;
    b = art::SphereBest{best[0], row[0] + tm * row[3], row[1] + tm * row[4],
                        row[2] + tm * row[5], row[6], row[7]};
  }
  art::write_hit(p, i, q[0], b);
}

}  // namespace

// rows: (N, 10); seg: (1 + n_seg, 8); planes as art_sphere_hit
extern "C" int art_sphere_cellbin(const float* rows, const float* seg, int n_seg, int n_head,
                                  int R, float t_min, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0 && n_seg > kMaxCells)
    sphere_cellbin_kernel<true><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, seg, n_seg, n_head, R, t_min, p);
  else if (grid > 0)
    sphere_cellbin_kernel<false><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, seg, n_seg, n_head, R, t_min, p);
  return (int)cudaGetLastError();
}
