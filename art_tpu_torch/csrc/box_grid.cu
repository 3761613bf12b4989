// K10 and K9 — closest box of a regular lattice field, one thread per ray.
//
// Replace art_tpu/ops/pallas_kernels.py:box_grid_hit_attrs (:2297,
// _box_grid_kernel:2200) and box_grid_static_hit_attrs (:2435,
// _box_grid_static_kernel:2342).  The field is scene/builder.py
// _detect_box_grid's: unrotated boxes on one floor y0, one cell width w, cell
// (ix, iz) spanning [x0 + f32(ix) w, x0 + f32(ix) w + w] in x (z alike) and
// [y0, h] in y.  Per ray: the guarded inverses (box_attrs.cuh safe_inv),
// ex0 = (x0 - ox) ix, sxv = w ix, ez0, szv, and the shared floor plane
// ty0p = (y0 - oy) iy.  Per cell: ta = ex0 + f32(ix) sxv, tb = ta + sxv (the
// x slab; z alike), ty1 = (h - oy) iy, t0 = max(xlo, zlo, ylo),
// t1 = min(xhi, zhi, yhi), then t0 if t0 > t_min, else t1 if t1 > t_min,
// only where t0 < t1; a strict `<` keeps the first closest cell.  The
// winner's box is rebuilt from its cell in float32 and its face normal,
// (u, v) and material come from box_winner_attrs (box_attrs.cuh), shared
// with K6.  Output (t, normal x3, u, v, mat), as K6; a miss writes t = BIG,
// normal (1, 0, 0), u = v = 0, material 0.  Plain twins:
// ops/intersect_kernels.py box_grid_hit_attrs_plain and
// box_grid_cells_hit_attrs_plain (ops/intersect.py box_grid_candidates_p,
// box_grid_attributes_p), the same operations in the same order.
//
// The two entry points differ in the cells they walk, their order and their
// design.  On an exact tie between cells they keep different, equally close
// winners, as the TPU kernels do.  Bound on the H100: FP32 issue — ~20
// operations a (ray, cell) a ray must test; K9 tests final_scene's 400 cells
// (~1e9 operations at R = 2^17), K10 a few cells a ray, so its bound is the
// 6 planes in and 7 out a ray.  Both are built with -fmad=false, so the time
// goes to the instructions issued a cell.
//
// K10 (art_box_grid) reads the (kx, 2 kz) table of [h, mat] pairs (an empty
// cell has h = y0) and walks, per ray, only the cells whose slabs can meet:
//  * the y window: ty1 = (h - oy) iy is monotone in h, so every cell's y
//    slab lies in [y_lo, y_hi], the span of ty0p and ty1 at the table's
//    lowest and highest tops (a min and max every block reduces from the
//    table, no host read); a ray with y_hi <= t_min tests nothing;
//  * a cell gives t0 < t1 with t1 > t_min only where xhi > max(t_min, y_lo,
//    zlo) and xlo < min(y_hi, zhi), and zhi > max(t_min, y_lo, xlo) and
//    zlo < min(y_hi, xhi), each a bound on the twin's own floats.  Along x
//    both ends of ex0 + f32(ix) sxv (and + sxv) move with ix in sxv's
//    direction (float multiplication and addition round monotonically), so
//    the columns that meet the first pair (with the z window of the first
//    and last rows) are one interval of ix, and in each column the rows
//    that meet the second pair one interval of iz (SlabWalk: the first
//    index from a float estimate, then exact steps of the per-cell
//    expressions; the walk stops where the far condition first fails);
//  * those cells are tested with the twin's operations in row-major order
//    (columns ascending, rows ascending in a column) into a strict-`<`
//    carry of (t, ix, iz, h, mat): every skipped cell misses in the twin, so
//    the winner, ties included, is the twin's.  The x slab is formed once a
//    column; a cell is one float2 load of (h, mat) through the read-only
//    cache (the table, 8 B a cell, stays in L1 and L2), the next cell's in
//    flight while one is tested.
// On the 40x40 box field's pool that is 3.6 cells a ray where the table has
// 1600 (PERF.md section 6; chip_smoke._grid_tests counts them).
//
// K9 (art_box_grid_cells) walks the non-empty cells as (C, 4) rows
// [ix iz h mat] in box_grid_cells order (grouped by height, then material):
//  * each ray's x slab (xlo, xhi) of each of the kx columns and z slab of
//    each of the kz rows are computed once, with the per-cell operations
//    (f32(ix) is the cell's float ix), into dynamic shared memory laid out
//    [column][ray], so a cell's two slab reads (LDS.64) are free of bank
//    conflicts: 8 (kx + kz) bytes a ray, 40 KB for final_scene's 20 + 20 at
//    128 rays a block.  A lattice with kx + kz > kMaxSlabCols takes the
//    template's second form, the slabs per cell from the cell's ix and iz
//    (art_box_grid_cells_form says which);
//  * the y slab is recomputed only at the first cell of a run of one height
//    (a flag staged with the cell; nvcc predicates that warp-uniform test);
//  * a cell is one LDS.128 broadcast of its staged row (the slabs' byte
//    offsets, the height, the run flag); the loop is software-pipelined, cell
//    k + 2's row and cell k + 1's slabs in flight while cell k is tested; the
//    running best carries (t, cell index) and the winner's box is rebuilt
//    from its global row after the loop; the twin's choice of t0 or t1 folds
//    into t = t0 > t_min ? t0 : t1 taken where t0 < t1, t > t_min and
//    t < best (a BIG candidate never beats the best);
//  * a warp whose every lane starts at or above the floor and the tile's
//    highest top (oy >= max(y0, h)) and does not point down (dy >= 0, so
//    safe_inv(dy) > 0) tests no cell of the tile when t_min >= 0: for such
//    a lane ty0p <= 0 and every ty1 <= 0, so every cell's t1 <= 0 <= t_min
//    and t0 < t1 <= 0, and the twin misses (ops/intersect_kernels.py
//    box_grid_skip_p, the same predicate over all the cells);
//  * a block is two parts of 128 threads over the same 128 rays: part 0
//    hoists the x slabs and walks the first half of a tile's cells, part 1
//    the z slabs and the second half; part 0 then takes part 1's winner where
//    it is closer, or as close and earlier.  The slabs allow four blocks a
//    SM, so the parts double the warps there (R = 2^17: 1024 blocks, about
//    two waves).
// The hoisted slabs trade ten FP32 operations a cell for two LDS.64 a lane,
// four shared-memory wavefronts a warp and cell, so shared memory and issue
// share the time (PERF.md section 6).

#include "box_attrs.cuh"

namespace {

constexpr int kCellThreads = 128;  // K9: rays a block (threads a part)
constexpr int kCellTile = 1024;    // K9: cells a shared-memory tile holds
constexpr int kMaxSlabCols = 64;   // K9: hoisted slabs where kx + kz <= this
constexpr int kSlabStride = kCellThreads * (int)sizeof(float2);  // bytes a slab column
constexpr int kCellSplit = 2;      // K9: parts a block, each over a part of the cells
constexpr unsigned kAll = 0xffffffffu;

struct GridPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float *t, *nx, *ny, *nz, *u, *v;
  int* mat;
};

struct Lattice {
  float x0, z0, w, y0;
};

// lane i's output: the hit at t on the cell (fix, fiz) of height h and
// material mat, rebuilt in float32 as the TPU kernels rebuild it, or a miss
__device__ __forceinline__ void write_cell_hit(const GridPlanes& p, int i, const Lattice& g,
                                               float ox, float oy, float oz, float dx,
                                               float dy, float dz, float best, float fix,
                                               float fiz, float h, float mat) {
  p.t[i] = best;
  if (!(best < art::kBig)) {
    p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f;
    p.u[i] = 0.f; p.v[i] = 0.f; p.mat[i] = 0;
    return;
  }
  const float mnx = g.x0 + fix * g.w, mnz = g.z0 + fiz * g.w;
  const art::BoxAttrs at = art::box_winner_attrs<false>(
      ox, oy, oz, dx, dy, dz, best, mnx, g.y0, mnz, mnx + g.w, h, mnz + g.w, 1.f, 0.f,
      0.f, 0.f, 0.f);
  p.nx[i] = at.nx; p.ny[i] = at.ny; p.nz[i] = at.nz;
  p.u[i] = at.u; p.v[i] = at.v;
  p.mat[i] = (int)mat;
}

// the slab (lo, hi) of index k along one axis, as the twin forms it:
// ta = e0 + f32(k) s, tb = ta + s
__device__ __forceinline__ float2 slab_at(float e0, float s, int k) {
  const float ta = e0 + (float)k * s, tb = ta + s;
  return make_float2(fminf(ta, tb), fmaxf(ta, tb));
}

// K10's walk along one axis: the indices k in [0, n) whose slab has hi > a
// and lo < b.  Both ends of the slab move with k in the direction of s,
// since float multiplication and addition round monotonically, so with
// s >= 0 hi > a (`rises`) holds from some index on and lo < b (`falls`) up to
// some index, with s < 0 lo < b from some index on and hi > a up to some
// index: the indices form one interval.  Its first index comes from a float
// estimate with rs ~ 1 / s, then exact steps until `rises` holds there and
// fails one index before (by monotonicity it then fails at every index
// before); the walk from it stops at the first index where `falls` fails.
struct SlabWalk {
  float e0, s, a, b;
  bool up;
  __device__ __forceinline__ SlabWalk(float e0_, float s_, float a_, float b_)
      : e0(e0_), s(s_), a(a_), b(b_), up(s_ >= 0.f) {}
  __device__ __forceinline__ bool rises(float2 t) const { return up ? t.y > a : t.x < b; }
  __device__ __forceinline__ bool falls(float2 t) const { return up ? t.x < b : t.y > a; }
  __device__ __forceinline__ int first(float rs, int n) const {
    // fmaxf takes -1 for a NaN estimate
    const float e = ((up ? a : b) - e0) * rs;
    int k = min(max((int)floorf(fminf(fmaxf(e, -1.f), (float)n + 1.f)), 0), n);
    while (k < n && !rises(slab_at(e0, s, k))) ++k;
    while (k > 0 && rises(slab_at(e0, s, k - 1))) --k;
    return k;
  }
};

// K10: the (kx, 2 kz) table of kx * kz cells, each ray walking the cells it
// can hit (the module note)
__global__ void __launch_bounds__(art::kBlock)
box_grid_kernel(const float* __restrict__ cells, int kx, int kz, Lattice g, int R,
                float t_min, GridPlanes p) {
  // the table's lowest and highest top, reduced by every block
  __shared__ float warp_lo[art::kBlock / 32], warp_hi[art::kBlock / 32];
  const int n = kx * kz;
  const float2* hm_table = reinterpret_cast<const float2*>(cells);  // (h, mat) a cell
  float h_lo = INFINITY, h_hi = -INFINITY;
#pragma unroll 8
  for (int k = threadIdx.x; k < n; k += art::kBlock) {
    const float h = __ldg(hm_table + k).x;
    h_lo = fminf(h_lo, h);
    h_hi = fmaxf(h_hi, h);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    h_lo = fminf(h_lo, __shfl_xor_sync(kAll, h_lo, o));
    h_hi = fmaxf(h_hi, __shfl_xor_sync(kAll, h_hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = h_lo;
    warp_hi[threadIdx.x >> 5] = h_hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < art::kBlock / 32; ++w) {
    h_lo = fminf(h_lo, warp_lo[w]);
    h_hi = fmaxf(h_hi, warp_hi[w]);
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float ox = p.ox[i], oy = p.oy[i], oz = p.oz[i];
  const float dx = p.dx[i], dy = p.dy[i], dz = p.dz[i];
  const float ixv = art::safe_inv(dx), iyv = art::safe_inv(dy), izv = art::safe_inv(dz);
  const float ex0 = (g.x0 - ox) * ixv, sxv = g.w * ixv;
  const float ez0 = (g.z0 - oz) * izv, szv = g.w * izv;
  const float ty0p = (g.y0 - oy) * iyv;  // the shared floor plane
  // every cell's y slab lies in [y_lo, y_hi]: ty1 = (h - oy) iy is monotone
  // in h, and every h lies in [h_lo, h_hi]
  const float ta = (h_lo - oy) * iyv, tb = (h_hi - oy) * iyv;
  const float y_lo = fminf(ty0p, fminf(ta, tb)), y_hi = fmaxf(ty0p, fmaxf(ta, tb));

  float best = art::kBig, bix = 0.f, biz = 0.f, bh = g.y0, bm = 0.f;
  if (y_hi > t_min) {  // else every cell's t1 <= y_hi <= t_min: a miss
    // every row's z slab lies in the first's and the last's
    const float2 z_first = slab_at(ez0, szv, 0), z_last = slab_at(ez0, szv, kz - 1);
    const float low = fmaxf(t_min, y_lo);
    const float rsz = __frcp_rn(szv);  // for the estimates only
    // a cell with t0 < t1 and t1 > t_min has xhi >= t1 > t0 >= max(ylo, zlo),
    // xlo <= t0 < t1 <= min(yhi, zhi), and the same of its z slab
    const SlabWalk xw(ex0, sxv, fmaxf(low, fminf(z_first.x, z_last.x)),
                      fminf(y_hi, fmaxf(z_first.y, z_last.y)));
    for (int ix = xw.first(__frcp_rn(sxv), kx); ix < kx; ++ix) {
      const float2 xs = slab_at(ex0, sxv, ix);
      if (!xw.falls(xs)) break;
      const SlabWalk zw(ez0, szv, fmaxf(low, xs.x), fminf(y_hi, xs.y));
      const float2* col = hm_table + (size_t)ix * kz;
      const float fix = (float)ix;
      int iz = zw.first(rsz, kz);
      float2 hm = __ldg(col + min(iz, kz - 1));
      for (; iz < kz; ++iz) {
        const float2 zs = slab_at(ez0, szv, iz);
        if (!zw.falls(zs)) break;
        const float2 next = __ldg(col + min(iz + 1, kz - 1));  // the next cell's, in flight
        const float ty1 = (hm.x - oy) * iyv;
        const float ylo = fminf(ty0p, ty1), yhi = fmaxf(ty0p, ty1);
        const float t0 = fmaxf(fmaxf(xs.x, zs.x), ylo);
        const float t1 = fminf(fminf(xs.y, zs.y), yhi);
        const bool through = t0 < t1;
        const float t = (through && t0 > t_min) ? t0
                        : ((through && t1 > t_min) ? t1 : art::kBig);
        if (t < best) {
          best = t; bix = fix; biz = (float)iz; bh = hm.x; bm = hm.y;
        }
        hm = next;
      }
    }
  }
  write_cell_hit(p, i, g, ox, oy, oz, dx, dy, dz, best, bix, biz, bh, bm);
}

// a cell's x and z slabs (xlo, xhi, zlo, zhi): read as float2 (lo, hi)
// from the thread's hoisted slabs at the staged byte offsets, or computed
// from the staged float ix and iz
template <bool kHoisted>
__device__ __forceinline__ float4 cell_slabs(const char* slab, int4 c, float ex0, float sxv,
                                             float ez0, float szv) {
  if (kHoisted) {
    const float2 xs = *reinterpret_cast<const float2*>(slab + c.x);
    const float2 zs = *reinterpret_cast<const float2*>(slab + c.y);
    return make_float4(xs.x, xs.y, zs.x, zs.y);
  }
  float ta = ex0 + __int_as_float(c.x) * sxv, tb = ta + sxv;
  const float xlo = fminf(ta, tb), xhi = fmaxf(ta, tb);
  ta = ez0 + __int_as_float(c.y) * szv;
  tb = ta + szv;
  return make_float4(xlo, xhi, fminf(ta, tb), fmaxf(ta, tb));
}

// K9: the (C, 4) cell rows; kHoisted: the x and z slabs hoisted per column
// and row into shared memory (the module note)
template <bool kHoisted>
__global__ void __launch_bounds__(kCellThreads * kCellSplit)
box_grid_cells_kernel(const float* __restrict__ cells, int C, int kx, int kz, Lattice g,
                      int R, float t_min, GridPlanes p) {
  // dynamic shared memory: the tile's cells and two pad rows (int4: the x
  // and z slabs' byte offsets or the float ix and iz, the height's bits, 1
  // at the first cell of a run of one height), then the hoisted slabs
  extern __shared__ int4 dyn[];
  const int cap = min(C, kCellTile);
  int4* tile = dyn;
  const int ray = threadIdx.x % kCellThreads, part = threadIdx.x / kCellThreads;
  char* slab = reinterpret_cast<char*>(dyn + cap + 2) + ray * (int)sizeof(float2);
  __shared__ float warp_top[kCellThreads * kCellSplit / 32];
  __shared__ float part_best[(kCellSplit - 1) * kCellThreads];  // parts 1.. at their end
  __shared__ int part_bk[(kCellSplit - 1) * kCellThreads];
  const int i = blockIdx.x * kCellThreads + ray;
  const int lane = threadIdx.x & 31;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;
  const float ixv = art::safe_inv(dx), iyv = art::safe_inv(dy), izv = art::safe_inv(dz);
  const float ex0 = (g.x0 - ox) * ixv, sxv = g.w * ixv;
  const float ez0 = (g.z0 - oz) * izv, szv = g.w * izv;
  const float ty0p = (g.y0 - oy) * iyv;  // the shared floor plane
  if (kHoisted) {  // columns 0..kx-1 in x (part 0), then the kz rows in z (the last part)
    for (int c = 0; part == 0 && c < kx; ++c) {
      const float ta = ex0 + (float)c * sxv, tb = ta + sxv;
      *reinterpret_cast<float2*>(slab + c * kSlabStride) = make_float2(fminf(ta, tb),
                                                                       fmaxf(ta, tb));
    }
    for (int c = 0; part == kCellSplit - 1 && c < kz; ++c) {
      const float ta = ez0 + (float)c * szv, tb = ta + szv;
      *reinterpret_cast<float2*>(slab + (kx + c) * kSlabStride) = make_float2(fminf(ta, tb),
                                                                              fmaxf(ta, tb));
    }
  }

  float best = art::kBig;
  int bk = -1;
  for (int base = 0; base < C; base += kCellTile) {
    const int m = min(kCellTile, C - base);
    __syncthreads();
    float top = g.y0;  // the floor and every top of the tile lie at or below it
    for (int k = threadIdx.x; k < m; k += kCellThreads * kCellSplit) {
      const float* c = cells + (size_t)(base + k) * 4;
      const float fix = c[0], fiz = c[1], h = c[2];
      top = fmaxf(top, h);
      const bool first = k == 0 || __float_as_uint(c[-2]) != __float_as_uint(h);
      tile[k] = kHoisted ? make_int4((int)fix * kSlabStride, (kx + (int)fiz) * kSlabStride,
                                     __float_as_int(h), first)
                         : make_int4(__float_as_int(fix), __float_as_int(fiz),
                                     __float_as_int(h), first);
    }
    if (threadIdx.x < 2) tile[m + threadIdx.x] = make_int4(0, 0, 0, 0);  // read ahead
#pragma unroll
    for (int o = 16; o; o >>= 1) top = fmaxf(top, __shfl_xor_sync(kAll, top, o));
    if (lane == 0) warp_top[threadIdx.x >> 5] = top;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kCellThreads * kCellSplit / 32; ++w) top = fmaxf(top, warp_top[w]);
    if (__all_sync(kAll, !live || (t_min >= 0.0f && oy >= top && dy >= 0.0f))) continue;
    // software-pipelined: cell k + 2's row and cell k + 1's slabs are in
    // flight while cell k is tested
    const int k0 = m * part / kCellSplit, k1 = m * (part + 1) / kCellSplit;
    int4 c0 = tile[k0], c1 = tile[k0 + 1];
    float4 s0 = cell_slabs<kHoisted>(slab, c0, ex0, sxv, ez0, szv);
    float ty1 = (__int_as_float(c0.z) - oy) * iyv;  // the first cell's y slab
    float ylo = fminf(ty0p, ty1), yhi = fmaxf(ty0p, ty1);
#pragma unroll 2
    for (int k = k0; k < k1; ++k) {
      const int4 c2 = tile[k + 2];
      const float4 s1 = cell_slabs<kHoisted>(slab, c1, ex0, sxv, ez0, szv);
      if (c0.w) {  // a run's first cell: its height's y slab
        ty1 = (__int_as_float(c0.z) - oy) * iyv;
        ylo = fminf(ty0p, ty1);
        yhi = fmaxf(ty0p, ty1);
      }
      const float t0 = fmaxf(fmaxf(s0.x, s0.z), ylo);
      const float t1 = fminf(fminf(s0.y, s0.w), yhi);
      const float t = t0 > t_min ? t0 : t1;
      if (t0 < t1 && t > t_min && t < best) {
        best = t;
        bk = base + k;
      }
      c0 = c1;
      c1 = c2;
      s0 = s1;
    }
  }
  // part 0 takes a later part's winner where it is closer, or as close and
  // earlier
  if (part > 0) {
    part_best[(part - 1) * kCellThreads + ray] = best;
    part_bk[(part - 1) * kCellThreads + ray] = bk;
  }
  __syncthreads();
  if (part > 0) return;
  for (int j = ray; j < (kCellSplit - 1) * kCellThreads; j += kCellThreads) {
    const float b = part_best[j];
    if (b < best || (b == best && b < art::kBig && part_bk[j] < bk)) {
      best = b;
      bk = part_bk[j];
    }
  }
  if (!live) return;
  const float* w = cells + (size_t)max(bk, 0) * 4;  // read only for a hit
  if (best < art::kBig)
    write_cell_hit(p, i, g, ox, oy, oz, dx, dy, dz, best, w[0], w[1], w[2], w[3]);
  else
    write_cell_hit(p, i, g, ox, oy, oz, dx, dy, dz, best, 0.f, 0.f, g.y0, 0.f);
}

GridPlanes grid_planes(void* const* planes) {
  GridPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6]; p.nx = (float*)planes[7]; p.ny = (float*)planes[8];
  p.nz = (float*)planes[9]; p.u = (float*)planes[10]; p.v = (float*)planes[11];
  p.mat = (int*)planes[12];
  return p;
}

}  // namespace

// K10.  table: (kx, 2 kz) float32 [h, mat] pairs; lattice: host (x0, z0, w, y0);
// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out); all (R,)
extern "C" int art_box_grid(const float* table, int kx, int kz, const float* lattice,
                            int R, float t_min, void* const* planes, void* stream) {
  const Lattice g{lattice[0], lattice[1], lattice[2], lattice[3]};
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    box_grid_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        table, kx, kz, g, R, t_min, grid_planes(planes));
  return (int)cudaGetLastError();
}

// K9's form for a kx x kz lattice: 1 with the slabs hoisted, 0 per cell
extern "C" int art_box_grid_cells_form(int kx, int kz) {
  return kx + kz <= kMaxSlabCols;
}

// K9.  cells: (C, 4) float32 [ix iz h mat] (ix < kx, iz < kz); the rest as K10
extern "C" int art_box_grid_cells(const float* cells, int C, int kx, int kz,
                                  const float* lattice, int R, float t_min,
                                  void* const* planes, void* stream) {
  const Lattice g{lattice[0], lattice[1], lattice[2], lattice[3]};
  const int grid = (R + kCellThreads - 1) / kCellThreads;
  if (grid <= 0) return 0;
  const bool hoisted = art_box_grid_cells_form(kx, kz);
  const int cap = min(C, kCellTile);
  const size_t bytes =
      (cap + 2) * sizeof(int4) + (hoisted ? (size_t)(kx + kz) * kSlabStride : 0);
  const auto kernel = hoisted ? box_grid_cells_kernel<true> : box_grid_cells_kernel<false>;
  // the static arrays take ~1 KB of the default 48 KB, so the dynamic limit
  // is raised, once a form, to the most a launch can ask for
  static bool raised[2] = {false, false};
  if (!raised[hoisted]) {
    const int most =
        (kCellTile + 2) * (int)sizeof(int4) + (hoisted ? kMaxSlabCols * kSlabStride : 0);
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (rc) return rc;
    raised[hoisted] = true;
  }
  kernel<<<grid, kCellThreads * kCellSplit, bytes, (cudaStream_t)stream>>>(
      cells, C, kx, kz, g, R, t_min, grid_planes(planes));
  return (int)cudaGetLastError();
}
