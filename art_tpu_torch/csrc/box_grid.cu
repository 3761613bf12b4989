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
// normal (1, 0, 0), u = v = 0, material 0.
//
// The two entry points differ only in the cells they walk and their order:
// K10 (art_box_grid) every cell of the (kx, 2 kz) table [h, mat] pairs in
// row-major order (an empty cell has h = y0, so t0 < t1 never holds), K9
// (art_box_grid_cells) the non-empty cells as (C, 4) rows [ix iz h mat] in
// box_grid_cells order (grouped by height and material).  On an exact tie
// between cells they keep different, equally close winners, as the TPU
// kernels do.  The TPU kernels' slab caches (K10's z-slab scratch, K9's
// per-group y slab and per-column x slabs) are op-count trims: a slab
// recomputed per cell has the same bits.  The material is carried per cell
// (a uniform-material field carries one value).  Plain twins:
// ops/intersect_kernels.py box_grid_hit_attrs_plain and
// box_grid_cells_hit_attrs_plain (ops/intersect.py box_grid_candidates_p,
// box_grid_attributes_p), the same operations in the same order.
//
// Bound on the H100: FP32 issue — ~20 operations a (ray, cell) with the
// slabs hoisted, ~28 here; final_scene's 400 cells at R = 2^17 are ~1e9
// operations against 6 planes in and 7 out per ray (7 MB).  Design: the cell
// table is staged through shared memory in tiles of kTile cells and read as
// broadcasts (every thread of a block walks the same cells); the running
// best carries (t, ix, iz, h, mat), so the winner needs no second pass.

#include "box_attrs.cuh"

namespace {

constexpr int kTile = 1024;  // cells a shared-memory tile holds

struct GridPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float *t, *nx, *ny, *nz, *u, *v;
  int* mat;
};

struct Lattice {
  float x0, z0, w, y0;
};

// kGrouped: K9's (C, 4) cell rows; else K10's (kx, 2 kz) table of n = kx*kz cells
template <bool kGrouped>
__global__ void __launch_bounds__(art::kBlock)
box_grid_kernel(const float* __restrict__ cells, int n, int kz, Lattice g, int R,
                float t_min, GridPlanes p) {
  constexpr int kCell = kGrouped ? 4 : 2;  // floats a cell
  __shared__ float sh[kTile * kCell];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;
  const float ixv = art::safe_inv(dx), iyv = art::safe_inv(dy), izv = art::safe_inv(dz);
  const float ex0 = (g.x0 - ox) * ixv, sxv = g.w * ixv;
  const float ez0 = (g.z0 - oz) * izv, szv = g.w * izv;
  const float ty0p = (g.y0 - oy) * iyv;  // the shared floor plane

  float best = art::kBig, bix = 0.f, biz = 0.f, bh = g.y0, bm = 0.f;
  for (int base = 0; base < n; base += kTile) {
    const int m = min(kTile, n - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m * kCell; k += blockDim.x)
      sh[k] = cells[(size_t)base * kCell + k];
    __syncthreads();
    int cx = kGrouped ? 0 : base / kz, cz = kGrouped ? 0 : base - cx * kz;
    for (int k = 0; k < m; ++k) {
      const float* c = sh + k * kCell;
      float fix, fiz, h, mat;
      if (kGrouped) {
        fix = c[0]; fiz = c[1]; h = c[2]; mat = c[3];
      } else {
        fix = (float)cx; fiz = (float)cz; h = c[0]; mat = c[1];
        if (++cz == kz) { cz = 0; ++cx; }
      }
      float ta = ex0 + fix * sxv, tb = ta + sxv;
      const float xlo = fminf(ta, tb), xhi = fmaxf(ta, tb);
      ta = ez0 + fiz * szv; tb = ta + szv;
      const float zlo = fminf(ta, tb), zhi = fmaxf(ta, tb);
      const float ty1 = (h - oy) * iyv;
      const float ylo = fminf(ty0p, ty1), yhi = fmaxf(ty0p, ty1);
      const float t0 = fmaxf(fmaxf(xlo, zlo), ylo);
      const float t1 = fminf(fminf(xhi, zhi), yhi);
      const bool through = t0 < t1;
      const float t = (through && t0 > t_min) ? t0
                      : ((through && t1 > t_min) ? t1 : art::kBig);
      if (t < best) {
        best = t; bix = fix; biz = fiz; bh = h; bm = mat;
      }
    }
  }
  if (!live) return;
  p.t[i] = best;
  if (!(best < art::kBig)) {
    p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f;
    p.u[i] = 0.f; p.v[i] = 0.f; p.mat[i] = 0;
    return;
  }
  // the winner's box from its cell, as the TPU kernels rebuild it
  const float mnx = g.x0 + bix * g.w, mnz = g.z0 + biz * g.w;
  const art::BoxAttrs at = art::box_winner_attrs<false>(
      ox, oy, oz, dx, dy, dz, best, mnx, g.y0, mnz, mnx + g.w, bh, mnz + g.w, 1.f, 0.f,
      0.f, 0.f, 0.f);
  p.nx[i] = at.nx; p.ny[i] = at.ny; p.nz[i] = at.nz;
  p.u[i] = at.u; p.v[i] = at.v;
  p.mat[i] = (int)bm;
}

template <bool kGrouped>
int launch(const float* cells, int n, int kz, const float* lattice, int R, float t_min,
           void* const* planes, void* stream) {
  GridPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6]; p.nx = (float*)planes[7]; p.ny = (float*)planes[8];
  p.nz = (float*)planes[9]; p.u = (float*)planes[10]; p.v = (float*)planes[11];
  p.mat = (int*)planes[12];
  const Lattice g{lattice[0], lattice[1], lattice[2], lattice[3]};
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    box_grid_kernel<kGrouped><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        cells, n, kz, g, R, t_min, p);
  return (int)cudaGetLastError();
}

}  // namespace

// K10.  table: (kx, 2 kz) float32 [h, mat] pairs; lattice: host (x0, z0, w, y0);
// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out); all (R,)
extern "C" int art_box_grid(const float* table, int kx, int kz, const float* lattice,
                            int R, float t_min, void* const* planes, void* stream) {
  return launch<false>(table, kx * kz, kz, lattice, R, t_min, planes, stream);
}

// K9.  cells: (C, 4) float32 [ix iz h mat]; kz unused; the rest as K10
extern "C" int art_box_grid_cells(const float* cells, int C, int kz,
                                  const float* lattice, int R, float t_min,
                                  void* const* planes, void* stream) {
  return launch<true>(cells, C, kz, lattice, R, t_min, planes, stream);
}
