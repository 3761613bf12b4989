// K5 — closest quad hit with the winner's attributes, one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:quad_closest_hit_planar (:1890,
// _quad_kernel:1842) together with the jnp winner attributes art_tpu
// computes after it (art_tpu/ops/intersect.py:quad_attributes_p:414, called
// at :544-549).  For every ray and every quad row [n(3) D avec(3) ca
// bvec(3) cb] (scene/tables.py quad_rows, the layout of pack_quads): the
// plane hit t = (D - n.o) / (n.d), then the interior test
// alpha = avec.o + t avec.d - ca, beta = bvec.o + t bvec.d - cb, both in
// [0, 1] (src/quad.cuh:60-90).  A quad counts when |n.d| >= 1e-8 and
// t > t_min (t_min a run-time argument, as in K2); the scan keeps the first
// quad in scene order with a strict `<`, so an exact tie goes to the lower
// index, as the TPU kernel and argmin.  n.d == 0 makes t inf or NaN: every
// test on it is false, so it is masked, never trapped, and a NaN cannot win
// the `<`.  Then, from the winner's quad_attr_packed row [q(3) u(3) v(3)
// w(3) n(3) mat] (one 64-byte row a ray, read after the scan): p = o + t d,
// pl = p - q, alpha = w.(pl x v), beta = w.(u x pl), the normal n negated
// where n.d > 0 (so it faces the ray; a negation keeps a zero's sign), and
// the material, the float truncated to int.  A miss writes t = BIG, normal
// (1, 0, 0), alpha = beta = +0 and material 0 — closest_surface_p's blend
// defaults.  Plain twin: ops/intersect_kernels.py quad_hit_attrs_plain
// (quad_candidates_p, then quad_attributes_p and the miss defaults), the
// same operations in the same order: the products of p_ray_at, p_cross and
// p_dot rounded one by one (-fmad=false), the sums left to right, the
// division IEEE on both sides (tensor by tensor in the twin).
//
// Bound on the H100: at Q = 6 (cornell_box) memory — 6 planes in and 7 out
// per ray, 52 B, 6.8 MB at R = 2^17 — against ~44 operations per
// (ray, quad) and ~40 for the winner.  Design: the quad rows are staged
// through shared memory in tiles of kTile rows (24 KB), so any Q fits; every
// thread of a warp reads the same row, so each shared load is a broadcast;
// the winner's attribute row comes through the read-only cache (the table is
// Q x 64 B), so the attributes cost one launch's outputs and no gather of an
// (R, 16) row table.

#include "common.cuh"

namespace {

constexpr int kRow = 12;
constexpr int kAttr = 16;
constexpr int kTile = 512;

struct QuadPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float *t, *nx, *ny, *nz, *alpha, *beta;
  int* mat;
};

__global__ void __launch_bounds__(art::kBlock)
quad_hit_kernel(const float* __restrict__ rows, const float* __restrict__ attrs, int Q, int R,
                float t_min, QuadPlanes p) {
  __shared__ float sh[kTile * kRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;

  float best = art::kBig;
  int best_i = -1;
  for (int base = 0; base < Q; base += kTile) {
    const int n = min(kTile, Q - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * kRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * kRow + k];
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float* r = sh + q * kRow;
      const float nd = dx * r[0] + dy * r[1] + dz * r[2];
      const float no = ox * r[0] + oy * r[1] + oz * r[2];
      const float t = (r[3] - no) / nd;
      const float alpha = (ox * r[4] + oy * r[5] + oz * r[6]) +
                          t * (dx * r[4] + dy * r[5] + dz * r[6]) - r[7];
      const float beta = (ox * r[8] + oy * r[9] + oz * r[10]) +
                         t * (dx * r[8] + dy * r[9] + dz * r[10]) - r[11];
      const bool valid = fabsf(nd) >= 1e-8f && t > t_min && alpha >= 0.0f &&
                         alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
      if (valid && t < best) {
        best = t;
        best_i = base + q;
      }
    }
  }
  if (!live) return;

  // ---- the winner's attributes (ops/intersect.py quad_attributes_p) ----
  float nx = 1.0f, ny = 0.0f, nz = 0.0f, al = 0.0f, be = 0.0f;
  int mat = 0;
  if (best_i >= 0) {
    const float* a = attrs + (size_t)best_i * kAttr;
    const float plx = (ox + best * dx) - __ldg(a + 0);
    const float ply = (oy + best * dy) - __ldg(a + 1);
    const float plz = (oz + best * dz) - __ldg(a + 2);
    const float u0 = __ldg(a + 3), u1 = __ldg(a + 4), u2 = __ldg(a + 5);
    const float v0 = __ldg(a + 6), v1 = __ldg(a + 7), v2 = __ldg(a + 8);
    const float w0 = __ldg(a + 9), w1 = __ldg(a + 10), w2 = __ldg(a + 11);
    // alpha = w . (pl x v), beta = w . (u x pl)
    const float c0 = ply * v2 - plz * v1, c1 = plz * v0 - plx * v2, c2 = plx * v1 - ply * v0;
    const float e0 = u1 * plz - u2 * ply, e1 = u2 * plx - u0 * plz, e2 = u0 * ply - u1 * plx;
    al = w0 * c0 + w1 * c1 + w2 * c2;
    be = w0 * e0 + w1 * e1 + w2 * e2;
    const float n0 = __ldg(a + 12), n1 = __ldg(a + 13), n2 = __ldg(a + 14);
    const bool flip = n0 * dx + n1 * dy + n2 * dz > 0.0f;  // src/quad.cuh:84-86
    nx = flip ? -n0 : n0;
    ny = flip ? -n1 : n1;
    nz = flip ? -n2 : n2;
    mat = (int)__ldg(a + 15);
  }
  p.t[i] = best;
  p.nx[i] = nx; p.ny[i] = ny; p.nz[i] = nz;
  p.alpha[i] = al;
  p.beta[i] = be;
  p.mat[i] = mat;
}

}  // namespace

// rows: quad_rows (Q, 12); attrs: quad_attr_packed (Q, 16).
// planes: ox oy oz dx dy dz (in), t nx ny nz alpha beta (f32) mat (i32)
// (out); all (R,)
extern "C" int art_quad_hit(const float* rows, const float* attrs, int Q, int R, float t_min,
                            void* const* planes, void* stream) {
  QuadPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6];
  p.nx = (float*)planes[7]; p.ny = (float*)planes[8]; p.nz = (float*)planes[9];
  p.alpha = (float*)planes[10];
  p.beta = (float*)planes[11];
  p.mat = (int*)planes[12];
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    quad_hit_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(rows, attrs, Q, R,
                                                                    t_min, p);
  return (int)cudaGetLastError();
}
