// Shared box helpers of K6 (box_hit.cu), K15's boxes (box_cluster.cu) and
// K9/K10 (box_grid.cu).
//
// The slab division guard (art_tpu/ops/pallas_kernels.py:_safe_div_dir:1937);
// K6's per-box candidate (box_test, _box_kernel:1943; plain twin:
// ops/intersect.py box_candidates_rows), its slab part (slab_candidate)
// shared with K15's staged scan, which hoists the guarded inverses; the winner's face normal and
// make_box (u, v) (_box_write_winner_attrs:2053; src/quad.cuh:145-162): the
// slab is run once more for the winner, its entry face taken if
// |t - t_entry| <= |t - t_exit|, else its exit face; the normal faces against
// the ray and is rotated back to world in the rotated form (plain twin:
// ops/intersect.py box_attributes_rows, the same operations in the same
// order); the output of K6 and K15 (write_box_hit); and the merge into a
// running closest hit of K6's merge form (merge_box_hit).  Box rows are
// [min(3) max(3) cos sin off(3) mat] (scene/tables.py box_rows).
#pragma once

#include "common.cuh"

namespace art {

__device__ __forceinline__ float safe_inv(float d) {
  // _safe_div_dir: |d| < 1e-12 -> +-1e-12 by the sign test d >= 0
  const float s = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / s;
}

// the ray in a box's frame: o - off, then R(-theta) (rotated form only)
template <bool kRotated>
__device__ __forceinline__ void to_box_frame(float ct, float st, float offx, float offy,
                                             float offz, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float& lox,
                                             float& loy, float& loz, float& ldx,
                                             float& ldy, float& ldz) {
  if (kRotated) {
    const float tx = ox - offx, ty = oy - offy, tz = oz - offz;
    lox = ct * tx - st * tz; loy = ty; loz = st * tx + ct * tz;
    ldx = ct * dx - st * dz; ldy = dy; ldz = st * dx + ct * dz;
  } else {
    lox = ox; loy = oy; loz = oz;
    ldx = dx; ldy = dy; ldz = dz;
  }
}

constexpr int kBoxRow = 12;  // floats a box row

// The slab candidate of the box [mn, mx] for the ray lo + t ld in the box's
// frame, ix, iy, iz the guarded inverses of ld: t_entry if through and
// > t_min, else t_exit if through and > t_min, else BIG.
__device__ __forceinline__ float slab_candidate(float mnx, float mny, float mnz, float mxx,
                                                float mxy, float mxz, float lox, float loy,
                                                float loz, float ix, float iy, float iz,
                                                float t_min) {
  const float tax = (mnx - lox) * ix, tbx = (mxx - lox) * ix;
  const float tay = (mny - loy) * iy, tby = (mxy - loy) * iy;
  const float taz = (mnz - loz) * iz, tbz = (mxz - loz) * iz;
  const float t0 = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  const float t1 = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const bool through = t0 < t1;
  return (through && t0 > t_min) ? t0 : ((through && t1 > t_min) ? t1 : kBig);
}

// One (ray, box) candidate: the ray in the box frame, the slab with the
// guarded inverses (slab_candidate).  r: the row's first 11 floats.
template <bool kRotated>
__device__ __forceinline__ float box_test(const float* r, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float t_min) {
  float lox, loy, loz, ldx, ldy, ldz;
  to_box_frame<kRotated>(r[6], r[7], r[8], r[9], r[10], ox, oy, oz, dx, dy, dz, lox, loy,
                         loz, ldx, ldy, ldz);
  return slab_candidate(r[0], r[1], r[2], r[3], r[4], r[5], lox, loy, loz, safe_inv(ldx),
                        safe_inv(ldy), safe_inv(ldz), t_min);
}

struct BoxAttrs {
  float nx, ny, nz, u, v;
};

// face normal and (u, v) of the hit at t on the box [mn, mx] (box frame)
template <bool kRotated>
__device__ __forceinline__ BoxAttrs box_winner_attrs(
    float ox, float oy, float oz, float dx, float dy, float dz, float t, float mnx,
    float mny, float mnz, float mxx, float mxy, float mxz, float ct, float st,
    float offx, float offy, float offz) {
  float lox, loy, loz, ldx, ldy, ldz;
  to_box_frame<kRotated>(ct, st, offx, offy, offz, ox, oy, oz, dx, dy, dz, lox, loy,
                         loz, ldx, ldy, ldz);
  const float ix = safe_inv(ldx), iy = safe_inv(ldy), iz = safe_inv(ldz);
  const float tax = (mnx - lox) * ix, tbx = (mxx - lox) * ix;
  const float tay = (mny - loy) * iy, tby = (mxy - loy) * iy;
  const float taz = (mnz - loz) * iz, tbz = (mxz - loz) * iz;
  const float t0x = fminf(tax, tbx), t1x = fmaxf(tax, tbx);
  const float t0y = fminf(tay, tby), t1y = fmaxf(tay, tby);
  const float t0z = fminf(taz, tbz), t1z = fmaxf(taz, tbz);
  const float t_entry = fmaxf(fmaxf(t0x, t0y), t0z);
  const float t_exit = fminf(fminf(t1x, t1y), t1z);
  const int axis_entry = t0x >= fmaxf(t0y, t0z) ? 0 : (t0y >= t0z ? 1 : 2);
  const int axis_exit = t1x <= fminf(t1y, t1z) ? 0 : (t1y <= t1z ? 1 : 2);
  const bool is_entry = fabsf(t - t_entry) <= fabsf(t - t_exit);
  const int axis = is_entry ? axis_entry : axis_exit;
  const float d_axis = axis == 0 ? ldx : (axis == 1 ? ldy : ldz);
  const float sgn = d_axis >= 0.0f ? 1.0f : -1.0f;
  const float n_val = -sgn;  // shading normal faces against the ray
  const bool pos_face = (is_entry ? -sgn : sgn) > 0.0f;
  const float nlx = axis == 0 ? n_val : 0.0f;
  const float nly = axis == 1 ? n_val : 0.0f;
  const float nlz = axis == 2 ? n_val : 0.0f;
  BoxAttrs a;
  if (kRotated) {  // world = R(theta) * local
    a.nx = ct * nlx + st * nlz;
    a.nz = -st * nlx + ct * nlz;
  } else {
    a.nx = nlx;
    a.nz = nlz;
  }
  a.ny = nly;
  const float x = lox + t * ldx, y = loy + t * ldy, z = loz + t * ldz;
  const float wx = mxx - mnx, wy = mxy - mny, wz = mxz - mnz;
  if (axis == 0) {
    a.u = pos_face ? (mxz - z) / wz : (z - mnz) / wz;
    a.v = (y - mny) / wy;
  } else if (axis == 1) {
    a.u = (x - mnx) / wx;
    a.v = pos_face ? (mxz - z) / wz : (z - mnz) / wz;
  } else {
    a.u = pos_face ? (x - mnx) / wx : (mxx - x) / wx;
    a.v = (y - mny) / wy;
  }
  return a;
}

struct BoxPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  float *t, *nx, *ny, *nz, *u, *v;
  int* mat;
};

// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out); all (R,)
inline BoxPlanes box_planes(void* const* planes) {
  BoxPlanes p;
  p.ox = (const float*)planes[0]; p.oy = (const float*)planes[1];
  p.oz = (const float*)planes[2]; p.dx = (const float*)planes[3];
  p.dy = (const float*)planes[4]; p.dz = (const float*)planes[5];
  p.t = (float*)planes[6]; p.nx = (float*)planes[7]; p.ny = (float*)planes[8];
  p.nz = (float*)planes[9]; p.u = (float*)planes[10]; p.v = (float*)planes[11];
  p.mat = (int*)planes[12];
  return p;
}

// lane i's seven planes: t and the attributes (box_winner_attrs) of the
// winning row r, its first 12 floats (in global or in shared memory)
template <bool kRotated>
__device__ __forceinline__ void write_box_winner(const BoxPlanes& p, int i, const float* r,
                                                 float t, float ox, float oy, float oz,
                                                 float dx, float dy, float dz) {
  const BoxAttrs at = box_winner_attrs<kRotated>(ox, oy, oz, dx, dy, dz, t, r[0], r[1],
                                                 r[2], r[3], r[4], r[5], r[6], r[7], r[8],
                                                 r[9], r[10]);
  p.t[i] = t;
  p.nx[i] = at.nx; p.ny[i] = at.ny; p.nz[i] = at.nz;
  p.u[i] = at.u; p.v[i] = at.v;
  p.mat[i] = (int)r[11];
}

// lane i's output: t and the attributes of the winning row r; a miss
// (r == nullptr) writes t = BIG, normal (1, 0, 0), u = v = 0 and material 0
// (the values closest_surface_p blends in for misses)
template <bool kRotated>
__device__ __forceinline__ void write_box_hit(const BoxPlanes& p, int i, const float* r,
                                              float t, float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  if (r) {
    write_box_winner<kRotated>(p, i, r, t, ox, oy, oz, dx, dy, dz);
    return;
  }
  p.t[i] = t;
  p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f;
  p.u[i] = 0.f; p.v[i] = 0.f; p.mat[i] = 0;
}

// The merge into a running closest hit (t, normal, u, v, mat in the seven
// planes, in and out; intersect.py _closer's semantics in one pass): the
// scan starts at the incoming t, p.t[i], instead of BIG and keeps its
// strict `<`, so a box wins only where it is strictly closer (an exact tie
// keeps the incoming hit: a quad on cornell_box's floor under a box) and,
// among boxes, the first in scene order at the minimum wins, as when the
// scan starts at BIG.  Only a lane with a winner (r != nullptr) computes
// its attributes and writes its planes; every other lane leaves them
// untouched, bit for bit (a quad's (alpha, beta), signed zeros included).
template <bool kRotated>
__device__ __forceinline__ void merge_box_hit(const BoxPlanes& p, int i, const float* r,
                                              float t, float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  if (r) write_box_winner<kRotated>(p, i, r, t, ox, oy, oz, dx, dy, dz);
}

}  // namespace art
