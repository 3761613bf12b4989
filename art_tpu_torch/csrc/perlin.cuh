// Hash-based gradient Perlin noise and turbulence as device functions: the
// hash chain of art_tpu/ops/perlin_kernel.py (_wanghash, _u2m11, _grad,
// _noise: reference src/perlin.cuh:6-82) on uint32_t.  The turbulence
// kernel (turb.cu, K7) and the short-path kernel (sp_step.cu, K11) both
// include it.  The plain twin is ops/perlin.py; every float32 operation
// below rounds as the twin's, in the same order (no FMA: -fmad=false), so
// the two agree bit for bit.
//
// The lattice coordinate floor(p) is cast to int32 saturating, NaN to
// INT_MIN (lattice()): a plain cast of an out-of-range float is undefined
// in C++, and a miss's point (p ~ o + 1e30 d) reaches it.  The twin clamps
// alike; no point with |p| < 2^31 changes.
//
// A corner's gradient depends on its lattice point alone and costs ~63 of
// the ~70 instructions of a corner, and the lanes of a warp mostly share
// their lattice cell (the slots of one pixel's samples sit side by side).
// So turbulence_warp, which every lane of a warp calls, groups the lanes
// that need a value by cell each octave, in rounds: each takes the cell of
// the lowest needing lane left (three shuffles and a vote).  With at most
// kNoiseGroups cells, lane L computes corner L & 7 of cell L >> 3 once and
// each lane gathers its cell's eight gradients with shuffles; above that
// the warp takes the per-lane form for the rest of its octaves.  (Grouping
// by __match_any_sync on i, j and k measured slower where the check fails,
// on incoherent inputs; PERF.md has the times.)  Both forms
// do the same operations on the same values in the same order, so every
// lane's result keeps its bits (ops/perlin.py turb_shared_p models the
// sharing).
#pragma once

#include "common.cuh"

namespace art {

constexpr float kU2m11 = (float)(1.0 / 8388607.5);  // ops/perlin.py U2M11_SCALE
constexpr int kNoiseGroups = 4;  // cells a warp shares gradients over: 4 x 8 corners

__device__ __forceinline__ uint32_t wanghash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}

__device__ __forceinline__ float u2m11(uint32_t h) {
  return (float)((h >> 8) & 0x00FFFFFFu) * kU2m11 - 1.0f;
}

__device__ __forceinline__ uint32_t lattice(float f) {
  const int i = f >= 2147483648.0f ? 2147483647
                                   : (f >= -2147483648.0f ? (int)f : (int)0x80000000u);
  return (uint32_t)i;
}

// The unit gradient of lattice point (i, j, k) (the twin's grad_p).
__device__ __forceinline__ void gradient(uint32_t i, uint32_t j, uint32_t k, float& gx,
                                         float& gy, float& gz) {
  const uint32_t h = wanghash((i * 73856093u) ^ (j * 19349663u) ^ (k * 83492791u));
  gx = u2m11(h);
  gy = u2m11(wanghash(h));
  gz = u2m11(wanghash(h ^ 0x9E3779B9u));
  const float inv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
  gx = gx * inv; gy = gy * inv; gz = gz * inv;
}

// One octave's cell of a point: its lattice corner, fractions and weights.
struct Cell {
  uint32_t i, j, k;
  float u, v, w, uu, vv, ww;
};

__device__ __forceinline__ Cell cell_of(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  Cell c;
  c.u = px - fx; c.v = py - fy; c.w = pz - fz;
  c.i = lattice(fx); c.j = lattice(fy); c.k = lattice(fz);
  c.uu = c.u * c.u * (3.0f - 2.0f * c.u);
  c.vv = c.v * c.v * (3.0f - 2.0f * c.v);
  c.ww = c.w * c.w * (3.0f - 2.0f * c.w);
  return c;
}

// accum + corner n's term (n = 4 di + 2 dj + dk, the twin's loop order)
__device__ __forceinline__ float add_corner(float accum, const Cell& c, int n, float gx,
                                            float gy, float gz) {
  const uint32_t di = n >> 2, dj = (n >> 1) & 1u, dk = n & 1u;
  const float s = (di ? c.uu : (1.0f - c.uu)) * (dj ? c.vv : (1.0f - c.vv)) *
                  (dk ? c.ww : (1.0f - c.ww));
  return accum + s * (gx * (c.u - (float)di) + gy * (c.v - (float)dj) +
                      gz * (c.w - (float)dk));
}

// One octave for one lane, every gradient its own.
__device__ __forceinline__ float noise_lane(const Cell& c) {
  float accum = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float gx, gy, gz;
    gradient(c.i + (n >> 2), c.j + ((n >> 1) & 1), c.k + (n & 1), gx, gy, gz);
    accum = add_corner(accum, c, n, gx, gy, gz);
  }
  return accum;
}

// One octave for a lane of a warp whose every lane calls it, the gradients
// shared: `need` marks the lanes that want a value (`needm` their ballot),
// the others only work.  Returns false, warp-uniformly and with `out`
// unset, when the needing lanes lie in more than kNoiseGroups cells.
__device__ __forceinline__ bool noise_shared(const Cell& c, bool need, unsigned needm,
                                             float& out) {
  const int lane = threadIdx.x & 31;
  // round 0: the cell of the first needing lane; most warps need no other
  const int first = __ffs(needm) - 1;
  uint32_t wi = __shfl_sync(kFullWarp, c.i, first);
  uint32_t wj = __shfl_sync(kFullWarp, c.j, first);
  uint32_t wk = __shfl_sync(kFullWarp, c.k, first);
  int base = 0;  // the lane's cell's first worker
  const bool in0 = !need || (c.i == wi && c.j == wj && c.k == wk);
  if (!__all_sync(kFullWarp, in0)) {
    // up to kNoiseGroups - 1 more rounds, each the cell of the lowest
    // needing lane left (rest is warp-uniform)
    unsigned rest = needm & ~__ballot_sync(kFullWarp, in0), leaders = 1u << first;
    int mine = 0;
#pragma unroll
    for (int g = 1; g < kNoiseGroups; ++g) {
      if (rest) {
        const int l = __ffs(rest) - 1;
        const uint32_t li = __shfl_sync(kFullWarp, c.i, l);
        const uint32_t lj = __shfl_sync(kFullWarp, c.j, l);
        const uint32_t lk = __shfl_sync(kFullWarp, c.k, l);
        const unsigned m = __ballot_sync(kFullWarp, c.i == li && c.j == lj && c.k == lk) & rest;
        if ((m >> lane) & 1u) mine = g;
        leaders |= 1u << l;
        rest &= ~m;
      }
    }
    if (rest) return false;
    unsigned nth = leaders;  // lane L works for the cell of leader L >> 3
#pragma unroll
    for (int g = 1; g < kNoiseGroups; ++g)
      if (g <= (lane >> 3)) nth &= nth - 1u;
    const int src = nth ? __ffs(nth) - 1 : lane;
    wi = __shfl_sync(kFullWarp, c.i, src);
    wj = __shfl_sync(kFullWarp, c.j, src);
    wk = __shfl_sync(kFullWarp, c.k, src);
    base = mine << 3;
  }
  // lane L: corner L & 7 of its cell (past the last cell, work nobody reads)
  const int n = lane & 7;
  float gx, gy, gz;
  gradient(wi + (n >> 2), wj + ((n >> 1) & 1), wk + (n & 1), gx, gy, gz);
  float accum = 0.0f;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    accum = add_corner(accum, c, m, __shfl_sync(kFullWarp, gx, base + m),
                       __shfl_sync(kFullWarp, gy, base + m),
                       __shfl_sync(kFullWarp, gz, base + m));
  out = accum;
  return true;
}

// |sum_{o < depth} 0.5^o noise(2^o p)| for the lanes with `need`, the
// octaves at o >= mask dropped (pass mask = depth for none), the gradients
// shared across the warp (module note).  Every lane of the warp calls it,
// converged; a lane without `need` gets 0.  DEPTH > 0 is the octave count
// (the loop unrolls); DEPTH = 0 takes `depth`.  A warp whose cells outgrow
// the shared form stays per lane for its remaining octaves: two points in
// two cells stay apart as the octaves double them (short of the saturated
// lattice), so the check would fail again.
template <int DEPTH>
__device__ __forceinline__ float turbulence_warp(float px, float py, float pz, bool need,
                                                 int mask, int depth = DEPTH) {
  const unsigned needm = __ballot_sync(kFullWarp, need);
  if (!needm) return 0.0f;
  const int octaves = DEPTH ? DEPTH : depth;
  float accum = 0.0f, weight = 1.0f;
  int o = 0;
#pragma unroll
  for (; o < octaves; ++o) {
    float noise;
    if (!noise_shared(cell_of(px, py, pz), need, needm, noise)) break;
    const float term = weight * noise;
    accum = accum + (o < mask ? term : 0.0f);
    weight *= 0.5f;
    px = px * 2.0f; py = py * 2.0f; pz = pz * 2.0f;
  }
  if (need) {
    for (; o < octaves; ++o) {
      const float term = weight * noise_lane(cell_of(px, py, pz));
      accum = accum + (o < mask ? term : 0.0f);
      weight *= 0.5f;
      px = px * 2.0f; py = py * 2.0f; pz = pz * 2.0f;
    }
  }
  return need ? fabsf(accum) : 0.0f;
}

}  // namespace art
