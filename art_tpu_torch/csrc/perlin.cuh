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
#pragma once

#include <stdint.h>

namespace art {

constexpr float kU2m11 = (float)(1.0 / 8388607.5);  // ops/perlin.py U2M11_SCALE

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

__device__ __forceinline__ float perlin_noise(float px, float py, float pz) {
  const float fx = floorf(px), fy = floorf(py), fz = floorf(pz);
  const float u = px - fx, v = py - fy, w = pz - fz;
  const uint32_t i = lattice(fx), j = lattice(fy), k = lattice(fz);
  const float uu = u * u * (3.0f - 2.0f * u);
  const float vv = v * v * (3.0f - 2.0f * v);
  const float ww = w * w * (3.0f - 2.0f * w);
  float accum = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint32_t di = c >> 2, dj = (c >> 1) & 1u, dk = c & 1u;
    const uint32_t h = wanghash(((i + di) * 73856093u) ^ ((j + dj) * 19349663u) ^
                                ((k + dk) * 83492791u));
    float gx = u2m11(h);
    float gy = u2m11(wanghash(h));
    float gz = u2m11(wanghash(h ^ 0x9E3779B9u));
    const float inv = 1.0f / sqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
    gx = gx * inv; gy = gy * inv; gz = gz * inv;
    const float s = (di ? uu : (1.0f - uu)) * (dj ? vv : (1.0f - vv)) *
                    (dk ? ww : (1.0f - ww));
    accum = accum + s * (gx * (u - (float)di) + gy * (v - (float)dj) +
                         gz * (w - (float)dk));
  }
  return accum;
}

// |sum_{o < depth} 0.5^o noise(2^o p)|, the octaves at o >= mask dropped
// (pass mask = depth for none).
__device__ __forceinline__ float turbulence(float px, float py, float pz, int depth,
                                            int mask) {
  float accum = 0.0f, weight = 1.0f;
  for (int o = 0; o < depth; ++o) {
    const float term = weight * perlin_noise(px, py, pz);
    accum = accum + (o < mask ? term : 0.0f);
    weight *= 0.5f;
    px = px * 2.0f; py = py * 2.0f; pz = pz * 2.0f;
  }
  return fabsf(accum);
}

}  // namespace art
