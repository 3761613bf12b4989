// Shared constants and helpers for the art_tpu_torch kernels.
//
// Built by art_tpu_torch/ops/_build.py with nvcc -fmad=false and without
// --use_fast_math: every a*b+c below rounds twice, as in the plain PyTorch
// twins and in art_tpu, and sqrtf / division are IEEE-rounded.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace art {

constexpr int kBlock = 256;             // threads per block, one ray per thread
constexpr float kBig = 1e30f;           // core/vecmath.py BIG
constexpr float kTwoPi = 6.28318548f;   // float32(2*pi), as 2.0*math.pi rounds
constexpr unsigned kFullWarp = 0xffffffffu;

// Philox4x32-10 (Salmon et al., SC 2011); core/rng.py:philox4x32 is the
// plain twin and gives the same bits.
struct U4 { uint32_t x, y, z, w; };

__device__ __forceinline__ U4 philox4x32(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
  }
  return c;
}

// torch.maximum / torch.minimum: a NaN operand is returned
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.minimum / torch.maximum as far as a comparison can tell: a NaN
// operand gives a NaN (canonical, where nan_min returns the operand), in one
// instruction
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 32 random bits -> float32 U[0,1) with 24 bits (core/rng.py:to_unit)
__device__ __forceinline__ float to_unit(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

}  // namespace art
