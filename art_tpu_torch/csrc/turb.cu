// K7 — multi-octave Perlin turbulence over planes of points.
//
// Replaces art_tpu/ops/perlin_kernel.py:turb_pallas (:113): out[i] =
// |sum_{o < depth} 0.5^o noise(2^o p_i)| for (R,) float32 planes px, py,
// pz, with an optional (R,) int32 per-lane octave count (depth_mask: the
// octaves at o >= mask[i] are dropped).  Depth is 7 for the marble texture
// and 2 for felt.  The marble formula's sin stays outside, in PyTorch, as on
// the TPU (perlin_kernel.py:12-13).  The hash chain is perlin.cuh, shared
// with the short-path kernel (sp_step.cu); the plain twin is ops/perlin.py
// turb_p, bit for bit.  The TPU's R % 8192 rule is its layout's; any R works.
//
// Bound on the H100: operations.  16 (20 with the mask) bytes a lane
// against a per-lane blend (~174 operations an octave: floor, fractions,
// smoothstep, 8 weights and dots) and ~59 operations per distinct lattice
// gradient (3 Wang hashes, u2m11, the normalisation), mostly integer work
// that -fmad=false and the IEEE sqrt and division keep long.  Design: one thread
// per lane, everything in registers; the warp shares its lattice gradients
// (perlin.cuh turbulence_warp: one gradient a (cell, corner) when the warp's
// points lie in at most 4 cells, the per-lane form otherwise), so a warp of
// one pixel's samples makes 8 gradients an octave, not 256.  The
// octave loop is unrolled for depth 7 (marble) and 2 (felt).  A masked lane
// runs every octave and drops the terms past its count, as the twin does;
// lanes past R work for the others and write nothing.

#include "common.cuh"
#include "perlin.cuh"

namespace {

template <int DEPTH>
__global__ void __launch_bounds__(art::kBlock)
turb_kernel(const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ pz, const int* __restrict__ mask, float* out,
            int R, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float t = art::turbulence_warp<DEPTH>(
      live ? px[i] : 0.0f, live ? py[i] : 0.0f, live ? pz[i] : 0.0f, live,
      live && mask ? mask[i] : depth, depth);
  if (live) out[i] = t;
}

}  // namespace

// px, py, pz, out: (R,) f32; mask: (R,) i32 or null.
extern "C" int art_turb(const float* px, const float* py, const float* pz,
                        const int* mask, float* out, int R, int depth, void* stream) {
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (depth == 7)
    turb_kernel<7><<<grid, art::kBlock, 0, s>>>(px, py, pz, mask, out, R, depth);
  else if (depth == 2)
    turb_kernel<2><<<grid, art::kBlock, 0, s>>>(px, py, pz, mask, out, R, depth);
  else
    turb_kernel<0><<<grid, art::kBlock, 0, s>>>(px, py, pz, mask, out, R, depth);
  return (int)cudaGetLastError();
}
