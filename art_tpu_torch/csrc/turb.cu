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
// Bound on the H100: operations — 16 (20 with the mask) bytes a lane
// against ~650 integer and float operations per octave (8 lattice corners
// x 3 Wang hashes, a gradient normalisation and the trilinear blend).
// Design: one thread per lane, everything in registers; a masked lane runs
// every octave and drops the terms past its count, as the twin does.

#include "common.cuh"
#include "perlin.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
turb_kernel(const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ pz, const int* __restrict__ mask, float* out,
            int R, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  out[i] = art::turbulence(px[i], py[i], pz[i], depth, mask ? mask[i] : depth);
}

}  // namespace

// px, py, pz, out: (R,) f32; mask: (R,) i32 or null.
extern "C" int art_turb(const float* px, const float* py, const float* pz,
                        const int* mask, float* out, int R, int depth, void* stream) {
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    turb_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(px, py, pz, mask, out,
                                                                R, depth);
  return (int)cudaGetLastError();
}
