// The per-pixel warp flush shared by K11 (sp_step.cu) and K3
// (shade_flush.cu): fb[pix] += radiance for a warp's slots that died, their
// deaths of one pixel summed in the warp first and added with one float32
// atomicAdd a channel.  In a render the samples of one pixel sit side by
// side in the pool, so up to 32 slots of a warp die into one pixel; a flush
// of one atomicAdd a slot would serialise them on one address.  Ported from
// the flush art_tpu runs after its shading (refill_kernel.py _flush_dead:415
// -> flush_kernel.one_hot_accumulate), which sums on the MXU instead.
#pragma once

#include "common.cuh"

namespace art {

// fb[pix] += (r0, r1, r2) for the lanes with `flush`, one atomicAdd a channel
// per pixel of the warp: a pixel's lanes are summed pairwise in lane order
// (after step k each lane holds the sum of its own and the next 2^k - 1
// lanes of its pixel, so the lowest holds the pixel's), then its lowest lane
// adds.  Every lane of the warp calls it, converged (ops/sp_kernel.py
// flush_warp_p models the order).
__device__ __forceinline__ void flush_warp(bool flush, int pix, float r0, float r1, float r2,
                                           float* fb) {
  const unsigned fm = __ballot_sync(kFullWarp, flush);
  if (!fm) return;
  const int lane = threadIdx.x & 31;
  const unsigned same = __match_any_sync(kFullWarp, pix) & fm;
  int next = flush ? __ffs(same & (0xfffffffeu << lane)) - 1 : -1;  // -1: none above
  const unsigned most = __reduce_max_sync(kFullWarp, flush ? __popc(same) : 0u);
  for (unsigned span = 1; span < most; span <<= 1) {
    const int src = next >= 0 ? next : lane;
    const float a0 = __shfl_sync(kFullWarp, r0, src);
    const float a1 = __shfl_sync(kFullWarp, r1, src);
    const float a2 = __shfl_sync(kFullWarp, r2, src);
    const int further = __shfl_sync(kFullWarp, next, src);
    if (next >= 0) {
      r0 = r0 + a0; r1 = r1 + a1; r2 = r2 + a2;
      next = further;
    }
  }
  if (flush && __ffs(same) - 1 == lane) {
    atomicAdd(fb + 3 * (size_t)pix + 0, r0);
    atomicAdd(fb + 3 * (size_t)pix + 1, r1);
    atomicAdd(fb + 3 * (size_t)pix + 2, r2);
  }
}

}  // namespace art
