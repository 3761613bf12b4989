// K12 — seam flush + refill: add every dead slot's radiance into the
// framebuffer, zero it, then K1's refill of the pool.
//
// Replaces art_tpu/ops/refill_kernel.py:fused_refill_flush_rng (:523,
// _make_rng_flush_kernel:430) and fused_refill_flush (:588), the refill of
// art_tpu's seam route (render/integrator.py:393-405, ART_TPU_SEAM_FLUSH):
// the flush of iteration i's dead rays moves to the top of iteration i + 1,
// inside the refill, so the shading adds nothing to the framebuffer.
//  * every slot with act == 0 adds (r0, r1, r2) to fb[pix] with float32
//    atomics, as K3 flushes (shade_flush.cu); a pix outside [0, P) adds
//    nothing and counts into *lost;
//  * every such slot's radiance becomes 0 (zero_dead_radiance,
//    refill_kernel.py:178), so a dead slot the queue cannot refill adds 0
//    at every later flush;
//  * then K1's refill, unchanged (refill.cuh refill_slot), in the same
//    launch: the block's scan ticket names the slots it flushes and refills.
// art_flush_dead is the flush half alone: the render's last flush, after
// the loop, of the slots that died in its last iteration.
//
// Design notes against the TPU kernel: the TPU flushes into an
// (n_hi, 384) window of the framebuffer with a one-hot bf16 MXU product
// (refill_kernel.py:413-427), because its framebuffer does not fit VMEM;
// here the (P, 3) framebuffer stays in device memory and each dead slot
// adds with three atomics, so there is no window, no base row and no bf16
// rounding.  A dead slot whose radiance is zero makes no atomic (x + 0 is
// x; the framebuffer never holds -0), which after the first flush is every
// slot the queue could not refill.
// Bound on the H100: memory — K1's traffic plus, for a dead slot, pix and
// radiance in (16 B) and radiance out (12 B), and the framebuffer adds.

#include "refill.cuh"

namespace {

struct Flush {
  float* fb;  // (P, 3) float32
  int P;
  int* lost;
};

__device__ __forceinline__ void flush_dead_slot(const art::RefillPlanes& p, int i,
                                                const Flush& fl) {
  const int px = p.pix[i];
  const float ra0 = p.r0[i], ra1 = p.r1[i], ra2 = p.r2[i];
  if (px < 0 || px >= fl.P) {
    atomicAdd(fl.lost, 1);
  } else if (ra0 != 0.f || ra1 != 0.f || ra2 != 0.f) {
    atomicAdd(fl.fb + 3 * (size_t)px + 0, ra0);
    atomicAdd(fl.fb + 3 * (size_t)px + 1, ra1);
    atomicAdd(fl.fb + 3 * (size_t)px + 2, ra2);
  }
  p.r0[i] = 0.f; p.r1[i] = 0.f; p.r2[i] = 0.f;
}

// one launch, as K1: the block's ticket names its slots, flushed before
// their refill
__global__ void __launch_bounds__(art::kBlock)
refill_flush_kernel(art::RefillArgs a, Flush fl) {
  __shared__ art::RankShared sh;
  const int blk = art::scan_ticket(a.scan, sh);
  const int i = blk * art::kBlock + threadIdx.x;
  if (i < a.R && a.p.act[i] == 0) flush_dead_slot(a.p, i, fl);
  art::refill_slot(blk, a, sh);
}

__global__ void __launch_bounds__(art::kBlock)
flush_dead(art::RefillPlanes p, int R, Flush fl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R && p.act[i] == 0) flush_dead_slot(p, i, fl);
}

}  // namespace

// ptrs: art_refill's (refill.cu); fb (f32 (P, 3)), lost (i32 (1,)).
extern "C" int art_refill_flush(void* const* ptrs, int R, int parity, int ncols,
                                int use_philox, const long long* scal, const float* cam,
                                unsigned seed, unsigned tile, unsigned chunk, unsigned it,
                                unsigned epoch, float* fb, int P, int* lost, void* stream) {
  const art::RefillArgs a = art::refill_args(ptrs, R, parity, ncols, use_philox, scal, cam,
                                             seed, tile, chunk, it, epoch);
  if (a.scan.nb == 0) return 0;
  refill_flush_kernel<<<a.scan.nb, art::kBlock, 0, (cudaStream_t)stream>>>(
      a, Flush{fb, P, lost});
  return (int)cudaGetLastError();
}

// ptrs: the 16 pool planes of art_refill's layout (only pix, r0..r2 and act
// are read, r0..r2 written); fb (f32 (P, 3)), lost (i32 (1,)).
extern "C" int art_flush_dead(void* const* ptrs, int R, float* fb, int P, int* lost,
                              void* stream) {
  const art::RefillPlanes p = art::refill_planes(ptrs);
  const int nb = (R + art::kBlock - 1) / art::kBlock;
  if (nb > 0)
    flush_dead<<<nb, art::kBlock, 0, (cudaStream_t)stream>>>(p, R, Flush{fb, P, lost});
  return (int)cudaGetLastError();
}
