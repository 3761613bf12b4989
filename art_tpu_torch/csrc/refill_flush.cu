// K12 — seam flush + refill: add every dead slot's radiance into the
// framebuffer, zero it, then K1's refill of the pool.
//
// Replaces art_tpu/ops/refill_kernel.py:fused_refill_flush_rng (:523,
// _make_rng_flush_kernel:430) and fused_refill_flush (:588), the refill of
// art_tpu's seam route (render/integrator.py:393-405, ART_TPU_SEAM_FLUSH):
// the flush of iteration i's dead rays moves to the top of iteration i + 1,
// inside the refill, so the shading adds nothing to the framebuffer.
//  * every slot with act == 0 adds (r0, r1, r2) to fb[pix]; a pix outside
//    [0, P) adds nothing and counts into *lost;
//  * every such slot's radiance becomes 0 (zero_dead_radiance,
//    refill_kernel.py:178), so a dead slot the queue cannot refill adds 0
//    at every later flush;
//  * then K1's refill (refill.cuh refill_slot), in the same launch: the
//    block's scan ticket names the slots it flushes and refills.
// art_flush_dead is the flush half alone: the render's last flush, after
// the loop, of the slots that died in its last iteration.
//
// Design notes against the TPU kernel: the TPU flushes into an
// (n_hi, 384) window of the framebuffer with a one-hot bf16 MXU product
// (refill_kernel.py:413-427), because its framebuffer does not fit VMEM;
// here the (P, 3) framebuffer stays in device memory, with no window, no
// base row and no bf16 rounding:
//  * the flush is flush_warp's (flush_warp.cuh, shared with K3 and K11): the
//    refill hands out queue elements in sample-major order, so the samples
//    of one pixel sit side by side in the pool and up to 32 deaths of a warp
//    fall on one pixel; they are summed in the warp first and added with
//    one float32 atomicAdd a channel, not one a slot on a shared address.
//    So the framebuffer is summed pairwise in lane order per pixel
//    (ops/sp_kernel.py flush_warp_p), within 1e-6 relative of the twin's
//    per-slot adds, not bit-equal to them.  A dead slot whose radiance is
//    zero makes no atomic (x + 0 is x; the framebuffer never holds -0),
//    which after the first flush is every slot the queue could not refill;
//  * K1's refill_slot publishes the block's dead count before anything
//    else; the flush (SeamFlush, its hook) needs no rank, so it runs while
//    the predecessors publish: its loads are issued before the rank-free
//    uniform draws, its sums and atomics made after them, before the
//    look-back.  It reads act once (the rank's was_act);
//  * the zero radiance is written only where the refill leaves the slot
//    dead (and its radiance is not already +0): a taken slot gets the
//    refill's own zero.
// Bound on the H100: memory — K1's traffic plus, for a dead slot, pix and
// radiance in (16 B) and radiance out (12 B), and the framebuffer adds.

#include "flush_warp.cuh"
#include "refill.cuh"

namespace {

struct Flush {
  float* fb;  // (P, 3) float32
  int P;
  int* lost;
};

// One lane's dead slot, read: its pix and radiance.
struct DeadSlot {
  bool dead;
  int pix;
  float r0, r1, r2;
};

__device__ __forceinline__ DeadSlot read_dead(const art::RefillPlanes& p, int i, bool dead) {
  DeadSlot s{dead, 0, 0.f, 0.f, 0.f};
  if (dead) {
    s.pix = p.pix[i];
    s.r0 = p.r0[i]; s.r1 = p.r1[i]; s.r2 = p.r2[i];
  }
  return s;
}

// The slot into the framebuffer (every lane of the warp calls it,
// converged); true where its radiance is still to be zeroed.
__device__ __forceinline__ bool flush_slot(const DeadSlot& s, const Flush& fl) {
  const bool inside = s.pix >= 0 && s.pix < fl.P;
  if (s.dead && !inside) atomicAdd(fl.lost, 1);
  const bool lit = s.r0 != 0.f || s.r1 != 0.f || s.r2 != 0.f;
  art::flush_warp(s.dead && inside && lit, s.pix, s.r0, s.r1, s.r2, fl.fb);
  return s.dead && (__float_as_uint(s.r0) | __float_as_uint(s.r1) | __float_as_uint(s.r2));
}

__device__ __forceinline__ void zero_radiance(const art::RefillPlanes& p, int i) {
  p.r0[i] = 0.f; p.r1[i] = 0.f; p.r2[i] = 0.f;
}

// refill_slot's hook: the dead slot read once the block's count is
// published, flushed after the rank-free draws, its radiance zeroed once the
// rank says the slot stays dead
struct SeamFlush {
  Flush fl;
  DeadSlot s;
  bool zero;
  __device__ __forceinline__ void counted(const art::Rank& r, const art::RefillPlanes& p) {
    s = read_dead(p, r.i, r.live && !r.was_act);
  }
  __device__ __forceinline__ void drawn() { zero = flush_slot(s, fl); }
  __device__ __forceinline__ void resolved(const art::Rank& r, const art::RefillPlanes& p) {
    if (zero && !r.take) zero_radiance(p, r.i);
  }
};

// one launch, as K1: the block's ticket names its slots
__global__ void __launch_bounds__(art::kBlock)
refill_flush_kernel(art::RefillArgs a, Flush fl) {
  __shared__ art::RankShared sh;
  art::refill_slot(art::scan_ticket(a.scan, sh), a, sh, SeamFlush{fl, {}, false});
}

__global__ void __launch_bounds__(art::kBlock)
flush_dead(art::RefillPlanes p, int R, Flush fl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool dead = i < R && p.act[i] == 0;
  if (flush_slot(read_dead(p, i, dead), fl)) zero_radiance(p, i);
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
