// K1 — pool refill: rank the dead slots, hand them the next queue elements,
// make their camera rays, and draw the iteration's uniforms.
//
// Replaces art_tpu/ops/refill_kernel.py:fused_refill_rng (:284,
// _make_rng_kernel:236) and fused_refill (:341), i.e. what
// _refill_compute:57-201 computes:
//  * a global exclusive rank of the dead slots (act == 0);
//  * queue id q = next_q + rank -> (pixel row, sample) in sample-major
//    order: p_row = q / spp; taken when q < n_q = P * spp;
//  * pixel = min(pix_offset + p_row, total_pixels - 1), with `pix` storing
//    the tile-relative p_row;
//  * sub-pixel jitter, the thin-lens + shutter camera ray
//    (src/camera.cuh:35-47), and the masked merge into the 16 pool planes;
//  * the total taken: next_q advances on the device (q[1 - parity]), so
//    the host never reads it to refill.
// It also adds this iteration's live-slot count (after the refill) into
// hist[it]: the integrator's ray count and its loop-exit test.
// Uniforms: with use_philox, every column of the iteration's block
// (core/rng.py layout) comes from Philox4x32-10 keyed (seed, tile) with
// counter (slot, it, chunk, k); the ball(3), choice(1) and media columns are
// written to `u` for the shade stage.  Otherwise `u` is the injected
// (ncols, R) block and the refill reads its jitter/lens/time columns.
//
// Design notes against the TPU kernel:
//  (a) the TPU carries the running dead count across its sequential grid in
//      SMEM.  Blocks here run in any order, so there are two launches:
//      refill_count writes each block's dead count; refill_apply has every
//      block sum the counts of the blocks before it (R/256 = 512 values at
//      R = 2^17) and rank inside the block by warp ballot + popc.
//  (b) the TPU splits q into f32-exact (p_base, s_base) with reciprocal
//      corrections because Mosaic has no integer division; here q is int64
//      and the split is plain / and %.
//  (c) next_q is double-buffered (q[parity] in, q[1 - parity] out), written
//      by block 0 from the total dead count, so no block reads a value
//      another block is writing.
// Bound on the H100: memory — the pool's 16 planes are read and, for taken
// slots, written (~64 B in, up to ~64 B + 4 * (4 + n_media) B out per
// slot); the block-count scan adds R/256 loads per block.  The pool is
// updated in place.  The rank, the Philox draw, the camera ray and the
// queue-head update are refill.cuh's, shared with the short-path kernel.

#include "refill.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
refill_apply(art::RefillPlanes p, int R, const int* __restrict__ block_dead, int nb,
             long long* q, int parity, unsigned long long* hist, art::Scal sc,
             art::Cam cam, float* u_buf, int ncols, int use_philox, uint32_t seed,
             uint32_t tile, uint32_t chunk, uint32_t it) {
  __shared__ int red[32];
  __shared__ int warp_cnt[32];
  art::refill_slot(p, R, block_dead, nb, q, parity, hist, sc, cam, u_buf, ncols, use_philox,
                   seed, tile, chunk, it, red, warp_cnt);
}

}  // namespace

// ptrs: ox oy oz dx dy dz tm t0 t1 t2 r0 r1 r2 (f32), bounce pix (i32),
//       act (u8), u (f32 (ncols|4+n_media, R)), block_dead (i32 scratch,
//       ceil(R/256)), q (i64 x2), hist (i64, > it entries).
// scal: spp, P, pix_offset, total_pixels, nx, ny.  cam: pack_camera layout.
extern "C" int art_refill(void* const* ptrs, int R, int parity, int ncols,
                          int use_philox, const long long* scal, const float* cam,
                          unsigned seed, unsigned tile, unsigned chunk, unsigned it,
                          void* stream) {
  const art::RefillArgs a = art::refill_args(ptrs, scal, cam);
  const int nb = (R + art::kBlock - 1) / art::kBlock;
  if (nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  art::refill_count<<<nb, art::kBlock, 0, s>>>(a.p.act, R, a.block_dead);
  refill_apply<<<nb, art::kBlock, 0, s>>>(a.p, R, a.block_dead, nb, a.q, parity, a.hist,
                                          a.sc, a.cam, a.u_buf, ncols, use_philox, seed,
                                          tile, chunk, it);
  return (int)cudaGetLastError();
}
