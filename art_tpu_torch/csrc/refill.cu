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
//      SMEM.  Blocks here run in any order, so the rank is a single-pass
//      scan by decoupled look-back (refill.cuh): a block takes a ticket,
//      counts its dead slots by warp ballot + popc, publishes the count at
//      once and its inclusive prefix when it knows it, and reads its
//      predecessors' words, 32 at a time, back to the nearest prefix.  One
//      launch a call; the scratch lives with the pool, each call's words
//      stamped with a fresh epoch (ops/refill_kernel.py scan_scratch).
//  (b) the TPU splits q into f32-exact (p_base, s_base) with reciprocal
//      corrections because Mosaic has no integer division; here q is int64
//      and the split is plain / and %.
//  (c) next_q is double-buffered (q[parity] in, q[1 - parity] out), written
//      by the block with the last ticket from the inclusive total, so no
//      block reads a value another block is writing.
//  (d) a slot that takes no queue element makes no Philox call for the
//      camera's columns (4..7): Philox is counter-based, so the others keep
//      their bits; the calls every live slot writes out are made before the
//      look-back, while the predecessors publish.
// Bound on the H100: memory — act of every slot in, the uniform planes out
// (4 + n_media floats a slot) and a taken slot's 16 planes out (61 B); the
// Philox calls (two or three a slot, integer operations) are a tenth of
// it.  The pool is updated in place.  The rank, the Philox draw, the camera
// ray and the queue-head update are refill.cuh's, shared with K11 and K12.

#include "refill.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock) refill_kernel(art::RefillArgs a) {
  __shared__ art::RankShared sh;
  art::refill_slot(art::scan_ticket(a.scan, sh), a, sh);
}

}  // namespace

// ptrs: ox oy oz dx dy dz tm t0 t1 t2 r0 r1 r2 (f32), bounce pix (i32),
//       act (u8), u (f32 (ncols|4+n_media, R)), scan (the look-back
//       scratch: ceil(R/256) + 1 64-bit words, kept across calls), q (i64
//       x2), hist (i64, > it entries).
// scal: spp, P, pix_offset, total_pixels, nx, ny.  cam: pack_camera layout.
// epoch: this call's stamp of the scan words, never 0 and never one an
// earlier call on this scratch used.
extern "C" int art_refill(void* const* ptrs, int R, int parity, int ncols,
                          int use_philox, const long long* scal, const float* cam,
                          unsigned seed, unsigned tile, unsigned chunk, unsigned it,
                          unsigned epoch, void* stream) {
  const art::RefillArgs a = art::refill_args(ptrs, R, parity, ncols, use_philox, scal, cam,
                                             seed, tile, chunk, it, epoch);
  if (a.scan.nb == 0) return 0;
  refill_kernel<<<a.scan.nb, art::kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
