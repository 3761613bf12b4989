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
// updated in place.

#include "common.cuh"

namespace {

constexpr int kMaxCols = 16;  // ncols = 9 + max(n_media, 1) <= 16

struct RefillPlanes {
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm, *t0, *t1, *t2, *r0, *r1, *r2;
  int *bounce, *pix;
  uint8_t* act;
};

struct Scal { long long spp, P, pix_offset, total_pixels, nx, ny; };
struct Cam { float v[21]; };

__device__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // `red` may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) tot += red[k];
  return tot;
}

__global__ void __launch_bounds__(art::kBlock)
refill_count(const uint8_t* __restrict__ act, int R, int* __restrict__ block_dead) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = __syncthreads_count(i < R && act[i] == 0);
  if (threadIdx.x == 0) block_dead[blockIdx.x] = n;
}

__global__ void __launch_bounds__(art::kBlock)
refill_apply(RefillPlanes p, int R, const int* __restrict__ block_dead, int nb,
             long long* q, int parity, unsigned long long* hist, Scal sc, Cam cam,
             float* u_buf, int ncols, int use_philox, uint32_t seed,
             uint32_t tile, uint32_t chunk, uint32_t it) {
  __shared__ int red[32];
  __shared__ int warp_cnt[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- global exclusive rank of this slot among the dead ----
  int acc = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += blockDim.x) acc += block_dead[k];
  const int before = block_sum(acc, red);
  const bool live = i < R;
  const bool was_act = live && p.act[i] != 0;
  const bool dead = live && !was_act;
  const unsigned m = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int in_block = __popc(m & ((1u << lane) - 1u));
  for (int k = 0; k < warp; ++k) in_block += warp_cnt[k];
  const long long q0 = q[parity];
  const long long n_q = sc.P * sc.spp;
  const long long qq = q0 + before + in_block;
  const bool take = dead && qq < n_q;

  // ---- the iteration's uniforms for this slot ----
  float u[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) u[c] = 0.f;
  if (live && use_philox) {
#pragma unroll
    for (int k = 0; k < kMaxCols / 4; ++k) {
      if (4 * k < ncols) {
        const art::U4 r = art::philox4x32(
            art::U4{(uint32_t)i, it, chunk, (uint32_t)k}, seed, tile);
        u[4 * k + 0] = art::to_unit(r.x);
        u[4 * k + 1] = art::to_unit(r.y);
        u[4 * k + 2] = art::to_unit(r.z);
        u[4 * k + 3] = art::to_unit(r.w);
      }
    }
    // ball(3) + choice(1) -> rows 0..3, media columns 9.. -> rows 4..
#pragma unroll
    for (int c = 0; c < 4; ++c) u_buf[(size_t)c * R + i] = u[c];
#pragma unroll
    for (int c = 9; c < kMaxCols; ++c)
      if (c < ncols) u_buf[(size_t)(c - 5) * R + i] = u[c];
  } else if (take) {
#pragma unroll
    for (int c = 4; c < 9; ++c) u[c] = u_buf[(size_t)c * R + i];
  }

  // ---- fresh camera ray for a taken slot ----
  if (take) {
    const long long p_row = qq / sc.spp;
    long long pixel = sc.pix_offset + p_row;
    if (pixel > sc.total_pixels - 1) pixel = sc.total_pixels - 1;
    const float s = ((float)(pixel % sc.nx) + u[4]) / (float)sc.nx;
    const float t = ((float)(pixel / sc.nx) + u[5]) / (float)sc.ny;
    const float* cv = cam.v;
    const float r = cv[18] * sqrtf(u[6]);
    const float phi = art::kTwoPi * u[7];
    const float rdx = r * cosf(phi), rdy = r * sinf(phi);
    const float ox = cv[0] + rdx * cv[12] + rdy * cv[15];
    const float oy = cv[1] + rdx * cv[13] + rdy * cv[16];
    const float oz = cv[2] + rdx * cv[14] + rdy * cv[17];
    p.ox[i] = ox; p.oy[i] = oy; p.oz[i] = oz;
    p.dx[i] = cv[3] + s * cv[6] + t * cv[9] - ox;
    p.dy[i] = cv[4] + s * cv[7] + t * cv[10] - oy;
    p.dz[i] = cv[5] + s * cv[8] + t * cv[11] - oz;
    p.tm[i] = cv[19] + u[8] * (cv[20] - cv[19]);
    p.t0[i] = 1.f; p.t1[i] = 1.f; p.t2[i] = 1.f;
    p.r0[i] = 0.f; p.r1[i] = 0.f; p.r2[i] = 0.f;
    p.bounce[i] = 0;
    p.pix[i] = (int)p_row;
    p.act[i] = 1;
  }

  // ---- live slots this iteration, and the next queue head ----
  const int cnt = __syncthreads_count(was_act || take);
  if (threadIdx.x == 0 && cnt) atomicAdd(&hist[it], (unsigned long long)cnt);
  if (blockIdx.x == 0) {
    int all = 0;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) all += block_dead[k];
    const long long total_dead = block_sum(all, red);
    if (threadIdx.x == 0) {
      const long long room = n_q > q0 ? n_q - q0 : 0;
      q[1 - parity] = q0 + (total_dead < room ? total_dead : room);
    }
  }
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
  RefillPlanes p;
  float** f = (float**)ptrs;
  p.ox = f[0]; p.oy = f[1]; p.oz = f[2]; p.dx = f[3]; p.dy = f[4]; p.dz = f[5];
  p.tm = f[6]; p.t0 = f[7]; p.t1 = f[8]; p.t2 = f[9]; p.r0 = f[10]; p.r1 = f[11];
  p.r2 = f[12];
  p.bounce = (int*)ptrs[13]; p.pix = (int*)ptrs[14]; p.act = (uint8_t*)ptrs[15];
  float* u_buf = (float*)ptrs[16];
  int* block_dead = (int*)ptrs[17];
  long long* q = (long long*)ptrs[18];
  unsigned long long* hist = (unsigned long long*)ptrs[19];
  Scal sc{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5]};
  Cam c;
  for (int k = 0; k < 21; ++k) c.v[k] = cam[k];
  const int nb = (R + art::kBlock - 1) / art::kBlock;
  if (nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  refill_count<<<nb, art::kBlock, 0, s>>>(p.act, R, block_dead);
  refill_apply<<<nb, art::kBlock, 0, s>>>(p, R, block_dead, nb, q, parity, hist, sc,
                                          c, u_buf, ncols, use_philox, seed, tile,
                                          chunk, it);
  return (int)cudaGetLastError();
}
