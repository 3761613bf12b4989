// The refill of one pool iteration as device functions, shared by the
// refill kernel (refill.cu, K1) and the short-path kernel (sp_step.cu,
// K11), so both hand out queue elements, draw uniforms and make camera rays
// with the same operations and agree bit for bit.  What they compute is
// refill.cu's header note; the pieces, in the order a kernel calls them:
//  * refill_count (a kernel of its own, the first launch): each block's
//    dead-slot count;
//  * refill_rank: the slot's global dead rank and whether it takes a queue
//    element (every thread of the block calls it);
//  * philox_uniforms: the iteration's uniform columns for the slot;
//  * camera_ray: the fresh ray of a taken slot;
//  * refill_finish: the live-slot count into hist[it] and, from block 0,
//    the next queue head (every thread of the block calls it);
//  * refill_slot: all of the above after refill_count, for the calling
//    thread's slot (K1's refill_apply, and K12's after its flush).
#pragma once

#include "common.cuh"

namespace art {

constexpr int kMaxCols = 16;  // ncols = 9 + max(n_media, 1) <= 16

struct RefillPlanes {
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm, *t0, *t1, *t2, *r0, *r1, *r2;
  int *bounce, *pix;
  uint8_t* act;
};

struct Scal { long long spp, P, pix_offset, total_pixels, nx, ny; };
struct Cam { float v[21]; };

// ptrs[0..15]: ox oy oz dx dy dz tm t0 t1 t2 r0 r1 r2 (f32), bounce pix
// (i32), act (u8)
inline RefillPlanes refill_planes(void* const* ptrs) {
  RefillPlanes p;
  float** f = (float**)ptrs;
  p.ox = f[0]; p.oy = f[1]; p.oz = f[2]; p.dx = f[3]; p.dy = f[4]; p.dz = f[5];
  p.tm = f[6]; p.t0 = f[7]; p.t1 = f[8]; p.t2 = f[9]; p.r0 = f[10]; p.r1 = f[11];
  p.r2 = f[12];
  p.bounce = (int*)ptrs[13]; p.pix = (int*)ptrs[14]; p.act = (uint8_t*)ptrs[15];
  return p;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // `red` may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) tot += red[k];
  return tot;
}

namespace {
__global__ void __launch_bounds__(kBlock)
refill_count(const uint8_t* __restrict__ act, int R, int* __restrict__ block_dead) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = __syncthreads_count(i < R && act[i] == 0);
  if (threadIdx.x == 0) block_dead[blockIdx.x] = n;
}
}  // namespace

struct Rank {
  bool live;     // i < R
  bool was_act;  // live before the refill
  bool take;     // dead and handed queue element qq
  long long qq, q0, n_q;
};

__device__ __forceinline__ Rank refill_rank(const uint8_t* act, int R,
                                            const int* __restrict__ block_dead,
                                            const long long* q, int parity, const Scal& sc,
                                            int* red, int* warp_cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += blockDim.x) acc += block_dead[k];
  const int before = block_sum(acc, red);
  Rank r;
  r.live = i < R;
  r.was_act = r.live && act[i] != 0;
  const bool dead = r.live && !r.was_act;
  const unsigned m = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) warp_cnt[warp] = __popc(m);
  __syncthreads();
  int in_block = __popc(m & ((1u << lane) - 1u));
  for (int k = 0; k < warp; ++k) in_block += warp_cnt[k];
  r.q0 = q[parity];
  r.n_q = sc.P * sc.spp;
  r.qq = r.q0 + before + in_block;
  r.take = dead && r.qq < r.n_q;
  return r;
}

// columns 4k..4k+3 of the slot's block from Philox call k (core/rng.py)
__device__ __forceinline__ void philox_uniforms(int i, uint32_t seed, uint32_t tile,
                                                uint32_t chunk, uint32_t it, int ncols,
                                                float* u) {
#pragma unroll
  for (int k = 0; k < kMaxCols / 4; ++k) {
    if (4 * k < ncols) {
      const U4 r = philox4x32(U4{(uint32_t)i, it, chunk, (uint32_t)k}, seed, tile);
      u[4 * k + 0] = to_unit(r.x);
      u[4 * k + 1] = to_unit(r.y);
      u[4 * k + 2] = to_unit(r.z);
      u[4 * k + 3] = to_unit(r.w);
    }
  }
}

struct Ray { float ox, oy, oz, dx, dy, dz, tm; int p_row; };

// the camera ray of queue element qq from the jitter/lens/time columns u[4..8]
__device__ __forceinline__ Ray camera_ray(long long qq, const Scal& sc, const Cam& cam,
                                          const float* u) {
  const long long p_row = qq / sc.spp;
  long long pixel = sc.pix_offset + p_row;
  if (pixel > sc.total_pixels - 1) pixel = sc.total_pixels - 1;
  const float s = ((float)(pixel % sc.nx) + u[4]) / (float)sc.nx;
  const float t = ((float)(pixel / sc.nx) + u[5]) / (float)sc.ny;
  const float* cv = cam.v;
  const float r = cv[18] * sqrtf(u[6]);
  const float phi = kTwoPi * u[7];
  const float rdx = r * cosf(phi), rdy = r * sinf(phi);
  Ray ray;
  ray.ox = cv[0] + rdx * cv[12] + rdy * cv[15];
  ray.oy = cv[1] + rdx * cv[13] + rdy * cv[16];
  ray.oz = cv[2] + rdx * cv[14] + rdy * cv[17];
  ray.dx = cv[3] + s * cv[6] + t * cv[9] - ray.ox;
  ray.dy = cv[4] + s * cv[7] + t * cv[10] - ray.oy;
  ray.dz = cv[5] + s * cv[8] + t * cv[11] - ray.oz;
  ray.tm = cv[19] + u[8] * (cv[20] - cv[19]);
  ray.p_row = (int)p_row;
  return ray;
}

__device__ __forceinline__ void refill_finish(bool live_after, const int* block_dead,
                                              int nb, long long* q, int parity,
                                              unsigned long long* hist, uint32_t it,
                                              const Rank& r, int* red) {
  const int cnt = __syncthreads_count(live_after);
  if (threadIdx.x == 0 && cnt) atomicAdd(&hist[it], (unsigned long long)cnt);
  if (blockIdx.x == 0) {
    int all = 0;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) all += block_dead[k];
    const long long total_dead = block_sum(all, red);
    if (threadIdx.x == 0) {
      const long long room = r.n_q > r.q0 ? r.n_q - r.q0 : 0;
      q[1 - parity] = r.q0 + (total_dead < room ? total_dead : room);
    }
  }
}

// The refill of slot blockIdx.x * blockDim.x + threadIdx.x after
// refill_count: rank, uniforms, camera ray, live count and queue head
// (refill.cu's header note).  Every thread of the block calls it; `red` and
// `warp_cnt` are the block's __shared__ int[32] scratch.
__device__ __forceinline__ void refill_slot(const RefillPlanes& p, int R,
                                            const int* __restrict__ block_dead, int nb,
                                            long long* q, int parity, unsigned long long* hist,
                                            const Scal& sc, const Cam& cam, float* u_buf,
                                            int ncols, int use_philox, uint32_t seed,
                                            uint32_t tile, uint32_t chunk, uint32_t it,
                                            int* red, int* warp_cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const Rank r = refill_rank(p.act, R, block_dead, q, parity, sc, red, warp_cnt);

  // ---- the iteration's uniforms for this slot ----
  float u[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) u[c] = 0.f;
  if (r.live && use_philox) {
    philox_uniforms(i, seed, tile, chunk, it, ncols, u);
    // ball(3) + choice(1) -> rows 0..3, media columns 9.. -> rows 4..
#pragma unroll
    for (int c = 0; c < 4; ++c) u_buf[(size_t)c * R + i] = u[c];
#pragma unroll
    for (int c = 9; c < kMaxCols; ++c)
      if (c < ncols) u_buf[(size_t)(c - 5) * R + i] = u[c];
  } else if (r.take) {
#pragma unroll
    for (int c = 4; c < 9; ++c) u[c] = u_buf[(size_t)c * R + i];
  }

  // ---- fresh camera ray for a taken slot ----
  if (r.take) {
    const Ray ray = camera_ray(r.qq, sc, cam, u);
    p.ox[i] = ray.ox; p.oy[i] = ray.oy; p.oz[i] = ray.oz;
    p.dx[i] = ray.dx; p.dy[i] = ray.dy; p.dz[i] = ray.dz;
    p.tm[i] = ray.tm;
    p.t0[i] = 1.f; p.t1[i] = 1.f; p.t2[i] = 1.f;
    p.r0[i] = 0.f; p.r1[i] = 0.f; p.r2[i] = 0.f;
    p.bounce[i] = 0;
    p.pix[i] = ray.p_row;
    p.act[i] = 1;
  }

  // ---- live slots this iteration, and the next queue head ----
  refill_finish(r.was_act || r.take, block_dead, nb, q, parity, hist, it, r, red);
}

// The launch arguments common to K1 and K12 (refill.cu's art_refill layout).
struct RefillArgs {
  RefillPlanes p;
  float* u_buf;
  int* block_dead;
  long long* q;
  unsigned long long* hist;
  Scal sc;
  Cam cam;
};

inline RefillArgs refill_args(void* const* ptrs, const long long* scal, const float* cam) {
  RefillArgs a;
  a.p = refill_planes(ptrs);
  a.u_buf = (float*)ptrs[16];
  a.block_dead = (int*)ptrs[17];
  a.q = (long long*)ptrs[18];
  a.hist = (unsigned long long*)ptrs[19];
  a.sc = Scal{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5]};
  for (int k = 0; k < 21; ++k) a.cam.v[k] = cam[k];
  return a;
}

}  // namespace art
