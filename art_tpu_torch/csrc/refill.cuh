// The refill of one pool iteration as device functions, shared by the
// refill kernel (refill.cu, K1), the seam flush + refill (refill_flush.cu,
// K12) and the short-path kernel (sp_step.cu, K11), so all three hand out
// queue elements, draw uniforms and make camera rays with the same
// operations and agree bit for bit.  What they compute is refill.cu's
// header note.  Each is one launch a call: the global dead rank is a
// single-pass scan across the blocks by decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016).  The pieces, in the order a kernel calls them (every thread of the
// block calls each but philox_uniforms and camera_ray):
//  * scan_ticket: the block's place in the scan, from an atomic ticket in
//    the order blocks start, so a block waits only on blocks that run; the
//    block refills slots ticket * 256 + threadIdx.x, so ranks follow slot
//    order;
//  * rank_count: the block's dead count, published at once, and each
//    slot's rank inside the block (with kCountSet, of the slots whose flag
//    is set: K4's compaction form, compact.cu, counts the needy lanes);
//  * rank_prefix: the block's exclusive prefix from its predecessors'
//    published words (look_back) and its own inclusive prefix published;
//  * rank_resolve: rank_prefix, then whether the slot takes a queue
//    element;
//  * philox_uniforms: the Philox calls of the slot's uniform columns that
//    the caller needs;
//  * camera_ray: the fresh ray of a taken slot;
//  * refill_finish: the live-slot count into hist[it] and, from the block
//    with the last ticket, the next queue head;
//  * refill_slot: all of the above for K1 and K12, with the draws that do
//    not depend on the rank made while the predecessors publish; K12 passes
//    a hook that flushes there too.
#pragma once

#include "common.cuh"

namespace art {

constexpr int kMaxCols = 16;  // ncols = 9 + max(n_media, 1) <= 16
constexpr int kWarps = kBlock / 32;

struct RefillPlanes {
  float *ox, *oy, *oz, *dx, *dy, *dz, *tm, *t0, *t1, *t2, *r0, *r1, *r2;
  int *bounce, *pix;
  uint8_t* act;
};

struct Scal { long long spp, P, pix_offset, total_pixels, nx, ny; };
struct Cam { float v[21]; };

// The look-back scratch, kept with the pool across calls (no memset a
// call): one 64-bit word a block, (epoch << 32) | status | value, then the
// ticket counter, which atomicInc returns to 0 after the last ticket.  A
// call stamps its words with its own epoch (from the host, never 0 and never
// a previous call's), so a word left by an earlier call reads as not yet
// published.  Values (counts and prefixes, <= R) take 30 bits.  A word is
// written and read whole by strong relaxed operations at GPU scope: it
// carries all a reader needs, so no other write has to be ordered before
// it.  (Release and acquire, as the scan's paper has them, made every block
// wait for its own earlier stores before it published: 1.5-2.5 us a call on
// the H100, PERF.md section 6.)
struct Scan {
  unsigned long long* flags;  // nb words
  unsigned* ticket;           // the word after them
  uint32_t epoch;
  int nb;
};
constexpr unsigned long long kAggregate = 1ull << 30;  // the block's count
constexpr unsigned long long kPrefix = 2ull << 30;     // its inclusive prefix
constexpr unsigned long long kStatus = 3ull << 30;
constexpr unsigned long long kValue = (1ull << 30) - 1;

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

// the scratch of nb + 1 64-bit words at `words`
inline Scan scan_of(void* words, int R, uint32_t epoch) {
  const int nb = (R + kBlock - 1) / kBlock;
  unsigned long long* w = (unsigned long long*)words;
  return Scan{w, (unsigned*)(w + nb), epoch, nb};
}

// the block's shared scratch
struct RankShared {
  int blk;     // the block's ticket
  int before;  // dead slots of the blocks before it
  int total;   // dead slots up to and including it
  int warp_cnt[kWarps];
};

struct Rank {
  int i;         // the slot: blk * kBlock + threadIdx.x
  bool live;     // i < R
  bool was_act;  // its flag is set: live before the refill (needy, in compact.cu)
  bool take;     // dead and handed queue element qq
  int in_block;  // counted slots (dead, or with kCountSet flagged) before it in its block
  int count;     // counted slots in its block
  long long qq;
};

__device__ __forceinline__ void publish(unsigned long long* word, uint32_t epoch,
                                        unsigned long long status, int value) {
  const unsigned long long w = ((unsigned long long)epoch << 32) | status | (unsigned)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* word) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
  return w;
}

__device__ __forceinline__ int scan_ticket(const Scan& s, RankShared& sh) {
  if (threadIdx.x == 0) sh.blk = (int)atomicInc(s.ticket, (unsigned)(s.nb - 1));
  __syncthreads();
  return sh.blk;
}

// counts the live slots whose flag is clear (the dead ones), or with
// kCountSet those whose flag is set
template <bool kCountSet = false>
__device__ __forceinline__ Rank rank_count(int blk, const uint8_t* act, int R, const Scan& s,
                                           RankShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Rank r;
  r.i = blk * kBlock + threadIdx.x;
  r.live = r.i < R;
  r.was_act = r.live && act[r.i] != 0;
  const unsigned m = __ballot_sync(kFullWarp, kCountSet ? r.was_act : r.live && !r.was_act);
  if (lane == 0) sh.warp_cnt[warp] = __popc(m);
  __syncthreads();
  r.in_block = __popc(m & ((1u << lane) - 1u));
  r.count = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int c = sh.warp_cnt[k];
    r.count += c;
    if (k < warp) r.in_block += c;
  }
  // the first block's count is its inclusive prefix
  if (threadIdx.x == 0) publish(s.flags + blk, s.epoch, blk ? kAggregate : kPrefix, r.count);
  r.take = false;
  r.qq = 0;
  return r;
}

// The sum of the counts of blocks 0..blk-1, by the 32 lanes of one warp:
// lane L reads block j - L's word, nearest first; a window is summed up to
// and including its nearest inclusive prefix (then done) or, with none, in
// full (then the next 32 blocks).  A lane whose word is not this call's, or
// not yet published, makes the window read again.
__device__ __forceinline__ int look_back(const Scan& s, int blk) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int j = blk - 1;; j -= 32) {
    const int k = j - lane;
    unsigned long long w;
    unsigned prefix, need, ready;
    do {
      w = k >= 0 ? peek(s.flags + k) : (((unsigned long long)s.epoch << 32) | kPrefix);
      const bool mine = (uint32_t)(w >> 32) == s.epoch && (w & kStatus) != 0;
      ready = __ballot_sync(kFullWarp, mine);
      prefix = __ballot_sync(kFullWarp, mine && (w & kStatus) == kPrefix);
      need = prefix ? ((prefix & (0u - prefix)) << 1) - 1u : 0xffffffffu;
    } while ((ready & need) != need);
    sum += __reduce_add_sync(kFullWarp, ((need >> lane) & 1u) ? (int)(w & kValue) : 0);
    if (prefix) return sum;
  }
}

// sh.before and sh.total of the block (every thread waits for them)
__device__ __forceinline__ void rank_prefix(const Rank& r, const Scan& s, RankShared& sh) {
  const int blk = sh.blk;
  if ((threadIdx.x >> 5) == 0) {
    const int before = blk ? look_back(s, blk) : 0;
    if (threadIdx.x == 0) {
      if (blk) publish(s.flags + blk, s.epoch, kPrefix, before + r.count);
      sh.before = before;
      sh.total = before + r.count;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void rank_resolve(Rank& r, const Scan& s, const long long* q,
                                             int parity, const Scal& sc, RankShared& sh) {
  rank_prefix(r, s, sh);
  r.qq = q[parity] + sh.before + r.in_block;
  r.take = r.live && !r.was_act && r.qq < sc.P * sc.spp;
}

// Philox call k gives columns 4k..4k+3 of the slot's block (core/rng.py);
// it is made where bit k of `calls` is set and 4k < ncols.  Being counter
// based, a call gives the same bits whichever others are made.
__device__ __forceinline__ void philox_uniforms(int i, uint32_t seed, uint32_t tile,
                                                uint32_t chunk, uint32_t it, int ncols,
                                                unsigned calls, float* u) {
#pragma unroll
  for (int k = 0; k < kMaxCols / 4; ++k) {
    if (4 * k < ncols && ((calls >> k) & 1u)) {
      const U4 r = philox4x32(U4{(uint32_t)i, it, chunk, (uint32_t)k}, seed, tile);
      u[4 * k + 0] = to_unit(r.x);
      u[4 * k + 1] = to_unit(r.y);
      u[4 * k + 2] = to_unit(r.z);
      u[4 * k + 3] = to_unit(r.w);
    }
  }
}
constexpr unsigned kCameraCall = 1u << 1;  // columns 4..7: jitter and lens

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

__device__ __forceinline__ void refill_finish(bool live_after, const Scan& s, long long* q,
                                              int parity, unsigned long long* hist,
                                              uint32_t it, const Scal& sc,
                                              const RankShared& sh) {
  const int cnt = __syncthreads_count(live_after);
  if (threadIdx.x == 0) {
    if (cnt) atomicAdd(&hist[it], (unsigned long long)cnt);
    if (sh.blk == s.nb - 1) {  // the last ticket: sh.total is every dead slot
      const long long q0 = q[parity], n_q = sc.P * sc.spp;
      const long long room = n_q > q0 ? n_q - q0 : 0;
      q[1 - parity] = q0 + (sh.total < room ? sh.total : room);
    }
  }
}

// The launch arguments of K1 and K12 (refill.cu's art_refill layout).
struct RefillArgs {
  RefillPlanes p;
  float* u_buf;
  Scan scan;
  long long* q;
  unsigned long long* hist;
  Scal sc;
  Cam cam;
  int R, parity, ncols, use_philox;
  uint32_t seed, tile, chunk, it;
};

inline RefillArgs refill_args(void* const* ptrs, int R, int parity, int ncols,
                              int use_philox, const long long* scal, const float* cam,
                              uint32_t seed, uint32_t tile, uint32_t chunk, uint32_t it,
                              uint32_t epoch) {
  RefillArgs a;
  a.p = refill_planes(ptrs);
  a.u_buf = (float*)ptrs[16];
  a.scan = scan_of(ptrs[17], R, epoch);
  a.q = (long long*)ptrs[18];
  a.hist = (unsigned long long*)ptrs[19];
  a.sc = Scal{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5]};
  for (int k = 0; k < 21; ++k) a.cam.v[k] = cam[k];
  a.R = R; a.parity = parity; a.ncols = ncols; a.use_philox = use_philox;
  a.seed = seed; a.tile = tile; a.chunk = chunk; a.it = it;
  return a;
}

// K1's refill_slot hook: nothing between its steps.  Every thread of the
// block calls a hook's steps: `counted` once the block's count is
// published (before the rank-free uniform draws), `drawn` after those
// draws and before the look-back, `resolved` after the look-back, once
// `take` is known, before a taken slot's ray is written.
struct NoHook {
  __device__ __forceinline__ void counted(const Rank&, const RefillPlanes&) {}
  __device__ __forceinline__ void drawn() {}
  __device__ __forceinline__ void resolved(const Rank&, const RefillPlanes&) {}
};

// The refill of slot blk * kBlock + threadIdx.x (refill.cu's header note):
// rank, uniforms, camera ray, live count and queue head.  The count is
// published first; the uniforms every live slot writes (Philox mode: every
// call but the camera's) are drawn while the predecessors publish theirs,
// and so is the hook's work (K12's flush: its loads issued before the
// draws, its sums and atomics after them).
template <class Hook = NoHook>
__device__ __forceinline__ void refill_slot(int blk, const RefillArgs& a, RankShared& sh,
                                            Hook hook = Hook()) {
  const RefillPlanes& p = a.p;
  const int R = a.R;
  Rank r = rank_count(blk, p.act, R, a.scan, sh);
  const int i = r.i;

  hook.counted(r, p);

  // ---- the iteration's uniforms for this slot ----
  float u[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) u[c] = 0.f;
  if (r.live && a.use_philox) {
    philox_uniforms(i, a.seed, a.tile, a.chunk, a.it, a.ncols, ~kCameraCall, u);
    // ball(3) + choice(1) -> rows 0..3, media columns 9.. -> rows 4..
#pragma unroll
    for (int c = 0; c < 4; ++c) a.u_buf[(size_t)c * R + i] = u[c];
#pragma unroll
    for (int c = 9; c < kMaxCols; ++c)
      if (c < a.ncols) a.u_buf[(size_t)(c - 5) * R + i] = u[c];
  }
  hook.drawn();
  rank_resolve(r, a.scan, a.q, a.parity, a.sc, sh);
  hook.resolved(r, p);

  // ---- fresh camera ray for a taken slot ----
  if (r.take) {
    if (a.use_philox) {
      philox_uniforms(i, a.seed, a.tile, a.chunk, a.it, a.ncols, kCameraCall, u);
    } else {
#pragma unroll
      for (int c = 4; c < 9; ++c) u[c] = a.u_buf[(size_t)c * R + i];
    }
    const Ray ray = camera_ray(r.qq, a.sc, a.cam, u);
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
  refill_finish(r.was_act || r.take, a.scan, a.q, a.parity, a.hist, a.it, a.sc, sh);
}

}  // namespace art
