// K4 — windowed scatter-add over the lanes that died.
//
// Replaces art_tpu/ops/flush_kernel.py:flush_accumulate (:196): for every
// lane r with died[r] whose framebuffer row (pix[r] >> 7, a logical shift)
// lies in the window [base, base + n_hi),
//   fb[(pix[r] >> 7) - base, c * 128 + (pix[r] & 127)] += v[c][r],  c < C,
// with 1 <= C <= 6 float32 channels; other lanes add nothing.  On the TPU it
// is a one-hot MXU product with bf16 operands (one_hot_accumulate); here it
// is one thread per lane and a float32 atomicAdd per channel, so values are
// not rounded to bf16 and colliding lanes sum in a run-dependent order.  Its
// use on this path is the compacted image fetch (ops/compact_fetch.py): pix =
// the lane's rank among the needy lanes, one channel = its ray id, so every
// slot takes exactly one add and the result is exact and deterministic.
// base is a (1,) device tensor, so the window moves without a host read
// (null: the window starts at row 0).
// The plain twin is ops/flush_kernel.py:flush_accumulate_plain
// (index_put_(accumulate=True) on the flat view).
//
// Bound on the H100: bytes — 5 bytes a lane (pix, died) and 4 a channel of
// the lanes that died, one read-modify-write of 4 bytes per add; about 4
// operations a lane.  Design: one thread per lane, coalesced loads of the
// (R,) planes; the adds go to L2 atomics.  A lane that did not die exits
// after one byte.

#include "common.cuh"

namespace {

constexpr int kMaxChan = 6;
constexpr int kLanes = 128;  // framebuffer row width per channel (the TPU's lane count)

struct Channels {
  const float* v[kMaxChan];
};

__global__ void __launch_bounds__(art::kBlock)
flush_accumulate_kernel(const int* __restrict__ pix, const uint8_t* __restrict__ died,
                        Channels ch, int n_chan, float* fb, int n_hi,
                        const int* __restrict__ base, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || !died[r]) return;
  const unsigned p = (unsigned)pix[r];
  const long long hi = (long long)(p >> 7) - (base ? (long long)base[0] : 0LL);
  if (hi < 0 || hi >= n_hi) return;
  float* row = fb + hi * (long long)(n_chan * kLanes) + (p & (kLanes - 1));
  for (int c = 0; c < n_chan; ++c) atomicAdd(row + c * kLanes, ch.v[c][r]);
}

}  // namespace

// pix: (R,) i32; died: (R,) u8 (bool); vals: n_chan pointers to (R,) f32;
// fb: (n_hi, n_chan * 128) f32, accumulated in place; base: (1,) i32 or null.
extern "C" int art_flush_accumulate(const int* pix, const uint8_t* died,
                                    const float* const* vals, int n_chan, float* fb,
                                    int n_hi, const int* base, int R, void* stream) {
  if (n_chan < 1 || n_chan > kMaxChan) return (int)cudaErrorInvalidValue;
  Channels ch = {};
  for (int c = 0; c < n_chan; ++c) ch.v[c] = vals[c];
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    flush_accumulate_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        pix, died, ch, n_chan, fb, n_hi, base, R);
  return (int)cudaGetLastError();
}
