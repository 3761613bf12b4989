// K4's compaction form — the needy lanes' ids, count, rank and payload in
// one launch.
//
// Replaces art_tpu/ops/flush_kernel.py:flush_accumulate (:196) as
// art_tpu/ops/compact_fetch.py:192 compact_ray_ids calls it (pix = the
// exclusive needy rank, died = needy, one channel = the ray id), with the jnp
// around that call in art_tpu/ops/compact_sphere.py: the needy count, the
// rank, and the gather of the ray planes at the compacted ids.  For (R,) u8
// needy and n_planes <= 6 (R,) f32 planes it writes
//  * ids (S,) i32, S = ceil(R / 128) * 128: slot j holds the index of the
//    j-th needy lane in lane order, every slot at or past the count 0;
//  * cnt (1,) i32: the needy count (it stays on the device);
//  * rank (R,) i32, unless null: each lane's exclusive needy rank;
//  * out[c] (S,) f32: plane c of the lane in slot j, for j below the count;
//    the slots past it are left unspecified (every consumer reads only the
//    first cnt).
// The plain twin is ops/compact_fetch.py compact(..., plain=True): the
// cumsum rank, K4's flush form scattering the ray ids, needy.sum and one
// index_select of the stacked planes, about ten launches.
//
// Design: one thread a lane, blocks of 256 that take their lanes in the
// order of an atomic ticket; the rank is refill.cuh's single-pass
// look-back scan (rank_count counting the needy lanes by warp ballot and
// popc, the block's count published at once, its exclusive prefix from
// rank_prefix), on a scratch of its own that the wrapper keeps per (device,
// number of blocks), each call stamped with a fresh epoch.  A needy lane
// loads its payload while its block's predecessors publish.  Each slot is
// written exactly once, with no atomic and no memset: a needy lane writes
// its id and payload to slot rank; a lane that is not needy, the m-th such
// lane (m = i - rank), writes 0 to slot S - 1 - m.  Those writes cover
// [cnt + S - R, S); the block with the last ticket knows cnt and zeroes the
// pad [cnt, cnt + S - R), fewer than 128 slots (none where R is a multiple
// of 128, as on the card's pools).
// Bound on the H100: bytes — needy in (R), ids out (4 S), cnt out (4), a
// needy lane's payload in and out (8 a plane), rank out (4 R) when asked.

#include "refill.cuh"

namespace {

constexpr int kMaxPlanes = 6;
constexpr int kSlotAlign = 128;  // S = ceil(R / 128) * 128 (the TPU's lane count)

struct Planes {
  const float* in[kMaxPlanes];
  float* out[kMaxPlanes];
};

__global__ void __launch_bounds__(art::kBlock)
compact_kernel(const uint8_t* __restrict__ needy, int R, int S, Planes pl, int n_planes,
               int* __restrict__ ids, int* __restrict__ cnt, int* __restrict__ rank,
               art::Scan s) {
  __shared__ art::RankShared sh;
  const int blk = art::scan_ticket(s, sh);
  const art::Rank r = art::rank_count<true>(blk, needy, R, s, sh);
  const int i = r.i;
  float v[kMaxPlanes];
#pragma unroll
  for (int c = 0; c < kMaxPlanes; ++c) v[c] = c < n_planes && r.was_act ? pl.in[c][i] : 0.f;
  art::rank_prefix(r, s, sh);
  if (r.live) {
    const int k = sh.before + r.in_block;
    if (rank) rank[i] = k;
    if (r.was_act) {
      ids[k] = i;
#pragma unroll
      for (int c = 0; c < kMaxPlanes; ++c)
        if (c < n_planes) pl.out[c][k] = v[c];
    } else {
      ids[S - 1 - (i - k)] = 0;
    }
  }
  if (blk == s.nb - 1) {  // the last ticket: sh.total is the needy count
    const int total = sh.total;
    if (threadIdx.x == 0) *cnt = total;
    for (int j = total + threadIdx.x; j < total + (S - R); j += art::kBlock) ids[j] = 0;
  }
}

}  // namespace

// needy: (R,) u8; in, out: n_planes (<= 6) pointers to (R,) and (S,) f32
// planes; ids: (S,) i32; cnt: (1,) i32; rank: (R,) i32 or null; scan: the
// look-back scratch (ceil(R / 256) + 1 64-bit words, kept across calls);
// epoch: this call's stamp of its words, never 0 and never one an earlier
// call on this scratch used.
extern "C" int art_compact(const uint8_t* needy, int R, const float* const* in,
                           float* const* out, int n_planes, int* ids, int* cnt, int* rank,
                           void* scan, unsigned epoch, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes || R < 0 || R >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  Planes pl = {};
  for (int c = 0; c < n_planes; ++c) {
    pl.in[c] = in[c];
    pl.out[c] = out[c];
  }
  const int S = (R + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
  const art::Scan s = art::scan_of(scan, R, epoch);
  if (s.nb > 0)
    compact_kernel<<<s.nb, art::kBlock, 0, (cudaStream_t)stream>>>(needy, R, S, pl, n_planes,
                                                                  ids, cnt, rank, s);
  return (int)cudaGetLastError();
}
