// K8 — table lookup per lane, 0 out of range.
//
// Replaces art_tpu/ops/flush_kernel.py:table_gather_u24 (:147): out[i] =
// table[idx[i]] for 0 <= idx[i] < T, else 0, over (R,) int32 indices into a
// (T,) int32 table.  On the TPU it is a one-hot MXU row select whose table
// rides as three bf16-exact bytes (hence u24); here a lane reads its entry
// directly, so any int32 value passes and the byte split is gone.  Its use
// on this path is the compacted image fetch's route-back
// (ops/compact_fetch.py): out[i] = texel_slot[rank[i]].  The plain twin is
// ops/flush_kernel.py:table_gather_u24_plain.
//
// Bound on the H100: bytes — 8 bytes a lane (index in, value out) and the
// table entries the indices reach, at most 4 T; one compare a lane.  Design:
// one thread per lane; the index and output accesses coalesce, the table
// reads are random but hit L2 (the fetch's table is the pool's R texel
// slots, 512 KB at R = 2^17).

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
table_gather_kernel(const int* __restrict__ table, int T, const int* __restrict__ idx,
                    int* __restrict__ out, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int i = idx[r];
  out[r] = (i >= 0 && i < T) ? table[i] : 0;
}

}  // namespace

// table: (T,) i32; idx, out: (R,) i32.
extern "C" int art_table_gather(const int* table, int T, const int* idx, int* out, int R,
                                void* stream) {
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    table_gather_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(table, T, idx, out,
                                                                         R);
  return (int)cudaGetLastError();
}
