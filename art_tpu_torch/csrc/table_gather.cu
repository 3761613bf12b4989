// K8 — table lookup per lane, 0 out of range; and its fetch form, the image
// atlas's texel fetch in one launch.
//
// Replaces art_tpu/ops/flush_kernel.py:table_gather_u24 (:147): out[i] =
// table[idx[i]] for 0 <= idx[i] < T, else 0, over (R,) int32 indices into a
// (T,) int32 table.  On the TPU it is a one-hot MXU row select whose table
// rides as three bf16-exact bytes (hence u24); here a lane reads its entry
// directly, so any int32 value passes and the byte split is gone.  Its use
// is the compacted image fetch's route-back (ops/compact_fetch.py): out[i] =
// texel_slot[rank[i]].  The plain twin is
// ops/flush_kernel.py:table_gather_u24_plain.
//
// Bound on the H100: bytes — 8 bytes a lane (index in, value out) and the
// table entries the indices reach, at most 4 T; one compare a lane.  Design:
// one thread per lane; the index and output accesses coalesce, the table
// reads are random but hit L2 (the fetch's table is the pool's R texel
// slots, 512 KB at R = 2^17).
//
// The fetch form (art_atlas_fetch) replaces the whole compacted fetch of an
// image texel: art_tpu/ops/flush_kernel.py:table_gather_u24 (:147) and
// flush_accumulate (:196) as art_tpu/ops/compact_fetch.py:87 compact_gather
// calls them, with art_tpu/utils/images.py ImageAtlas.sample's texel index
// before and its unpack after.  For each lane r with needy[r]:
//   id = clamp(img, 0, n - 1), w = widths[id], h = heights[id],
//   i = min(int(clamp(u, 0, 1) * float(w)), w - 1),
//   j = min(int((1 - clamp(v, 0, 1)) * float(h)), h - 1),
//   px = lookup(data, (id * hmax + j) * wmax + i),
//   out[c][r] = float((px >> 8c) & 0xFF) * float32(1/255),  c = 0, 1, 2;
// a lane that is not needy loads nothing more and writes 0.0.  The TPU
// compacts the needy lanes because its gather is a one-hot MXU product; on
// the H100 a masked lane loads nothing, so this is art_tpu's dense form off
// the TPU (art_tpu/ops/texture_eval.py gates the compaction on tpu_paths()).
// The clamp keeps a NaN, as torch.clamp does, and the casts are CUDA's
// (cvt.rzi: NaN -> 0), so on the card the kernel equals its plain twin
// (ops/flush_kernel.py:atlas_fetch_plain) on every lane, a NaN u or v
// included; x86 PyTorch casts a NaN to INT_MIN, so the twin on the CPU
// differs there alone.  Bound on the H100: bytes — 13 a lane (needy in,
// three float32 planes out) and 16 a needy lane (img, u, v in, its texel),
// at most 3.8 MB and 0.0011 ms at R = 2^17 with every lane needy; about 26
// operations a needy lane.  Design:
// one thread a lane, coalesced planes, widths and heights through the
// read-only path, the texel load predicated on needy.

#include "common.cuh"

namespace {

constexpr float kUnpack = 0x1.010102p-8f;  // float32(1/255) (ops/flush_kernel.py UNPACK_SCALE)

// table[i] for 0 <= i < T, else 0 (K8's lookup, both forms)
__device__ __forceinline__ int table_lookup(const int* __restrict__ table, int T, int i) {
  return (i >= 0 && i < T) ? __ldg(table + i) : 0;
}

// torch.clamp(x, 0, 1): a NaN stays NaN
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(art::kBlock)
table_gather_kernel(const int* __restrict__ table, int T, const int* __restrict__ idx,
                    int* __restrict__ out, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  out[r] = table_lookup(table, T, idx[r]);
}

__global__ void __launch_bounds__(art::kBlock)
atlas_fetch_kernel(const int* __restrict__ data, int T, const int* __restrict__ widths,
                   const int* __restrict__ heights, int n, int hmax, int wmax,
                   const int* __restrict__ img, const float* __restrict__ u,
                   const float* __restrict__ v, const uint8_t* __restrict__ needy,
                   float* __restrict__ out, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (needy[r]) {
    const int id = min(max(img[r], 0), n - 1);
    const int w = __ldg(widths + id), h = __ldg(heights + id);
    const int i = min((int)(clamp01(u[r]) * (float)w), w - 1);
    const float flip = 1.0f - clamp01(v[r]);  // rounded before the multiply
    const int j = min((int)(flip * (float)h), h - 1);
    const int px = table_lookup(data, T, (id * hmax + j) * wmax + i);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = (float)((px >> (8 * c)) & 0xFF) * kUnpack;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(size_t)c * R + r] = rgb[c];
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

// data: (T,) i32 packed texels; widths, heights: (n,) i32; img: (R,) i32;
// u, v: (R,) f32; needy: (R,) u8 (bool); out: (3, R) f32.
extern "C" int art_atlas_fetch(const int* data, int T, const int* widths, const int* heights,
                               int n, int hmax, int wmax, const int* img, const float* u,
                               const float* v, const uint8_t* needy, float* out, int R,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    atlas_fetch_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        data, T, widths, heights, n, hmax, wmax, img, u, v, needy, out, R);
  return (int)cudaGetLastError();
}
