// K16 — closest sphere hit with the sphere tail in skip bins, a ray tile's
// bins split across the grid.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_skip_hit_attrs
// (_sphere_skip_kernel:1167).  The table (scene/cull.py pack_skip) is the
// head rows, then the tail of a (radius, material)-uniform cluster sorted
// along one axis into up to 16 bins of contiguous rows; the metadata `seg`
// is (1 + n_bins, 8) floats: row 0 (0, n_head, the whole tail's box), then
// (row0, row1, box) per bin.  Per ray: the closest hit over the head rows;
// then, when the ray's (t_min, inf) segment can meet the tail's box, each
// bin whose box it crosses, the bin's closest merged with a strict `<` (the
// head and earlier bins keep exact ties).  Outputs and rules are K2's
// (sphere.cuh); the plain twin is ops/intersect_kernels.py
// sphere_skip_hit_attrs_plain.  The tail-only call of the split pass
// (ops/compact_sphere.py) passes n_head = 0 and a device n_live.
//
// Bound on the H100: FP32 throughput, ~25 flops per (ray, sphere) tested: R x
// head rows, plus each bin's rows x the rays whose slab test passes; on
// final_scene's pools that is ~1% of the full table, so the bytes (7 planes
// in and 5 out a ray) bound it.
// Design (sphere.cuh spread_hit): one thread a ray that skips per warp (K16's
// first form) leaves the few warps that face the 1000-sphere cluster
// scanning most bins, up to ~1000 rows one after another, a chain ~80x the
// bound on an H100.  Here one launch has a block for each (ray
// tile of 256 lanes, group of bins) pair, the head its own group: a block
// tests each of its bins' rows against its tile's lanes that cross the
// bin's box, each such lane given 256 / lanes threads, so no thread runs
// more than one bin's rows a bin; the blocks of a tile merge by the least
// (t, row) key (a 64-bit atomicMin), bit-equal to the twin's ordered merge
// by the invariant noted at spread_hit, and the last to finish writes the
// tile's hits (a tile no lane of which crosses a bin, most of a whole
// pool's, is written by its head block alone).  Measured on an H100
// (PERF.md §6), the time is the blocks' latency chains (ray and row loads,
// barriers, the key atomics and the ticket), not FP32: a block a bin (17 a
// tile) keeps a dense tile's bins side by side, the best form on compacted
// lanes; on a whole pool most blocks find no lane, and 4 bins a block (5
// blocks a tile) spends fewer.  The skip boxes are conservative (inflated
// by 1e-3 + 1e-6 max|coord|), so the skip changes no result against the
// full table either.  K17 (sphere_cellbin.cu), and K15's spheres through
// it, run the staged group scan of sphere_group.cuh.

#include "sphere.cuh"

namespace {

// bins a block: on a whole pool, whose few needy lanes leave most blocks
// idle, 4 (5 blocks a tile); on compacted lanes (n_live), every one needy,
// 1 (17 blocks a tile), so a dense tile's bins run side by side
// (ops/intersect_kernels.py SKIP_BINS, SKIP_BINS_LIVE)
constexpr int kBinsPool = 4;
constexpr int kBinsLive = 1;

template <int kBins>
__global__ void __launch_bounds__(art::kBlock)
sphere_skip_kernel(const float* __restrict__ rows, const float* __restrict__ seg, int n_seg,
                   int n_head, int R, float t_min, const int* __restrict__ n_live,
                   unsigned long long* keys, unsigned long long* tickets,
                   art::SpherePlanes p) {
  art::spread_hit<kBins>(rows, seg, n_seg, n_head, R, t_min, n_live, keys, tickets, p);
}

template <int kBins>
int launch(const float* rows, const float* seg, int n_seg, int n_head, int R, float t_min,
           const int* n_live, void* keys, void* tickets, const art::SpherePlanes& p,
           cudaStream_t stream) {
  const long long grid =
      (long long)((R + art::kBlock - 1) / art::kBlock) * (1 + (n_seg + kBins - 1) / kBins);
  if (grid > 0)
    sphere_skip_kernel<kBins><<<(unsigned)grid, art::kBlock, 0, stream>>>(
        rows, seg, n_seg, n_head, R, t_min, n_live, (unsigned long long*)keys,
        (unsigned long long*)tickets, p);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (N, 10); seg: (1 + n_seg, 8); n_head: head rows to scan (0 for the
// tail-only call); planes as art_sphere_hit; n_live: a device int or null;
// scratch: ceil(R / 256) * 256 keys, each kMissKey, then ceil(R / 256)
// tickets, each 0 (8 bytes each), left so by every call
extern "C" int art_sphere_skip(const float* rows, const float* seg, int n_seg, int n_head,
                               int R, float t_min, const int* n_live, void* keys,
                               void* tickets, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const cudaStream_t s = (cudaStream_t)stream;
  return n_live ? launch<kBinsLive>(rows, seg, n_seg, n_head, R, t_min, n_live, keys, tickets,
                                    p, s)
                : launch<kBinsPool>(rows, seg, n_seg, n_head, R, t_min, n_live, keys, tickets,
                                    p, s);
}
