// K16 — closest sphere hit with the sphere tail in skip bins, one thread per
// ray.
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
// head rows, plus each bin's rows x the rays whose slab test passes.
// Design: the skip unit is a warp of 32 consecutive pool slots (the TPU
// skips per 8192-lane block): a warp scans a bin when one of its lanes
// crosses the bin's box.  Rows are read straight from global memory at one
// address per warp (an L1 broadcast; the table is 40 KB), so warps that take
// different bins never wait on each other at a barrier.  The boxes are
// conservative (inflated by 1e-3 + 1e-6 max|coord|), so the skip changes no
// result; a lane outside a bin's box keeps its best, as the twin's mask.
// Measured on an H100 (PERF.md §6), the few warps that face the cluster and
// scan most bins, one row after another, set the time, far above the FP32
// bound; spreading a ray's rows over a warp is later work.

#include "sphere.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
sphere_skip_kernel(const float* __restrict__ rows, const float* __restrict__ seg, int n_seg,
                   int n_head, int R, float t_min, const int* __restrict__ n_live,
                   art::SpherePlanes p) {
  art::segmented_hit<false>(rows, seg, n_seg, n_head, R, t_min, n_live, p);
}

}  // namespace

// rows: (N, 10); seg: (1 + n_seg, 8); n_head: head rows to scan (0 for the
// tail-only call); planes as art_sphere_hit; n_live: a device int or null
extern "C" int art_sphere_skip(const float* rows, const float* seg, int n_seg, int n_head,
                               int R, float t_min, const int* n_live, void* const* planes,
                               void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_skip_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, seg, n_seg, n_head, R, t_min, n_live, p);
  return (int)cudaGetLastError();
}
