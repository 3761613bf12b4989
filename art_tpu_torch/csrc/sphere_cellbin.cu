// K17 — closest sphere hit with the spheres in lattice cells, pruned by an
// occlusion bound, one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_cellbin_hit_attrs
// (_sphere_cellbin_kernel:1613).  The table (scene/cull.py) is the head
// rows, then the cells of a lattice, each a contiguous row range: the whole
// sphere set in a 4x4 lattice over its two largest extents (bouncing_spheres;
// the ground sphere and any sphere spanning more than 1.5 cells stay in the
// head), or a tail cluster in a 3x3x3 lattice (final_scene,
// original_scene).  The metadata `seg` is (1 + n_cells, 8) floats: row 0
// (0, n_head, the union box of the cells), then (row0, row1, box) per cell.
// Per ray: the closest hit over the head rows; then, when the ray crosses
// the union box at t_near <= its best t, each cell that it crosses at
// t_near <= its running best t (the occlusion bound of art_tpu's
// _slab_interval_tmax:1596, read after each merge), the cell's closest
// merged with a strict `<`.  Outputs and rules are K2's (sphere.cuh); the
// plain twin is ops/intersect_kernels.py sphere_cellbin_hit_attrs_plain.
//
// Bound on the H100: FP32 throughput, ~25 flops per (ray, sphere) tested: R x
// head rows, plus each cell's rows x the rays whose bounded slab test
// passes.  Design: as K16 (sphere_skip.cu), the skip unit is a warp; the
// occlusion bound drops the cells behind a ray's nearest hit so far, which
// a plain slab test cannot.  As for K16, the serial row scans of the warps
// with the most cells to test set the time on an H100 (PERF.md §6).

#include "sphere.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
sphere_cellbin_kernel(const float* __restrict__ rows, const float* __restrict__ seg,
                      int n_seg, int n_head, int R, float t_min, art::SpherePlanes p) {
  art::segmented_hit<true>(rows, seg, n_seg, n_head, R, t_min, nullptr, p);
}

}  // namespace

// rows: (N, 10); seg: (1 + n_seg, 8); planes as art_sphere_hit
extern "C" int art_sphere_cellbin(const float* rows, const float* seg, int n_seg, int n_head,
                                  int R, float t_min, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_cellbin_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        rows, seg, n_seg, n_head, R, t_min, p);
  return (int)cudaGetLastError();
}
