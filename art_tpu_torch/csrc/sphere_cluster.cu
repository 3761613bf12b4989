// K15, spheres — closest sphere hit with the spheres in BVH-leaf clusters,
// one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_clustered (:896;
// _sphere_cluster_kernel:778).  The table (scene/cull.py cluster_tables) is
// sphere_rows in the leaf order of a BVH over the spheres' swept boxes
// (ops/bvh.py), cut into clusters of 64 rows (the last one shorter: exact row
// ranges, no inert padding rows); the metadata `seg` is (1 + n_clusters, 8)
// floats: row 0 (0, 0, the clusters' union box), then (row0, row1, box) per
// cluster, each box art_tpu's sph_cl_box bit for bit.  Per ray: when the ray
// crosses the union box, each cluster whose box it crosses at
// t_near <= its running best t (the shrinking-tmax bound of art_tpu's
// `max(t0, t_min) <= min(t1, best_t)`, :857), the cluster's closest merged
// with a strict `<`.  This is segmented_hit<true> with no head
// (sphere.cuh), so K15, K16, K17 and K2 run one candidate's arithmetic.
// The union box is a pre-test that art_tpu's kernel does not have: a ray
// that crosses a cluster's box crosses the union (the slab arithmetic is
// monotone in the box bounds), so it changes no result.  The slab guard is
// sphere.cuh's (a zero direction component becomes 1e-20) where art_tpu's
// is 1e-12: both err toward "crosses", so neither changes a result but at
// a box's rounding edge (the boxes are rounded to nearest, so conservative
// only to half an ulp).  Outputs and rules are K2's; the plain twin is
// ops/intersect_kernels.py sphere_cluster_hit_attrs_plain.
//
// Bound on the H100: bytes at the pools measured (7 planes in and 5 out a
// ray) against ~25 flops per (ray, sphere) that the rays' clusters need.
// Design: as K16 and K17, the skip unit is a warp of 32 consecutive pool
// slots (the TPU skips per 8192-lane block), rows are read from global
// memory at one address a warp, and a lane outside a cluster's box keeps its
// best, as the twin's mask.  As for K17, the serial row scans of the warps
// with the most clusters to test are expected to set the time (PERF.md §6).

#include "sphere.cuh"

namespace {

__global__ void __launch_bounds__(art::kBlock)
sphere_cluster_kernel(const float* __restrict__ rows, const float* __restrict__ seg,
                      int n_seg, int R, float t_min, art::SpherePlanes p) {
  art::segmented_hit<true>(rows, seg, n_seg, 0, R, t_min, nullptr, p);
}

}  // namespace

// rows: (N, 10); seg: (1 + n_seg, 8); planes as art_sphere_hit
extern "C" int art_sphere_cluster(const float* rows, const float* seg, int n_seg, int R,
                                  float t_min, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_cluster_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(rows, seg, n_seg,
                                                                          R, t_min, p);
  return (int)cudaGetLastError();
}
