// K15, boxes — closest oriented-box hit with the boxes in BVH-leaf clusters,
// one thread per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:box_hit_attrs_clustered (:2601;
// _box_cluster_kernel:2482).  The table (scene/cull.py cluster_tables) is
// box_rows in the leaf order of a BVH over the boxes' world AABBs (their 8
// rotated corners; ops/bvh.py), cut into clusters of 64 rows (the last one
// shorter, no inert padding rows); the metadata `seg` is (1 + n_clusters, 8)
// floats: row 0 (0, 0, the clusters' union box), then (row0, row1, box) per
// cluster, each box art_tpu's box_cl_box bit for bit.  Per ray: the guarded
// inverses of the world direction; when art_tpu's bounded cluster test of
// the union box passes, each cluster whose test passes against the running
// best t (`max(t0, t_min) <= min(t1, best)`, :2563, with NaN-propagating
// max / min as the twin's torch.maximum), the cluster's rows scanned with
// K6's candidate (box_test, box_attrs.cuh) and its closest merged with a
// strict `<`, keeping the winner's row; then K6's winner attributes once
// (write_box_hit).  The union-box pre-test is not in art_tpu's kernel: a
// ray that passes a cluster's test passes the union's (the slab arithmetic
// is monotone in the box bounds), so it changes no result.  The boxes are
// rounded to nearest, so the test is conservative only to half an ulp.
// Both forms are templates, as K6's: kRotated (the rays in each box's frame)
// and the folded axis-aligned one.  Output (t, normal x3, u, v, mat) as K6;
// the plain twin is ops/intersect_kernels.py box_cluster_hit_attrs_plain.
//
// Bound on the H100: bytes (6 planes in and 7 out a ray) against ~40-55
// flops per (ray, box) that the rays' clusters need.  Design: one thread a
// ray and the warp as the skip unit (__any_sync on the cluster test), as
// K15's spheres and K16/K17: a warp scans a cluster's rows when one of its
// lanes passes the cluster's test, reading each row from global memory at
// one address a warp; a lane that does not pass keeps its best (the twin's
// per-lane mask).  Simple first: the scan is serial per warp.

#include "box_attrs.cuh"

namespace {

constexpr int kSegRow = 8;  // floats a segment row: row0 row1 box(6)

// art_tpu's bounded cluster test of the box (x0 y0 z0 x1 y1 z1); ix, iy, iz
// the guarded inverses of the world direction (ops/intersect.py cluster_slab)
__device__ __forceinline__ bool cluster_slab(const float* __restrict__ box, float ox,
                                             float oy, float oz, float ix, float iy,
                                             float iz, float t_min, float best) {
  const float tax = (__ldg(box + 0) - ox) * ix, tbx = (__ldg(box + 3) - ox) * ix;
  const float tay = (__ldg(box + 1) - oy) * iy, tby = (__ldg(box + 4) - oy) * iy;
  const float taz = (__ldg(box + 2) - oz) * iz, tbz = (__ldg(box + 5) - oz) * iz;
  const float t0 = art::nan_max(art::nan_max(art::nan_min(tax, tbx), art::nan_min(tay, tby)),
                                art::nan_min(taz, tbz));
  const float t1 = art::nan_min(art::nan_min(art::nan_max(tax, tbx), art::nan_max(tay, tby)),
                                art::nan_max(taz, tbz));
  return art::nan_max(t0, t_min) <= art::nan_min(t1, best);
}

template <bool kRotated>
__global__ void __launch_bounds__(art::kBlock)
box_cluster_kernel(const float* __restrict__ rows, const float* __restrict__ seg, int n_seg,
                   int R, float t_min, art::BoxPlanes p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;
  const float ix = art::safe_inv(dx), iy = art::safe_inv(dy), iz = art::safe_inv(dz);
  float best = art::kBig;
  int best_b = -1;
  const bool needy = live && cluster_slab(seg + 2, ox, oy, oz, ix, iy, iz, t_min, best);
  if (__any_sync(0xffffffffu, needy)) {
    for (int k = 1; k <= n_seg; ++k) {
      const float* m = seg + (size_t)k * kSegRow;
      const bool cross = needy && cluster_slab(m + 2, ox, oy, oz, ix, iy, iz, t_min, best);
      if (__any_sync(0xffffffffu, cross)) {
        float ct = art::kBig;
        int cb = -1;
        const int r1 = (int)__ldg(m + 1);
#pragma unroll 4
        for (int b = (int)__ldg(m); b < r1; ++b) {
          float row[11];
#pragma unroll
          for (int c = 0; c < 11; ++c) row[c] = __ldg(rows + (size_t)b * art::kBoxRow + c);
          const float t = art::box_test<kRotated>(row, ox, oy, oz, dx, dy, dz, t_min);
          if (t < ct) {
            ct = t;
            cb = b;
          }
        }
        if (cross && ct < best) {
          best = ct;
          best_b = cb;
        }
      }
    }
  }
  if (!live) return;
  const float* r = best_b < 0 ? nullptr : rows + (size_t)best_b * art::kBoxRow;
  art::write_box_hit<kRotated>(p, i, r, best, ox, oy, oz, dx, dy, dz);
}

}  // namespace

// rows: (N, 12); seg: (1 + n_seg, 8); planes as art_box_hit
extern "C" int art_box_cluster(const float* rows, const float* seg, int n_seg, int R,
                               float t_min, int rotated, void* const* planes, void* stream) {
  const art::BoxPlanes p = art::box_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0) {
    if (rotated)
      box_cluster_kernel<true><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, seg, n_seg, R, t_min, p);
    else
      box_cluster_kernel<false><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
          rows, seg, n_seg, R, t_min, p);
  }
  return (int)cudaGetLastError();
}
