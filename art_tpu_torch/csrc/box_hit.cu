// K6 — closest oriented-box hit with winner attributes, one thread per ray,
// alone or merged into the running closest hit.
//
// Replaces art_tpu/ops/pallas_kernels.py:box_hit_attrs_planar (:2139;
// _box_kernel:1943, _box_write_winner_attrs:2053).  Box rows are
// [min(3) max(3) cos sin off(3) mat] (scene/tables.py box_rows, the layout of
// pack_boxes: with no rotated box the offsets are folded into min/max).
// Per ray and box: the ray in the box frame (o - off, then R(-theta), only
// in the rotated form), the slab test with the 1e-12 division guard
// (_safe_div_dir), t = t_entry if through and > t_min, else t_exit if
// through and > t_min, else BIG; the scan keeps the first box in scene
// order with a strict `<`.  Then, for the winner only, the slab is run once
// more to find the face: the entry face if |t - t_entry| <= |t - t_exit|,
// else the exit face; the normal faces against the ray and is rotated back
// to world; u, v are make_box's per-face coordinates (src/quad.cuh:145-162).
// The candidate (box_test), the winner's attributes and the output are
// shared with K15's boxes (box_cluster.cu), the slab guard and the
// attributes with K9/K10, through box_attrs.cuh.  Output (t, normal x3, u,
// v, mat); a miss writes t = BIG, normal (1, 0, 0), u = v = 0, material 0
// (the values closest_surface_p blends in for misses).
// The guard keeps every slab factor finite (|1/d| <= 1e12), so min/max see
// no NaN.  Both forms are templates: kRotated (cornell_box) and the folded
// axis-aligned one.  Plain twin: ops/intersect_kernels.py box_hit_attrs_plain
// (= intersect.box_candidates_p + box_attributes_p over the same rows), same
// operations in the same order; the twin always applies the rotation, which
// for an unrotated box (cos 1, sin 0) changes at most the sign of a zero.
//
// The merge form (kMerge) takes the running closest hit of the kinds before
// the boxes (K5's quads: t, normal, u, v, mat) in the seven planes and
// updates it in place (box_attrs.cuh merge_box_hit): the scan starts at the
// incoming t, and only a lane where a box is strictly closer computes the
// winner's attributes and writes.  It is _closer(best, K6) in one launch,
// bit for bit (plain twin: ops/intersect_kernels.py
// box_hit_attrs_merge_plain); art_tpu merges after its kernel in jnp
// (art_tpu/ops/intersect.py:593-595, 726-740).
//
// Bound on the H100: memory.  The plain form at B = 2 (cornell_box): 6
// planes in and 7 out per ray, 52 B, 6.8 MB at R = 2^17, against ~54
// operations per (ray, box).  The merge form: 6 ray planes and the incoming
// t in per ray (28 B), 28 B out per lane a box wins.
// Design: box rows staged through shared memory in tiles of kTile rows, read
// as broadcasts; the scan carries only (t, index), and the winner's row is
// read from the last tile staged, still in shared memory (every row when
// B <= kTile), else from global memory (48 B, cached).

#include "box_attrs.cuh"

namespace {

constexpr int kTile = 512;

template <bool kRotated, bool kMerge>
__global__ void __launch_bounds__(art::kBlock)
box_hit_kernel(const float* __restrict__ rows, int B, int R, float t_min,
               art::BoxPlanes p) {
  __shared__ float sh[kTile * art::kBoxRow];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f,
              oz = live ? p.oz[i] : 0.f;
  const float dx = live ? p.dx[i] : 0.f, dy = live ? p.dy[i] : 0.f,
              dz = live ? p.dz[i] : 1.f;

  float best = kMerge && live ? p.t[i] : art::kBig;
  int best_b = -1;
  int base = 0;  // the first row of the tile in shared memory
  for (int next = 0; next < B; next += kTile) {
    base = next;
    const int n = min(kTile, B - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * art::kBoxRow; k += blockDim.x)
      sh[k] = rows[(size_t)base * art::kBoxRow + k];
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float t = art::box_test<kRotated>(sh + b * art::kBoxRow, ox, oy, oz, dx, dy, dz,
                                              t_min);
      if (t < best) {
        best = t;
        best_b = base + b;
      }
    }
  }
  if (!live) return;
  const float* r = best_b < 0 ? nullptr
                   : best_b >= base ? sh + (best_b - base) * art::kBoxRow
                                    : rows + (size_t)best_b * art::kBoxRow;
  if (kMerge)
    art::merge_box_hit<kRotated>(p, i, r, best, ox, oy, oz, dx, dy, dz);
  else
    art::write_box_hit<kRotated>(p, i, r, best, ox, oy, oz, dx, dy, dz);
}

template <bool kMerge>
void launch(const float* rows, int B, int R, float t_min, int rotated,
            const art::BoxPlanes& p, cudaStream_t stream) {
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid == 0) return;
  if (rotated)
    box_hit_kernel<true, kMerge><<<grid, art::kBlock, 0, stream>>>(rows, B, R, t_min, p);
  else
    box_hit_kernel<false, kMerge><<<grid, art::kBlock, 0, stream>>>(rows, B, R, t_min, p);
}

}  // namespace

// planes: ox oy oz dx dy dz (in), t nx ny nz u v (f32) mat (i32) (out; with
// merge, in and out: the running closest hit); all (R,)
extern "C" int art_box_hit(const float* rows, int B, int R, float t_min, int rotated,
                           int merge, void* const* planes, void* stream) {
  const art::BoxPlanes p = art::box_planes(planes);
  if (merge)
    launch<true>(rows, B, R, t_min, rotated, p, (cudaStream_t)stream);
  else
    launch<false>(rows, B, R, t_min, rotated, p, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
