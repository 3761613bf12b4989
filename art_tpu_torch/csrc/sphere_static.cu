// K13 — closest sphere hit with every sphere baked into the kernel, one
// thread per ray.  Built once per scene and form by ops/_build.py
// static_libraries, never into the shared kernel library: the per-scene
// header sphere_static_cells.h defines the cells as exact float32 hex
// literals in three X-macro lists (ART_STATIC_MOVING, ART_STATIC_MAIN,
// ART_STATIC_TAIL) with ART_STATIC_TAIL_R and ART_STATIC_TAIL_MAT, and
// -DART_STATIC_EXPAND=0|1 picks the quadratic form.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_static_hit_attrs (:520,
// _sphere_static_kernel:384): K2's outputs (t, normal, material) over the
// cells of static_sphere_cells (:346, scene/builder.static_sphere_cells),
// in their order: the moving rows (cx0 cy0 cz0 vx vy vz r mat r2), a zero
// velocity component skipping its motion term; the static rows but the
// tail (cx cy cz r mat r2 K); each merged with a strict `<`, so the first
// row keeps an exact tie; then the tail (cx cy cz r2 K), the (radius,
// material)-uniform group, into a carry of its own that is merged once, a
// tail row winning only on a strictly smaller t.  Static rows take the
// direct quadratic, or with ART_STATIC_EXPAND the expanded one with the
// baked K = |c|^2 - r^2 (sphere.cuh sphere_test_expanded; moving rows stay
// direct, as in the TPU kernel).  t_min = 1e-3 is baked in.
// The candidate and the output follow the port's sphere rules (sphere.cuh):
// disc > 0 strict, the near root if > t_min else the far one, and the
// normal (p - c) / r with r carried from the cells (ART_STATIC_TAIL_R for
// the tail), so the TPU kernel's pos_r carry cut changes nothing here.  In
// the direct form the candidate is K2's own (sphere_test_at), so the
// kernel equals the full-table K2 in t on every lane; the winner differs
// only on exact ties, where the (moving, main, tail) order is not scene
// order.  Plain twin: ops/intersect_kernels.py sphere_static_hit_attrs_plain.
//
// Bound on the H100: FP32 throughput, 25 operations per (ray, moving row)
// and 19 per (ray, static row) (18 in the expanded form), and 7 planes in,
// 5 out per ray.  Design: the
// spheres are immediates in straight-line code, so no table is loaded and
// no loop counter or address is kept; the price is one nvcc build per scene
// and form, and an instruction stream of ~30 instructions a sphere that the
// instruction cache must hold.

#include "sphere.cuh"
#include "sphere_static_cells.h"

namespace {

constexpr float kTmin = 1e-3f;

__global__ void __launch_bounds__(art::kBlock)
sphere_static_kernel(int R, art::SpherePlanes p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const art::SphereRay q = art::load_ray(p, i, live);
#if ART_STATIC_EXPAND
  const art::ExpandedRay e = art::expanded_ray(q);
#endif
  art::SphereBest b = art::no_hit();
#define ART_MOVING_ROW(cx0, cy0, cz0, vx, vy, vz, r, mat, r2)                       \
  art::sphere_test_at((vx) == 0.0f ? (cx0) : (cx0) + q.tm * (vx),                    \
                      (vy) == 0.0f ? (cy0) : (cy0) + q.tm * (vy),                    \
                      (vz) == 0.0f ? (cz0) : (cz0) + q.tm * (vz), r, mat, r2, q, kTmin, b);
  ART_STATIC_MOVING(ART_MOVING_ROW)
#if ART_STATIC_EXPAND
#define ART_MAIN_ROW(cx, cy, cz, r, mat, r2, K) \
  art::sphere_test_expanded(cx, cy, cz, r, mat, K, q, e, kTmin, b);
#define ART_TAIL_ROW(cx, cy, cz, r2, K) \
  art::sphere_test_expanded(cx, cy, cz, ART_STATIC_TAIL_R, ART_STATIC_TAIL_MAT, K, q, e, kTmin, tb);
#else
#define ART_MAIN_ROW(cx, cy, cz, r, mat, r2, K) \
  art::sphere_test_at(cx, cy, cz, r, mat, r2, q, kTmin, b);
#define ART_TAIL_ROW(cx, cy, cz, r2, K) \
  art::sphere_test_at(cx, cy, cz, ART_STATIC_TAIL_R, ART_STATIC_TAIL_MAT, r2, q, kTmin, tb);
#endif
  ART_STATIC_MAIN(ART_MAIN_ROW)
  art::SphereBest tb = art::no_hit();
  ART_STATIC_TAIL(ART_TAIL_ROW)
  if (tb.t < b.t) b = tb;
  if (!live) return;
  art::write_hit(p, i, q, b);
}

}  // namespace

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out); all (R,)
extern "C" int art_sphere_static(int R, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_static_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(R, p);
  return (int)cudaGetLastError();
}
