// K13 — closest sphere hit with the scene's spheres compiled in, two rays a
// thread.  Built once per scene and form by ops/_build.py
// static_libraries, never into the shared kernel library: the per-scene
// header sphere_static_cells.h (ops/_build.py static_header) holds the
// rows as exact float32 hex literals in __device__ tables, (moving, main,
// tail) in that order: art_static_c (cx0, cy0, cz0, r2), art_static_k (K =
// |c|^2 - r^2, 0 on a moving row), art_static_v (vx, vy, vz, 0) of the
// moving rows and art_static_rm (r, mat; the tail's on a tail row), with
// the counts ART_STATIC_N_MOVING and ART_STATIC_N_ROWS and
// ART_STATIC_VEL_MASK (bit k: some moving row has a velocity component k);
// -DART_STATIC_EXPAND=0|1 picks the quadratic form.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_static_hit_attrs (:520,
// _sphere_static_kernel:384): K2's outputs (t, normal, material) over the
// cells of static_sphere_cells (:346, scene/builder.static_sphere_cells),
// in their order: the moving rows, a zero velocity component skipping its
// motion term; the static rows but the tail; each merged with a strict `<`,
// so the first row keeps an exact tie; then the tail, the (radius,
// material)-uniform group, whose carry is merged once, a tail row winning
// only on a strictly smaller t.  One (t, row) carry over the three in that
// order with a strict `<` is the same result: a tail row has a larger index
// than every main row.  Static rows take the direct quadratic, or with
// ART_STATIC_EXPAND the expanded one with the baked K (moving rows stay
// direct, as in the TPU kernel).  t_min = 1e-3 is baked in.  The candidate
// and the output follow the port's sphere rules (sphere.cuh): disc > 0
// strict, the near root if > t_min else the far one, and the normal
// (p - c) / r with the winner's centre at tm (the twin's where(v == 0, c0,
// c0 + tm v)), r and material read from its row after the scan.  In the
// direct form the candidate is K2's own, so the kernel equals the
// full-table K2 in t on every lane; the winner differs only on exact ties,
// where the (moving, main, tail) order is not scene order.  Plain twin:
// ops/intersect_kernels.py sphere_static_hit_attrs_plain.
//
// Bound on the H100: FP32 throughput, 25 operations per (ray, moving row)
// and 19 per (ray, static row) (18 in the expanded form), and 7 planes in,
// 5 out per ray.  Built with -fmad=false, so the kernel's own ceiling is
// half the FP32 rate, and the time goes to the instructions a pair.
// Design: the earlier form baked every sphere into straight-line code with
// the values as immediates: ~51 SASS instructions a sphere, 399 KB of code
// on bouncing_spheres and 792 KB on final_scene (scripts/sass_loops.py),
// far past an SM's instruction caches and streamed by every warp for 32
// rays, with a per-lane branch at every root and a six-value carry; it ran
// 1.3-1.9x the full-table K2.  Here the program is K2's loop
// (sphere_group.cuh) over the compiled-in tables, ~46 KB on
// bouncing_spheres and ~33 KB on final_scene:
//  * a block stages the rows into shared memory as float4s, a section at a
//    time (the moving rows with their velocities, then the static ones with
//    r2 or K), kTile rows a tile; every thread reads the same row, an
//    LDS.128 broadcast shared by its two rays;
//  * groups of kGroup rows, a warp vote on their discriminants before any
//    root, a (t, row) carry;
//  * what the scene fixes is compiled in: the section sizes, the form of
//    every row, and the velocity components that some moving row uses
//    (bouncing_spheres' move in y and z only, so a moving pair spends 23
//    operations, not 25);
//  * a block is kSplit parts over the same rays, each over a share of a
//    tile's groups, merged by (t, row) at the end (K2's split): a pool of
//    2^17 rays is 512 blocks of 256 threads, one wave where the direct form
//    fits 64 registers (ART_STATIC_BOUNDS); a scene of fewer than two
//    groups' rows takes one ray a thread in one part.
// nvcc builds a scene's tables in ~3 s a form, where the straight-line
// program took 3-20 s.

#include "sphere_group.cuh"
#include "sphere_static_cells.h"

namespace {

constexpr float kTmin = 1e-3f;
constexpr int kMoving = ART_STATIC_N_MOVING;
constexpr int kRowsAll = ART_STATIC_N_ROWS;
constexpr unsigned kVel = ART_STATIC_VEL_MASK;
constexpr int kThreads = 128;  // threads a part of a block (its rays)
constexpr bool kFew = kRowsAll < 2 * art::kGroup;
constexpr int kRays = kFew ? 1 : 2;   // rays a thread
constexpr int kSplit = kFew ? 1 : 2;  // parts a block
constexpr int kTile = kRowsAll < 1024 ? (kRowsAll > 0 ? kRowsAll : 1) : 1024;  // rows staged
constexpr int kTileV = kMoving < kTile ? (kMoving > 0 ? kMoving : 1) : kTile;  // velocities
#if ART_STATIC_EXPAND
constexpr int kStaticForm = art::kExpandedRow;
// the expanded form's ray terms need more registers than 64: in 96, two
// blocks an SM (512 blocks: two waves, the second nearly full)
#define ART_STATIC_BOUNDS __launch_bounds__(kThreads * kSplit)
#else
constexpr int kStaticForm = art::kDirectRow;
// the direct form fits 64 registers with no spill: four blocks an SM, the
// 512 blocks of a 2^17-ray pool in one wave
#define ART_STATIC_BOUNDS __launch_bounds__(kThreads * kSplit, 4)
#endif

// rows [r0, r1), all of the form kForm, a tile at a time: this thread's
// part takes its share of each tile's full groups, the last part the rows
// past them one at a time
template <int kForm>
__device__ __forceinline__ void scan_section(int r0, int r1, float4* sc, float4* sv, int part,
                                             const art::SphereRay (&q)[kRays],
                                             const art::ExpandedRay (&e)[kRays],
                                             const bool (&on)[kRays], float (&best)[kRays],
                                             int (&idx)[kRays]) {
  for (int base = r0; base < r1; base += kTile) {
    const int m = min(kTile, r1 - base);
    __syncthreads();  // the last tile read
    for (int k = threadIdx.x; k < m; k += kThreads * kSplit) {
      float4 c = __ldg(art_static_c + base + k);
      if (kForm == art::kExpandedRow) c.w = __ldg(art_static_k + base + k);
      sc[k] = c;
      if (kForm == art::kMovingRow) sv[k] = __ldg(art_static_v + base + k);
    }
    __syncthreads();
    const int groups = m / art::kGroup;
    for (int g = groups * part / kSplit; g < groups * (part + 1) / kSplit; ++g)
      art::scan_group<kForm, kVel, kRays>(sc + g * art::kGroup, sv + g * art::kGroup, q, e, on,
                                          kTmin, base + g * art::kGroup, best, idx);
    for (int r = groups * art::kGroup; part == kSplit - 1 && r < m; ++r)
      art::scan_one<kForm, kVel, kRays>(sc[r], sv[kForm == art::kMovingRow ? r : 0], q, e, on,
                                        kTmin, base + r, best, idx);
  }
}

__global__ void ART_STATIC_BOUNDS sphere_static_kernel(int R, art::SpherePlanes p) {
  __shared__ float4 sc[kTile];   // (cx, cy, cz, r2 or K)
  __shared__ float4 sv[kTileV];  // (vx, vy, vz, 0) of the moving rows
  constexpr int kParked = (kSplit > 1 ? kSplit - 1 : 1) * kRays * kThreads;
  __shared__ float part_best[kParked];  // the winners of parts 1.. at their end
  __shared__ int part_idx[kParked];
  const int first = blockIdx.x * (kThreads * kRays);
  const int lane = threadIdx.x % kThreads, part = threadIdx.x / kThreads;
  art::SphereRay q[kRays];
  art::ExpandedRay e[kRays];
  bool on[kRays];
  float best[kRays];
  int idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    q[k] = art::load_ray(p, i, i < R);
    e[k] = art::expanded_ray(q[k]);
    on[k] = true;  // a lane past R tests a dummy ray and writes nothing
    best[k] = art::kBig;
    idx[k] = -1;
  }
  if (kMoving > 0)
    scan_section<art::kMovingRow>(0, kMoving, sc, sv, part, q, e, on, best, idx);
  if (kRowsAll > kMoving)
    scan_section<kStaticForm>(kMoving, kRowsAll, sc, sv, part, q, e, on, best, idx);
  // part 0 takes a later part's winner where it is closer, or as close and
  // earlier
  if (part > 0)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      part_best[((part - 1) * kRays + k) * kThreads + lane] = best[k];
      part_idx[((part - 1) * kRays + k) * kThreads + lane] = idx[k];
    }
  __syncthreads();
  if (part > 0) return;
  for (int o = 0; o < kSplit - 1; ++o)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float b = part_best[(o * kRays + k) * kThreads + lane];
      const int j = part_idx[(o * kRays + k) * kThreads + lane];
      if (b < best[k] || (b == best[k] && b < art::kBig && j < idx[k])) {
        best[k] = b;
        idx[k] = j;
      }
    }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    if (i >= R) continue;
    art::SphereBest b = art::no_hit();
    if (best[k] < art::kBig) {  // the winner's row, with the twin's operations
      const int j = idx[k];
      const float4 c = __ldg(art_static_c + j);
      const float2 rm = __ldg(art_static_rm + j);
      b = art::SphereBest{best[k], c.x, c.y, c.z, rm.x, rm.y};
      if (j < kMoving) {
        const float4 v = __ldg(art_static_v + j);
        const float tm = q[k].tm;
        b.cx = v.x == 0.0f ? c.x : c.x + tm * v.x;
        b.cy = v.y == 0.0f ? c.y : c.y + tm * v.y;
        b.cz = v.z == 0.0f ? c.z : c.z + tm * v.z;
      }
    }
    art::write_hit(p, i, q[k], b);
  }
}

}  // namespace

// planes: ox oy oz dx dy dz tm (in), t nx ny nz mat (out); all (R,)
extern "C" int art_sphere_static(int R, void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + kThreads * kRays - 1) / (kThreads * kRays);
  if (grid > 0)
    sphere_static_kernel<<<grid, kThreads * kSplit, 0, (cudaStream_t)stream>>>(R, p);
  return (int)cudaGetLastError();
}
