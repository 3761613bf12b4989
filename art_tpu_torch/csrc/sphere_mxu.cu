// K14 — closest sphere hit through the bilinear sphere features, one thread
// per ray.
//
// Replaces art_tpu/ops/pallas_kernels.py:sphere_hit_attrs_mxu (:730,
// _sphere_mxu_kernel:618): for every sphere s of the feature table F
// (2 S_pad, 16) (scene/builder.sphere_mxu_features), the quadratic's
//   B = <F[s, 0:6], [d, tm d]>                      (= c(tm) . d)
//   C = <F[S_pad + s, 6:15], [o, tm o, 1, tm, tm^2]> (= |c|^2 - r^2 - 2 o.c)
// in FP32 on the CUDA cores, each sum in ascending column order; then, as
// the TPU kernel does, b = o.d - B and c = C + |o|^2, the root chosen
// against a 2 t_min margin (a candidate t carries the expanded form's
// rounding, so a false self-hit must stay below it) with disc > 0, the
// first sphere index among equal t, the winner's attribute column of attrT
// (8, S_pad) [c0; v; r; mat] read directly (the TPU's one-hot product
// selects it exactly), one Newton step on the direct quadratic, guarded at
// |f'| > 1e-12, and the normal (p - c) / r.  A miss writes t = BIG, normal
// (1, 0, 0), material 0.  Plain twin: ops/intersect_kernels.py
// sphere_mxu_hit_attrs_plain, the same terms in the same order.
//
// No tensor cores and no TF32: TF32 rounds each feature to ~2^-11, and the
// builder's scale gate (builder.py:776-811) assumes float32's 2^-23, so TF32
// would accept false self-hits.
// Bound on the H100: FP32 throughput.  The function's least work is K2's,
// 25 operations per (ray, sphere); this kernel does about 45 (the two
// feature sums 28, the root and its tests ~17), with 7 planes in and 5 out
// per ray.  Design: the 15 used features of a tile of kTile spheres
// are staged in shared memory, every thread of a warp reading the same
// sphere (a broadcast); the running best is (t, index), and the winner's
// attributes are one column read after the scan.

#include "sphere.cuh"

namespace {

constexpr int kTile = 128;  // S_pad is a multiple of 128
constexpr int kFeat = 16;   // floats a staged sphere: B's 6, C's 9, one spare
constexpr float kTsel = 0.002f;  // 2 t_min, t_min = 1e-3 baked in as in the TPU kernel

__global__ void __launch_bounds__(art::kBlock)
sphere_mxu_kernel(const float* __restrict__ F, const float* __restrict__ attr, int s_pad,
                  int R, art::SpherePlanes p) {
  __shared__ float sh[kTile * kFeat];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const float ox = live ? p.ox[i] : 0.f, oy = live ? p.oy[i] : 0.f;
  const float oz = live ? p.oz[i] : 0.f, dx = live ? p.dx[i] : 0.f;
  const float dy = live ? p.dy[i] : 0.f, dz = live ? p.dz[i] : 1.f;
  const float tm = live ? p.tm[i] : 0.f;
  const float tdx = tm * dx, tdy = tm * dy, tdz = tm * dz;
  const float tox = tm * ox, toy = tm * oy, toz = tm * oz, tm2 = tm * tm;
  const float a = dx * dx + dy * dy + dz * dz;
  const float neg_inv_a = -1.0f / a;
  const float od = ox * dx + oy * dy + oz * dz;
  const float o2 = ox * ox + oy * oy + oz * oz;
  const float ta2 = -kTsel * a;
  float best = art::kBig;
  int sid = 0;
  for (int base = 0; base < s_pad; base += kTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kTile * 15; k += blockDim.x) {
      const int s = k / 15, c = k % 15;
      sh[s * kFeat + c] = c < 6 ? F[(size_t)(base + s) * 16 + c]
                                : F[(size_t)(s_pad + base + s) * 16 + c];
    }
    __syncthreads();
    for (int s = 0; s < kTile; ++s) {
      const float* f = sh + s * kFeat;
      float B = f[0] * dx;
      B = B + f[1] * dy;
      B = B + f[2] * dz;
      B = B + f[3] * tdx;
      B = B + f[4] * tdy;
      B = B + f[5] * tdz;
      float C = f[6] * ox;
      C = C + f[7] * oy;
      C = C + f[8] * oz;
      C = C + f[9] * tox;
      C = C + f[10] * toy;
      C = C + f[11] * toz;
      C = C + f[12] * 1.0f;
      C = C + f[13] * tm;
      C = C + f[14] * tm2;
      const float b = od - B;
      const float c = C + o2;
      const float disc = b * b - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float s2 = b + sq < ta2 ? sq : -sq;
      const float cand = (b + s2) * neg_inv_a;
      if (disc > 0.0f && cand > kTsel && cand < best) {
        best = cand;
        sid = base + s;
      }
    }
  }
  if (!live) return;
  const bool hit = best < art::kBig * 0.5f;
  if (!hit) {
    p.t[i] = art::kBig; p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
    return;
  }
  const float cx = attr[sid] + tm * attr[3 * (size_t)s_pad + sid];
  const float cy = attr[(size_t)s_pad + sid] + tm * attr[4 * (size_t)s_pad + sid];
  const float cz = attr[2 * (size_t)s_pad + sid] + tm * attr[5 * (size_t)s_pad + sid];
  const float r = attr[6 * (size_t)s_pad + sid];
  const float mat = attr[7 * (size_t)s_pad + sid];
  // one Newton step on f(t) = |o + t d - c|^2 - r^2
  const float px = ox + best * dx - cx, py = oy + best * dy - cy, pz = oz + best * dz - cz;
  const float fv = px * px + py * py + pz * pz - r * r;
  const float fp = 2.0f * (dx * px + dy * py + dz * pz);
  const bool step = fabsf(fp) > 1e-12f;
  const float t = step ? best - fv / fp : best;
  const float inv_r = 1.0f / r;
  p.t[i] = t;
  p.nx[i] = (ox + t * dx - cx) * inv_r;
  p.ny[i] = (oy + t * dy - cy) * inv_r;
  p.nz[i] = (oz + t * dz - cz) * inv_r;
  p.mat[i] = (int)mat;
}

}  // namespace

// F (2 s_pad, 16) f32, attr (8, s_pad) f32; planes: ox oy oz dx dy dz tm
// (in), t nx ny nz mat (out); all (R,)
extern "C" int art_sphere_mxu(const float* F, const float* attr, int s_pad, int R,
                              void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    sphere_mxu_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(F, attr, s_pad, R, p);
  return (int)cudaGetLastError();
}
