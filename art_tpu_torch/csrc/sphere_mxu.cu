// K14 — closest sphere hit through the bilinear sphere features, two rays a
// thread.
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
// sphere_mxu_hit_attrs_plain, the same terms in the same order.  The pad
// rows (all-zero features, radius 1) are scanned as the twin scans them: a
// ray through the origin can round their disc above 0.
//
// No tensor cores and no TF32: TF32 rounds each feature to ~2^-11, and the
// builder's scale gate (builder.py:776-811) assumes float32's 2^-23, so TF32
// would accept false self-hits.
//
// Bound on the H100: FP32 issue.  The function's least work is K2's, 25
// operations a (ray, moving sphere), 19 a static one; this kernel's terms
// are 32 a pair whatever the sphere (B 11, C 16, b and c 2, disc 3), with
// 7 planes in and 5 out a ray.  Built with -fmad=false for bit equality, so
// the time goes to the instructions issued a pair.  The design, K2's
// (sphere_hit.cu) on the features:
//  * the block stages a tile of kTile spheres' 15 used features into shared
//    memory as four float4s a sphere (the 16th float 0), each thread
//    copying one float4 (no k / 15 or k % 15); every thread reads the same
//    sphere, so a sphere is four LDS.128 broadcasts;
//  * each thread takes kRays rays (lanes i, i + kThreads), so a staged load
//    serves kRays pairs;
//  * the spheres go in groups of kGroup, unrolled, so the group's sums are
//    independent chains; the roots are computed only where a lane of the
//    warp may have disc > 0 (a vote a group on the AND of its
//    discriminants' bits, then a vote a sphere), as the twin's `where`
//    leaves the other lanes' roots unread: a lane with disc <= 0 keeps
//    "no candidate" exactly;
//  * a block is kSplit parts of kThreads threads over the same rays, each
//    over a part of every tile's groups; part 0 then takes another part's
//    winner where it is closer, or as close and earlier (the twin's first
//    index among equal t).  R = 2^17: 512 blocks of 256 threads, one wave.

#include "sphere.cuh"

namespace {

constexpr int kThreads = 128;  // threads a part of a block (its rays)
constexpr int kRays = 2;       // rays a thread
constexpr int kSplit = 2;      // parts a block
constexpr int kGroup = 8;      // spheres a group: one vote
constexpr int kTile = 512;     // spheres a shared-memory tile (S_pad is a multiple of 128)
constexpr float kTsel = 0.002f;  // 2 t_min, t_min = 1e-3 baked in as in the TPU kernel
constexpr unsigned kAll = 0xffffffffu;

// a ray's terms: the feature inputs, and the per-ray parts of b, c and the
// root (sphere_mxu_hit_attrs_plain's rf, od, o2, a, neg_inv_a, ta2)
struct MxuRay {
  float dx, dy, dz, tdx, tdy, tdz, ox, oy, oz, tox, toy, toz, tm, tm2;
  float od, o2, a, neg_inv_a, ta2;
};

__device__ __forceinline__ MxuRay mxu_ray(const art::SpherePlanes& p, int i, bool live) {
  MxuRay q;
  q.ox = live ? p.ox[i] : 0.f; q.oy = live ? p.oy[i] : 0.f; q.oz = live ? p.oz[i] : 0.f;
  q.dx = live ? p.dx[i] : 0.f; q.dy = live ? p.dy[i] : 0.f; q.dz = live ? p.dz[i] : 1.f;
  q.tm = live ? p.tm[i] : 0.f;
  q.tdx = q.tm * q.dx; q.tdy = q.tm * q.dy; q.tdz = q.tm * q.dz;
  q.tox = q.tm * q.ox; q.toy = q.tm * q.oy; q.toz = q.tm * q.oz; q.tm2 = q.tm * q.tm;
  q.a = q.dx * q.dx + q.dy * q.dy + q.dz * q.dz;
  q.neg_inv_a = -1.0f / q.a;
  q.od = q.ox * q.dx + q.oy * q.dy + q.oz * q.dz;
  q.o2 = q.ox * q.ox + q.oy * q.oy + q.oz * q.oz;
  q.ta2 = -kTsel * q.a;
  return q;
}

// b = o.d - B and the discriminant b^2 - a c, c = C + |o|^2, of one staged
// sphere (f: its four float4s), each feature sum in ascending column order
__device__ __forceinline__ float feature_disc(const float4* f, const MxuRay& q, float& b) {
  const float4 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3];
  float B = f0.x * q.dx;
  B = B + f0.y * q.dy;
  B = B + f0.z * q.dz;
  B = B + f0.w * q.tdx;
  B = B + f1.x * q.tdy;
  B = B + f1.y * q.tdz;
  float C = f1.z * q.ox;
  C = C + f1.w * q.oy;
  C = C + f2.x * q.oz;
  C = C + f2.y * q.tox;
  C = C + f2.z * q.toy;
  C = C + f2.w * q.toz;
  C = C + f3.x;  // the constant feature (times 1)
  C = C + f3.y * q.tm;
  C = C + f3.z * q.tm2;
  b = q.od - B;
  const float c = C + q.o2;
  return b * b - q.a * c;
}

// sphere s's root replaces (best, sid) where disc > 0, it clears the 2 t_min
// margin and it is strictly closer
__device__ __forceinline__ void take_root(const MxuRay& q, float b, float disc, int s,
                                          float& best, int& sid) {
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float s2 = b + sq < q.ta2 ? sq : -sq;
    const float cand = (b + s2) * q.neg_inv_a;
    if (cand > kTsel && cand < best) {
      best = cand;
      sid = s;
    }
  }
}

// lane i's output from the winner's attribute column: one Newton step on
// f(t) = |o + t d - c|^2 - r^2 and the normal, or a miss
__device__ __forceinline__ void write_winner(const art::SpherePlanes& p, int i,
                                             const float* __restrict__ attr, int s_pad,
                                             float best, int sid) {
  if (!(best < art::kBig * 0.5f)) {
    p.t[i] = art::kBig; p.nx[i] = 1.f; p.ny[i] = 0.f; p.nz[i] = 0.f; p.mat[i] = 0;
    return;
  }
  const float ox = p.ox[i], oy = p.oy[i], oz = p.oz[i];
  const float dx = p.dx[i], dy = p.dy[i], dz = p.dz[i], tm = p.tm[i];
  const float cx = attr[sid] + tm * attr[3 * (size_t)s_pad + sid];
  const float cy = attr[(size_t)s_pad + sid] + tm * attr[4 * (size_t)s_pad + sid];
  const float cz = attr[2 * (size_t)s_pad + sid] + tm * attr[5 * (size_t)s_pad + sid];
  const float r = attr[6 * (size_t)s_pad + sid];
  const float mat = attr[7 * (size_t)s_pad + sid];
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

__global__ void __launch_bounds__(kThreads * kSplit)
sphere_mxu_kernel(const float4* __restrict__ F, const float* __restrict__ attr, int s_pad,
                  int R, art::SpherePlanes p) {
  __shared__ float4 sh[kTile * 4];  // sphere s: sh[4 s .. 4 s + 3]
  __shared__ float part_best[(kSplit - 1) * kRays * kThreads];
  __shared__ int part_sid[(kSplit - 1) * kRays * kThreads];
  const int first = blockIdx.x * (kThreads * kRays);
  const int lane = threadIdx.x % kThreads, part = threadIdx.x / kThreads;
  MxuRay q[kRays];
  float best[kRays];
  int sid[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    q[k] = mxu_ray(p, i, i < R);
    best[k] = art::kBig;
    sid[k] = 0;
  }
  // F as float4s: row s is F[4 s .. 4 s + 3]; B's features in rows
  // [0, s_pad), C's in [s_pad, 2 s_pad)
  const float4* Fc = F + 4 * (size_t)s_pad;
  for (int base = 0; base < s_pad; base += kTile) {
    const int m = min(kTile, s_pad - base);  // a multiple of 128, so of kGroup
    const int groups = m / kGroup;
    __syncthreads();
    for (int k = threadIdx.x; k < 4 * m; k += kThreads * kSplit) {
      const size_t s = base + (k >> 2);
      float4 v;
      switch (k & 3) {
        case 0: v = F[4 * s]; break;  // B: columns 0..3
        case 1: {                     // B: 4, 5; C: 6, 7
          const float4 lo = F[4 * s + 1], hi = Fc[4 * s + 1];
          v = make_float4(lo.x, lo.y, hi.z, hi.w);
          break;
        }
        case 2: v = Fc[4 * s + 2]; break;  // C: 8..11
        default: {                          // C: 12..14, then 0
          const float4 c = Fc[4 * s + 3];
          v = make_float4(c.x, c.y, c.z, 0.0f);
        }
      }
      sh[k] = v;
    }
    __syncthreads();
    for (int g = groups * part / kSplit; g < groups * (part + 1) / kSplit; ++g) {
      const int s0 = g * kGroup;
      float d[kGroup][kRays], b[kGroup][kRays];
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
#pragma unroll
        for (int k = 0; k < kRays; ++k) d[r][k] = feature_disc(sh + 4 * (s0 + r), q[k], b[r][k]);
      // a disc > 0 has a clear sign bit: the AND of the group's discs has a
      // clear sign bit if one may be > 0 (a +0 or a NaN only costs a vote)
      unsigned all = ~0u;
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
#pragma unroll
        for (int k = 0; k < kRays; ++k) all &= __float_as_uint(d[r][k]);
      if (__any_sync(kAll, (int)all >= 0)) {  // spheres in table order, each voted again
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          bool any = false;
#pragma unroll
          for (int k = 0; k < kRays; ++k) any = any || d[r][k] > 0.0f;
          if (__any_sync(kAll, any)) {
#pragma unroll
            for (int k = 0; k < kRays; ++k)
              take_root(q[k], b[r][k], d[r][k], base + s0 + r, best[k], sid[k]);
          }
        }
      }
    }
  }
  // part 0 takes a later part's winner where it is closer, or as close and
  // earlier
  if (part > 0)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      part_best[((part - 1) * kRays + k) * kThreads + lane] = best[k];
      part_sid[((part - 1) * kRays + k) * kThreads + lane] = sid[k];
    }
  __syncthreads();
  if (part > 0) return;
  for (int o = 0; o < kSplit - 1; ++o)
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float bt = part_best[(o * kRays + k) * kThreads + lane];
      const int j = part_sid[(o * kRays + k) * kThreads + lane];
      if (bt < best[k] || (bt == best[k] && bt < art::kBig && j < sid[k])) {
        best[k] = bt;
        sid[k] = j;
      }
    }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kThreads + lane;
    if (i < R) write_winner(p, i, attr, s_pad, best[k], sid[k]);
  }
}

}  // namespace

// F (2 s_pad, 16) f32, 16-byte aligned; attr (8, s_pad) f32; planes: ox oy
// oz dx dy dz tm (in), t nx ny nz mat (out); all (R,)
extern "C" int art_sphere_mxu(const float* F, const float* attr, int s_pad, int R,
                              void* const* planes, void* stream) {
  const art::SpherePlanes p = art::sphere_planes(planes);
  const int grid = (R + kThreads * kRays - 1) / (kThreads * kRays);
  if (grid > 0)
    sphere_mxu_kernel<<<grid, kThreads * kSplit, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(F), attr, s_pad, R, p);
  return (int)cudaGetLastError();
}
