// K3 — shade + integrate + framebuffer flush, one thread per pool slot.
//
// Replaces art_tpu/ops/shade_kernel.py:shade_flush (:331) in both its modes
// (_shade_math:132-293) and the flush math it runs (refill_kernel.py
// _flush_dead:415 -> flush_kernel.one_hot_accumulate:85).  Per live slot:
// background radiance on a miss, emission on a light, the lambertian /
// metal / dielectric / diffuse_light / isotropic scatter from the material
// parameters, the throughput/origin/direction update, bounce += 1,
// death by absorption or at max_depth, and fb[pix] += radiance for a slot
// that died.  The operation order is that of the plain twins
// (ops/shade_kernel.py:shade_flush_plain, whose bounce is ops/shade.py
// bounce_p -> shade_p, art_tpu's _bounce_step less its intersection).  The
// in-ball radius is a true cube root, as
// shade.py:47 uses jnp.cbrt where the TPU kernel used exp(log(u)/3): CUDA's
// float64 cbrt rounded once to float32, i.e. the correctly rounded float32
// root but for ~1 input in 10^8, which the plain twin's float64 pow gives
// too (cbrtf is up to 1 ulp off, and an ulp here would let a chaotic path
// leave its twin's).
//
// The flush replaces the TPU's bf16 one-hot MXU window accumulate and its
// window / lax.cond logic (integrator.py:687-734): float32 atomicAdds into
// the tile's (P, 3) framebuffer through flush_warp (flush_warp.cuh, shared
// with K11): a warp's deaths of one pixel are summed by shuffles first and
// added once a channel, since the samples of a pixel sit side by side in
// the pool (ops/sp_kernel.py flush_warp_p models the order).  Sums are
// exact float32 adds, but atomics add in a run-dependent order, so results
// are compared with a tolerance.  A dying slot whose pix lies outside
// [0, P) (refill never makes one) adds nothing and counts into *lost, as
// the twin does; render_wavefront raises if the count is not 0.
//
// Two modes, one template (kBaked):
//  * plane-fed: the material type, fuzz, refraction index, metal albedo and
//    texture value of every ray arrive as per-ray planes (ops/shade.py
//    shade_params_p fetches them);
//  * baked, replacing shade_flush's consts form (_baked_params:70-129,
//    rec_names:63): the hit record shrinks to p(3) n(3) mat u_ball(3)
//    u_choice, and the parameters come from the material id.  The TPU bakes
//    them into the compiled kernel; here they arrive as a (M <= 24, 16)
//    float32 table (scene/tables.py shade_rows, built once per scene from
//    shade_consts), staged in shared memory and indexed by the mat plane —
//    the same float32 values, so the same results.  A checker of solids
//    picks its even/odd color by the parity of floor(inv_scale * p), as
//    _baked_params:113-125; a special leaf (tex_kind 2: noise, evaluated
//    outside by ops/texture_eval.py eval_special_p) takes its value from
//    the sp0..sp2 planes when the scene has them (_baked_params:126-128).
//
// Bound on the H100: memory — plane-fed ~35 planes in (15 state, hit, 19
// hit-record and material planes, ~136 B/slot), baked ~27 (11 hit-record
// planes, 14 with special leaves), and up to 15 out; the scatter math is a
// few dozen flops.
// Design: one wave of one thread per slot, coalesced one-plane-per-field
// loads and stores; its time is a chain of memory latencies.  The baked
// mode reads a live slot's state and whole hit record up front, right
// after the constants' barrier, so they arrive in one round trip
// (load_slot; issued ahead of the barrier they measured slower).
// The plane-fed mode reads each plane where it is used (so up front it
// measured slower), and a per-ray parameter plane only in the material
// family that uses it.  A dead slot (act == 0) reads one byte; a slot that
// does not survive skips the o/d/throughput stores; every lane of a warp
// reaches the flush, dead slots and lanes past R as workers that add
// nothing.  The pool is updated in place.

#include "common.cuh"
#include "flush_warp.cuh"

namespace {

constexpr int kMaxMats = 24;   // scene/builder.py _shade_consts gate
constexpr int kConstCols = 16;  // shade_rows columns

struct ShadePlanes {
  float *ox, *oy, *oz, *dx, *dy, *dz, *t0, *t1, *t2, *r0, *r1, *r2;
  int *bounce;
  const int* pix;
  uint8_t* act;
  const uint8_t* hit;
  const float *px, *py, *pz, *nx, *ny, *nz, *mtype, *fuzz, *refidx;
  const float *ma0, *ma1, *ma2, *tx0, *tx1, *tx2, *ub0, *ub1, *ub2, *uch;
  const int* mat;  // baked mode: material id
  const float *sp0, *sp1, *sp2;  // baked mode: special leaf values, or null
  float* fb;
  int* lost;
};

// a live slot's state and, in the baked mode, its bounce, pixel and (on a
// hit) its hit record: the planes the plane-fed mode reads where they are
// used (zeros elsewhere)
struct Slot {
  bool hit;
  float dx, dy, dz, th0, th1, th2, ra0, ra1, ra2;
  int bounce, pix, mat;
  float n0, n1, n2, px, py, pz, ub0, ub1, ub2, uch;
};

template <bool kBaked>
__device__ __forceinline__ Slot load_slot(const ShadePlanes& p, int i) {
  Slot s{};
  s.hit = p.hit[i] != 0;
  s.dx = p.dx[i]; s.dy = p.dy[i]; s.dz = p.dz[i];
  s.th0 = p.t0[i]; s.th1 = p.t1[i]; s.th2 = p.t2[i];
  s.ra0 = p.r0[i]; s.ra1 = p.r1[i]; s.ra2 = p.r2[i];
  if (kBaked) {
    s.bounce = p.bounce[i];
    s.pix = p.pix[i];
    if (s.hit) {
      s.mat = p.mat[i];
      s.n0 = p.nx[i]; s.n1 = p.ny[i]; s.n2 = p.nz[i];
      s.px = p.px[i]; s.py = p.py[i]; s.pz = p.pz[i];
      s.ub0 = p.ub0[i]; s.ub1 = p.ub1[i]; s.ub2 = p.ub2[i]; s.uch = p.uch[i];
    }
  }
  return s;
}

template <bool kBaked>
__global__ void __launch_bounds__(art::kBlock)
shade_flush_kernel(ShadePlanes p, const float* __restrict__ consts, int M, int R,
                   float bg0, float bg1, float bg2, int gradient, int max_depth,
                   int P) {
  __shared__ float sh[kBaked ? kMaxMats * kConstCols : 1];
  if (kBaked) {
    for (int k = threadIdx.x; k < M * kConstCols; k += blockDim.x) sh[k] = consts[k];
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R && p.act[i];
  Slot s{};
  if (live) s = load_slot<kBaked>(p, i);
  // a plane of the slot's record: read by load_slot in the baked mode, here
  // in the plane-fed one
  const auto rd = [&](float loaded, const float* plane) { return kBaked ? loaded : plane[i]; };
  const auto rd_int = [&](int loaded, const int* plane) { return kBaked ? loaded : plane[i]; };
  bool died = false;
  int pix = 0;  // a dying slot's pixel
  float ra0 = s.ra0, ra1 = s.ra1, ra2 = s.ra2;
  if (live) {
    const float dx = s.dx, dy = s.dy, dz = s.dz;
    const float th0 = s.th0, th1 = s.th1, th2 = s.th2;
    const float a = dx * dx + dy * dy + dz * dz;
    const float dlen = sqrtf(a);
    const float inv_dlen = 1.0f / dlen;

    bool survived = false;
    float dir0 = 0.f, dir1 = 0.f, dir2 = 0.f, at0 = 1.f, at1 = 1.f, at2 = 1.f;
    if (!s.hit) {  // ---- background (src/main.cu:58-67) ----
      if (gradient) {
        const float tbg = 0.5f * (dy * inv_dlen + 1.0f);
        bg0 = 1.0f - 0.5f * tbg;
        bg1 = 1.0f - 0.3f * tbg;
        bg2 = 1.0f;
      }
      ra0 = ra0 + th0 * bg0; ra1 = ra1 + th1 * bg1; ra2 = ra2 + th2 * bg2;
    } else {
      // baked: the material's constants row [mtype fuzz ref_idx malb(3) kind
      // isc rgb_or_even(3) odd(3) 0 0]
      const float* c = kBaked ? sh + min(max(s.mat, 0), M - 1) * kConstCols : nullptr;
      const float mtype = kBaked ? c[0] : p.mtype[i];
      const float n0 = rd(s.n0, p.nx), n1 = rd(s.n1, p.ny), n2 = rd(s.n2, p.nz);
      float tx0, tx1, tx2;
      if (!kBaked) {
        tx0 = p.tx0[i]; tx1 = p.tx1[i]; tx2 = p.tx2[i];
      } else if (c[6] == 1.0f) {  // checker of solids (_baked_params:113-125)
        const int xi = (int)floorf(c[7] * s.px);
        const int yi = (int)floorf(c[7] * s.py);
        const int zi = (int)floorf(c[7] * s.pz);
        const int off = ((xi + yi + zi) & 1) == 0 ? 8 : 11;
        tx0 = c[off]; tx1 = c[off + 1]; tx2 = c[off + 2];
      } else if (c[6] == 2.0f && p.sp0) {  // special leaf (_baked_params:126-128)
        tx0 = p.sp0[i]; tx1 = p.sp1[i]; tx2 = p.sp2[i];
      } else {
        tx0 = c[8]; tx1 = c[9]; tx2 = c[10];
      }
      if (mtype == 3.0f) {  // ---- diffuse_light: emit, absorb ----
        ra0 = ra0 + th0 * tx0; ra1 = ra1 + th1 * tx1; ra2 = ra2 + th2 * tx2;
      } else {
        // shared in-ball sample (ops/shade.py:_ball_from_uniforms_p)
        const float z = 2.0f * rd(s.ub0, p.ub0) - 1.0f;
        const float phi = art::kTwoPi * rd(s.ub1, p.ub1);
        const float sball = sqrtf(fmaxf(1.0f - z * z, 0.0f));
        const float rball = (float)cbrt((double)rd(s.ub2, p.ub2));
        const float b0 = rball * sball * cosf(phi), b1 = rball * sball * sinf(phi),
                    b2 = rball * z;
        survived = true;
        if (mtype == 1.0f) {  // ---- metal (src/material.cuh:90-110) ----
          const float ud0 = dx * inv_dlen, ud1 = dy * inv_dlen, ud2 = dz * inv_dlen;
          const float udn2 = 2.0f * (ud0 * n0 + ud1 * n1 + ud2 * n2);
          const float fuzz = kBaked ? c[1] : p.fuzz[i];
          dir0 = ud0 - n0 * udn2 + fuzz * b0;
          dir1 = ud1 - n1 * udn2 + fuzz * b1;
          dir2 = ud2 - n2 * udn2 + fuzz * b2;
          survived = (dir0 * n0 + dir1 * n1 + dir2 * n2) > 0.0f;
          if (kBaked) {
            at0 = c[3]; at1 = c[4]; at2 = c[5];
          } else {
            at0 = p.ma0[i]; at1 = p.ma1[i]; at2 = p.ma2[i];
          }
        } else if (mtype == 2.0f) {  // ---- dielectric (material.cuh:113-159) ----
          const float ri = kBaked ? c[2] : p.refidx[i];
          const float ud0 = dx * inv_dlen, ud1 = dy * inv_dlen, ud2 = dz * inv_dlen;
          const float d_dot_n = dx * n0 + dy * n1 + dz * n2;
          const bool inside = d_dot_n > 0.0f;
          const float o0 = inside ? -n0 : n0, o1 = inside ? -n1 : n1,
                      o2 = inside ? -n2 : n2;
          const float nio = inside ? ri : 1.0f / ri;
          const float cos_raw = d_dot_n / dlen;
          const float cos_inside =
              sqrtf(fmaxf(1.0f - ri * ri * (1.0f - cos_raw * cos_raw), 0.0f));
          const float cosine = inside ? cos_inside : -cos_raw;
          const float dt = ud0 * o0 + ud1 * o1 + ud2 * o2;
          const float disc = 1.0f - nio * nio * (1.0f - dt * dt);
          float r0 = (1.0f - ri) / (1.0f + ri);
          r0 = r0 * r0;
          const float x = 1.0f - cosine;
          const float x2 = x * x;
          const float schl = r0 + (1.0f - r0) * (x2 * x2 * x);
          if (rd(s.uch, p.uch) < (disc > 0.0f ? schl : 1.0f)) {
            const float dn2 = 2.0f * d_dot_n;
            dir0 = dx - n0 * dn2; dir1 = dy - n1 * dn2; dir2 = dz - n2 * dn2;
          } else {
            const float root = sqrtf(fmaxf(disc, 0.0f));
            dir0 = (ud0 - o0 * dt) * nio - o0 * root;
            dir1 = (ud1 - o1 * dt) * nio - o1 * root;
            dir2 = (ud2 - o2 * dt) * nio - o2 * root;
          }
        } else if (mtype == 4.0f) {  // ---- isotropic: uniform in the ball ----
          dir0 = b0; dir1 = b1; dir2 = b2;
          at0 = tx0; at1 = tx1; at2 = tx2;
        } else {  // ---- lambertian (src/material.cuh:75-87) ----
          dir0 = n0 + b0; dir1 = n1 + b1; dir2 = n2 + b2;
          at0 = tx0; at1 = tx1; at2 = tx2;
        }
      }
    }
    p.r0[i] = ra0; p.r1[i] = ra1; p.r2[i] = ra2;
    if (survived) {
      p.t0[i] = th0 * at0; p.t1[i] = th1 * at1; p.t2[i] = th2 * at2;
      p.ox[i] = rd(s.px, p.px); p.oy[i] = rd(s.py, p.py); p.oz[i] = rd(s.pz, p.pz);
      p.dx[i] = dir0; p.dy[i] = dir1; p.dz[i] = dir2;
    }
    const int bounce = rd_int(s.bounce, p.bounce) + 1;
    p.bounce[i] = bounce;
    died = !(survived && bounce < max_depth);
    if (died) {  // flush its radiance
      p.act[i] = 0;
      pix = rd_int(s.pix, p.pix);
    }
  }
  // every lane of the warp, converged
  const bool inside = pix >= 0 && pix < P;
  if (died && !inside) atomicAdd(p.lost, 1);
  art::flush_warp(died && inside, pix, ra0, ra1, ra2, p.fb);
}

// The state block shared by both modes: ox oy oz dx dy dz t0 t1 t2 r0 r1 r2
// (f32), bounce pix (i32), act hit (u8).
ShadePlanes state_planes(void* const* ptrs) {
  ShadePlanes p = {};
  float** f = (float**)ptrs;
  p.ox = f[0]; p.oy = f[1]; p.oz = f[2]; p.dx = f[3]; p.dy = f[4]; p.dz = f[5];
  p.t0 = f[6]; p.t1 = f[7]; p.t2 = f[8]; p.r0 = f[9]; p.r1 = f[10]; p.r2 = f[11];
  p.bounce = (int*)ptrs[12];
  p.pix = (const int*)ptrs[13];
  p.act = (uint8_t*)ptrs[14];
  p.hit = (const uint8_t*)ptrs[15];
  return p;
}

template <bool kBaked>
int launch(const ShadePlanes& p, const float* consts, int M, int R, const float* bg,
           int gradient, int max_depth, int P, void* stream) {
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    shade_flush_kernel<kBaked><<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(
        p, consts, M, R, bg[0], bg[1], bg[2], gradient, max_depth, P);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the state block (state_planes), then px py pz nx ny nz mtype fuzz
//       refidx ma0 ma1 ma2 tx0 tx1 tx2 ub0 ub1 ub2 uch (f32), fb (f32 (P, 3)),
//       lost (i32 (1,)); planes (R,).
extern "C" int art_shade_flush(void* const* ptrs, int R, const float* bg,
                               int gradient, int max_depth, int P, void* stream) {
  ShadePlanes p = state_planes(ptrs);
  const float** r = (const float**)(ptrs + 16);
  p.px = r[0]; p.py = r[1]; p.pz = r[2]; p.nx = r[3]; p.ny = r[4]; p.nz = r[5];
  p.mtype = r[6]; p.fuzz = r[7]; p.refidx = r[8];
  p.ma0 = r[9]; p.ma1 = r[10]; p.ma2 = r[11];
  p.tx0 = r[12]; p.tx1 = r[13]; p.tx2 = r[14];
  p.ub0 = r[15]; p.ub1 = r[16]; p.ub2 = r[17]; p.uch = r[18];
  p.fb = (float*)ptrs[35];
  p.lost = (int*)ptrs[36];
  return launch<false>(p, nullptr, 0, R, bg, gradient, max_depth, P, stream);
}

// ptrs: the state block (state_planes), then px py pz nx ny nz (f32) mat (i32)
//       ub0 ub1 ub2 uch (f32), sp0 sp1 sp2 (f32, or null when the scene has
//       no special leaf), fb (f32 (P, 3)), lost (i32 (1,)); planes (R,).
// consts: (M, 16) f32 shade_rows, 1 <= M <= 24.
extern "C" int art_shade_flush_baked(void* const* ptrs, int R, const float* consts,
                                     int M, const float* bg, int gradient,
                                     int max_depth, int P, void* stream) {
  if (M < 1 || M > kMaxMats) return (int)cudaErrorInvalidValue;
  ShadePlanes p = state_planes(ptrs);
  const float** r = (const float**)(ptrs + 16);
  p.px = r[0]; p.py = r[1]; p.pz = r[2]; p.nx = r[3]; p.ny = r[4]; p.nz = r[5];
  p.mat = (const int*)r[6];
  p.ub0 = r[7]; p.ub1 = r[8]; p.ub2 = r[9]; p.uch = r[10];
  p.sp0 = r[11]; p.sp1 = r[12]; p.sp2 = r[13];
  p.fb = (float*)ptrs[30];
  p.lost = (int*)ptrs[31];
  return launch<true>(p, consts, M, R, bg, gradient, max_depth, P, stream);
}
