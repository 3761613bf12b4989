// K11 — the short path: a whole pool iteration (refill, closest hit, shading,
// integration and the framebuffer flush) in one kernel, for the small static
// scenes that pass scene/builder.py _sp_consts (at most 16 spheres and
// quads, no boxes, media or moving spheres; lambertian, metal, dielectric
// and diffuse_light materials; solid, checker-of-solids and marble
// textures).
//
// Replaces art_tpu/ops/sp_kernel.py:sp_step_flush_rng (:571), sp_step_rng
// (:661) and sp_step (:701): for every slot,
//  (a) the refill of K1 — refill.cuh, the same device functions refill.cu
//      runs: the global dead rank by the one-pass look-back scan, the queue
//      element, the camera ray, next_q on the device and the live count
//      into hist[it]; uniforms from Philox as K1 draws them (use_philox) or
//      from an injected (ncols, R) block, each column read where it is
//      used: the camera's (4..8, Philox calls 1 and 2) by a taken slot, the
//      ball's and the choice (0..3, call 0) by a slot that scatters;
//  (b) the bounce of _sp_bounce (:85-402), operation for operation: the
//      closest hit over the spheres with that kernel's root form
//      (s2 = b + sq < -T_MIN a ? sq : -sq; t = (b + s2) (-1/a)) and over
//      the quads (|n.d| >= 1e-8), spheres first then quads, each with a
//      strict <; the normal S (p - A) + Tn A; the gradient or solid
//      background; one turbulence for a marble winner, on p (a miss never
//      gets there, so p needs no clamp); the material by the winner's id (the
//      dense mtype blend of :225-261 selects exactly that row); emission,
//      lambertian, metal and dielectric scatter; the death rule;
//  (c) fb[pix] += radiance for a slot that died, float32 atomicAdd, a pixel
//      outside [0, P) counted into *lost, as K3 does; the deaths of one
//      pixel in a warp are summed first and added once (flush_warp).
// It writes died (u8) for every slot.  One deliberate difference from the
// TPU kernel: the in-ball radius is a true cube root (float64 cbrt rounded
// once), as in K3, not exp(log(u)/3).  The constants the TPU compiles in
// arrive as three small tables (scene/tables.py sp_rows), staged in shared
// memory.  The plain twin is ops/sp_kernel.py sp_step_plain; every float
// operation here rounds as the twin's (-fmad=false, no fast-math).
//
// Bound on the H100: operations for a marble scene (one 7-octave turbulence
// per hit on a marble surface: ~174 operations of blend a lane and octave,
// ~59 per distinct lattice gradient), memory for the others (~62 B of pool
// state in and out per live slot against ~30 operations per primitive and
// ~100 for the shading).  Design: one thread per slot and one launch, the
// refill's rank by K1's look-back scan (the slots of a block follow its
// scan ticket); the slot's
// state stays in registers from the refill to the flush, and a dead slot
// that takes no queue element reads its act byte and writes its died byte.
// The slots of one pixel's samples sit side by side, so two pieces run with
// every lane of the warp converged, dead and missing slots as workers: the
// marble turbulence between the hit and the shading (perlin.cuh
// turbulence_warp: a warp whose marble lanes lie in one cell makes 8
// gradients an octave, however few those lanes), and the flush
// (flush_warp: one atomicAdd a channel per pixel of the warp, though up to
// 64 slots of a pixel die together).

#include "common.cuh"
#include "flush_warp.cuh"
#include "perlin.cuh"
#include "refill.cuh"

namespace {

constexpr int kMaxPrims = 16;  // scene/tables.py MAX_SP_PRIMS; so <= 16 materials
constexpr int kSphCols = 6;    // cx cy cz r inv_r mat
constexpr int kQuadCols = 13;  // n(3) D avec(3) ca bvec(3) cb mat
constexpr int kMatCols = 14;   // type fuzz ref_idx malb(3) kind even(3) isc odd(3)
constexpr float kTMin = 1e-3f;  // core/vecmath.py T_MIN

struct SpArgs {
  art::RefillPlanes p;
  int R;
  art::Scan scan;
  long long* q;
  int parity;
  unsigned long long* hist;
  art::Scal sc;
  art::Cam cam;
  const float* ublk;  // injected (ncols, R) block, or null with use_philox
  int ncols, use_philox;
  uint32_t seed, tile, chunk, it;
  float bg0, bg1, bg2;
  int gradient, max_depth, P;
  float* fb;
  int* lost;
  uint8_t* died;
  const float *sph, *quads, *mats;
  int S, Q, M;
};

struct Slot {
  float ox, oy, oz, dx, dy, dz, t0, t1, t2, r0, r1, r2;
  int bounce;
};

// The first half of a live slot's bounce (_sp_bounce), in place: the
// closest hit, the background of a miss and the bounce count.
struct Hit {
  float t, A0, A1, A2, Sc, Tn, mat;
};

__device__ Hit closest_hit(Slot& s, float aa, float inv_dlen, const SpArgs& a,
                           const float* sph, const float* quads) {
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy, dz = s.dz;
  Hit h{art::kBig, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (a.S) {
    const float neg_inv_a = -1.0f / aa;
    const float ta2 = -kTMin * aa;
    for (int k = 0; k < a.S; ++k) {
      const float* r = sph + k * kSphCols;
      const float ocx = ox - r[0], ocy = oy - r[1], ocz = oz - r[2];
      const float b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - r[3] * r[3];
      const float sq = sqrtf(b * b - aa * c);  // NaN on a miss: fails every test
      const float s2 = b + sq < ta2 ? sq : -sq;
      const float t = (b + s2) * neg_inv_a;
      if (t > kTMin && t < h.t) h = Hit{t, r[0], r[1], r[2], r[4], 0.f, r[5]};
    }
  }
  for (int k = 0; k < a.Q; ++k) {
    const float* q = quads + k * kQuadCols;
    const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
    const float no = q[0] * ox + q[1] * oy + q[2] * oz;
    float t = (q[3] - no) / nd;
    const float alpha = (q[4] * ox + q[5] * oy + q[6] * oz) +
                        t * (q[4] * dx + q[5] * dy + q[6] * dz) - q[7];
    const float beta = (q[8] * ox + q[9] * oy + q[10] * oz) +
                       t * (q[8] * dx + q[9] * dy + q[10] * dz) - q[11];
    const bool valid = fabsf(nd) >= 1e-8f && t > kTMin && alpha >= 0.0f &&
                       alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
    t = valid ? t : art::kBig;
    if (t > kTMin && t < h.t)
      h = Hit{t, q[0], q[1], q[2], 0.f, nd > 0.0f ? -1.0f : 1.0f, q[12]};
  }
  const bool hit = h.t < art::kBig;

  // ---- background (src/main.cu:58-67) ----
  float bg0 = a.bg0, bg1 = a.bg1, bg2 = a.bg2;
  if (a.gradient) {
    const float tbg = 0.5f * (dy * inv_dlen + 1.0f);
    bg0 = 1.0f - 0.5f * tbg;
    bg1 = 1.0f - 0.3f * tbg;
    bg2 = 1.0f;
  }
  s.r0 = s.r0 + (hit ? 0.0f : s.t0 * bg0);
  s.r1 = s.r1 + (hit ? 0.0f : s.t1 * bg1);
  s.r2 = s.r2 + (hit ? 0.0f : s.t2 * bg2);
  s.bounce = s.bounce + 1;
  return h;
}

// The second half for slot i that hit at p, material row m, with the
// marble turbulence `turb` (read only on a marble row); returns whether it
// survived.
__device__ bool shade(Slot& s, const Hit& h, float p0, float p1, float p2, const float* m,
                      float turb, float inv_dlen, const SpArgs& a, int i) {
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  const float n0 = h.Sc * (p0 - h.A0) + h.Tn * h.A0;
  const float n1 = h.Sc * (p1 - h.A1) + h.Tn * h.A1;
  const float n2 = h.Sc * (p2 - h.A2) + h.Tn * h.A2;

  // ---- the winner's texture ----
  const float mtype = m[0];
  float tx0 = m[7], tx1 = m[8], tx2 = m[9];
  if (m[6] == 1.0f) {  // checker of solids (src/texture.cuh:35-42)
    const int xi = (int)floorf(m[10] * p0);
    const int yi = (int)floorf(m[10] * p1);
    const int zi = (int)floorf(m[10] * p2);
    if (((xi + yi + zi) & 1) != 0) { tx0 = m[11]; tx1 = m[12]; tx2 = m[13]; }
  } else if (m[6] == 2.0f) {  // marble (src/texture.cuh:62-76)
    const float t = 0.5f * (1.0f + sinf(m[10] * p2 + 10.0f * turb));
    tx0 = t; tx1 = t; tx2 = t;
  }
  const bool is_metal = mtype == 1.0f, is_diel = mtype == 2.0f, is_light = mtype == 3.0f;

  // ---- emission (src/material.cuh:169-172) ----
  s.r0 = s.r0 + (is_light ? s.t0 * tx0 : 0.0f);
  s.r1 = s.r1 + (is_light ? s.t1 * tx1 : 0.0f);
  s.r2 = s.r2 + (is_light ? s.t2 * tx2 : 0.0f);
  if (is_light) return false;

  // ---- the ball's and the choice's uniforms (columns 0..3: Philox call 0,
  // or the injected block's), drawn for a slot that scatters ----
  float u[4];
  if (a.use_philox) {
    art::philox_uniforms(i, a.seed, a.tile, a.chunk, a.it, 4, 1u, u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = a.ublk[(size_t)c * a.R + i];
  }

  // ---- shared in-ball sample (ops/shade.py:_ball_from_uniforms_p) ----
  const float z = 2.0f * u[0] - 1.0f;
  const float phi = art::kTwoPi * u[1];
  const float sball = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float rball = (float)cbrt((double)u[2]);
  const float b0 = rball * sball * cosf(phi), b1 = rball * sball * sinf(phi),
              b2 = rball * z;
  const float ud0 = dx * inv_dlen, ud1 = dy * inv_dlen, ud2 = dz * inv_dlen;

  float dir0 = n0 + b0, dir1 = n1 + b1, dir2 = n2 + b2;  // lambertian
  float at0 = tx0, at1 = tx1, at2 = tx2;
  if (is_metal) {  // src/material.cuh:90-110
    const float udn = ud0 * n0 + ud1 * n1 + ud2 * n2;
    dir0 = (ud0 - 2.0f * udn * n0) + m[1] * b0;
    dir1 = (ud1 - 2.0f * udn * n1) + m[1] * b1;
    dir2 = (ud2 - 2.0f * udn * n2) + m[1] * b2;
    if (!(dir0 * n0 + dir1 * n1 + dir2 * n2 > 0.0f)) return false;
    at0 = m[3]; at1 = m[4]; at2 = m[5];
  } else if (is_diel) {  // src/material.cuh:113-159, book-1 form
    const float ri = m[2];
    const float ddn = dx * n0 + dy * n1 + dz * n2;
    const bool inside = ddn > 0.0f;
    const float o0 = inside ? -n0 : n0, o1 = inside ? -n1 : n1, o2 = inside ? -n2 : n2;
    const float nio = inside ? ri : 1.0f / ri;
    const float cos_raw = ddn * inv_dlen;
    const float cos_inside =
        sqrtf(fmaxf(0.0f, 1.0f - ri * ri * (1.0f - cos_raw * cos_raw)));
    const float cosine = inside ? cos_inside : -cos_raw;
    const float dt = ud0 * o0 + ud1 * o1 + ud2 * o2;
    const float disc = 1.0f - nio * nio * (1.0f - dt * dt);
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    const float x = 1.0f - cosine;
    const float x2 = x * x;
    const float schl = r0 + (1.0f - r0) * (x2 * x2 * x);
    if (u[3] < (disc > 0.0f ? schl : 1.0f)) {
      const float ddn2 = 2.0f * ddn;
      dir0 = dx - ddn2 * n0; dir1 = dy - ddn2 * n1; dir2 = dz - ddn2 * n2;
    } else {
      const float root = sqrtf(fmaxf(disc, 0.0f));
      dir0 = nio * (ud0 - o0 * dt) - o0 * root;
      dir1 = nio * (ud1 - o1 * dt) - o1 * root;
      dir2 = nio * (ud2 - o2 * dt) - o2 * root;
    }
    at0 = 1.0f; at1 = 1.0f; at2 = 1.0f;
  }
  s.t0 = s.t0 * at0; s.t1 = s.t1 * at1; s.t2 = s.t2 * at2;
  s.ox = p0; s.oy = p1; s.oz = p2;
  s.dx = dir0; s.dy = dir1; s.dz = dir2;
  return true;
}

// at most 64 registers, so four blocks (32 warps) fit on an SM
__global__ void __launch_bounds__(art::kBlock, 4) sp_step_kernel(SpArgs a) {
  __shared__ float sh_sph[kMaxPrims * kSphCols];
  __shared__ float sh_quad[kMaxPrims * kQuadCols];
  __shared__ float sh_mat[kMaxPrims * kMatCols];
  __shared__ art::RankShared sh;
  for (int k = threadIdx.x; k < a.S * kSphCols; k += blockDim.x) sh_sph[k] = a.sph[k];
  for (int k = threadIdx.x; k < a.Q * kQuadCols; k += blockDim.x) sh_quad[k] = a.quads[k];
  for (int k = threadIdx.x; k < a.M * kMatCols; k += blockDim.x) sh_mat[k] = a.mats[k];

  const art::RefillPlanes& p = a.p;
  // scan_ticket's __syncthreads also publishes the staged tables
  art::Rank r = art::rank_count(art::scan_ticket(a.scan, sh), p.act, a.R, a.scan, sh);
  art::rank_resolve(r, a.scan, a.q, a.parity, a.sc, sh);
  const int i = r.i;
  const bool act = r.was_act || r.take;

  Slot s{};
  int pix = 0;
  Hit h{art::kBig, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float inv_dlen = 0.f, p0 = 0.f, p1 = 0.f, p2 = 0.f;
  const float* m = sh_mat;
  if (act) {
    // ---- the refilled state: a fresh camera ray from the jitter, lens and
    // time columns (4..8), or the pool's ----
    if (r.take) {
      float u[art::kMaxCols];
      if (a.use_philox) {
        art::philox_uniforms(i, a.seed, a.tile, a.chunk, a.it, a.ncols,
                             art::kCameraCall | 1u << 2, u);
      } else {
#pragma unroll
        for (int c = 4; c < 9; ++c) u[c] = a.ublk[(size_t)c * a.R + i];
      }
      const art::Ray ray = art::camera_ray(r.qq, a.sc, a.cam, u);
      s = Slot{ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, 1.f, 1.f, 1.f,
               0.f, 0.f, 0.f, 0};
      pix = ray.p_row;
      p.tm[i] = ray.tm;
      p.pix[i] = pix;
    } else {
      s = Slot{p.ox[i], p.oy[i], p.oz[i], p.dx[i], p.dy[i], p.dz[i], p.t0[i], p.t1[i],
               p.t2[i], p.r0[i], p.r1[i], p.r2[i], p.bounce[i]};
      pix = p.pix[i];
    }

    const float aa = s.dx * s.dx + s.dy * s.dy + s.dz * s.dz;
    inv_dlen = 1.0f / sqrtf(aa);
    h = closest_hit(s, aa, inv_dlen, a, sh_sph, sh_quad);
    if (h.t < art::kBig) {
      p0 = s.ox + h.t * s.dx; p1 = s.oy + h.t * s.dy; p2 = s.oz + h.t * s.dz;
      m = sh_mat + min(max((int)h.mat, 0), a.M - 1) * kMatCols;
    }
  }
  const bool hit = h.t < art::kBig;  // false for a slot that is not live

  // ---- one turbulence for a marble winner, every lane of the warp taking
  // part (a miss never gets there, so p needs no clamp) ----
  const float turb = art::turbulence_warp<7>(p0, p1, p2, hit && m[6] == 2.0f, 7);

  bool died = false;
  if (act) {
    const bool survived = hit && shade(s, h, p0, p1, p2, m, turb, inv_dlen, a, i);
    if (survived || r.take) {
      p.ox[i] = s.ox; p.oy[i] = s.oy; p.oz[i] = s.oz;
      p.dx[i] = s.dx; p.dy[i] = s.dy; p.dz[i] = s.dz;
      p.t0[i] = s.t0; p.t1[i] = s.t1; p.t2[i] = s.t2;
    }
    p.r0[i] = s.r0; p.r1[i] = s.r1; p.r2[i] = s.r2;
    p.bounce[i] = s.bounce;
    died = !(survived && s.bounce < a.max_depth);
    p.act[i] = !died;
    if (died && (pix < 0 || pix >= a.P)) atomicAdd(a.lost, 1);
  }
  // ---- flush the radiance of the slots that died inside the tile ----
  art::flush_warp(died && pix >= 0 && pix < a.P, pix, s.r0, s.r1, s.r2, a.fb);
  if (r.live) a.died[i] = died;

  // ---- live slots this iteration, and the next queue head ----
  art::refill_finish(act, a.scan, a.q, a.parity, a.hist, a.it, a.sc, sh);
}

}  // namespace

// ptrs: the refill planes (refill.cuh refill_planes: 13 f32, bounce pix i32,
//       act u8), u (f32 (ncols, R) injected block; null with use_philox),
//       scan (K1's look-back scratch, refill.cu), q (i64 x2), hist (i64, > it
//       entries), died (u8 (R,)), fb (f32 (P, 3)), lost (i32 (1,)).
// epoch: this call's stamp of the scan words (refill.cu art_refill).
// scal: spp, P, pix_offset, total_pixels, nx, ny.  cam: pack_camera layout.
// bg: the solid background (3 f32).  sph (S, 6), quads (Q, 13), mats (M, 14):
// scene/tables.py sp_rows; S + Q and M at most 16.
extern "C" int art_sp_step(void* const* ptrs, int R, int parity, int ncols, int use_philox,
                           const long long* scal, const float* cam, unsigned seed,
                           unsigned tile, unsigned chunk, unsigned it, unsigned epoch,
                           const float* bg, int gradient, int max_depth, int P,
                           const float* sph, int S, const float* quads, int Q,
                           const float* mats, int M, void* stream) {
  if (S < 0 || Q < 0 || S + Q > kMaxPrims || M < 1 || M > kMaxPrims)
    return (int)cudaErrorInvalidValue;
  SpArgs a;
  a.p = art::refill_planes(ptrs);
  a.ublk = (const float*)ptrs[16];
  a.scan = art::scan_of(ptrs[17], R, epoch);
  a.q = (long long*)ptrs[18];
  a.hist = (unsigned long long*)ptrs[19];
  a.died = (uint8_t*)ptrs[20];
  a.fb = (float*)ptrs[21];
  a.lost = (int*)ptrs[22];
  a.R = R;
  a.parity = parity;
  a.sc = art::Scal{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5]};
  for (int k = 0; k < 21; ++k) a.cam.v[k] = cam[k];
  a.ncols = ncols;
  a.use_philox = use_philox;
  a.seed = seed; a.tile = tile; a.chunk = chunk; a.it = it;
  a.bg0 = bg[0]; a.bg1 = bg[1]; a.bg2 = bg[2];
  a.gradient = gradient; a.max_depth = max_depth; a.P = P;
  a.sph = sph; a.S = S; a.quads = quads; a.Q = Q; a.mats = mats; a.M = M;
  if (a.scan.nb == 0) return 0;
  sp_step_kernel<<<a.scan.nb, art::kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
