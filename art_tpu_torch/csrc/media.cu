// K18 — the constant media over the surface hit record, one thread per ray.
//
// Replaces no Pallas kernel: art_tpu computes the media in jnp
// (art_tpu/ops/intersect.py:844 apply_media_p), and the port's plain twin
// (ops/intersect.py apply_media_p_plain) enqueues ~69 elementwise ATen
// launches a medium.  It was added to take those launches (138 on
// final_scene's two media) and their host time off the staged loop, which
// the host bounds.
//
// For each ray and each medium in table order (scene/tables.py med_rows:
// [kind -1/density mat ...]): the boundary interval over the whole line —
// kind 0 a sphere's two roots, kind 1 an oriented box (the ray in the box
// frame, then the slabs), kind 2 two first-hit walks over the medium's own
// boundary rows, the second from entry + 1e-4 (src/constant_medium.cuh:
// 38-44) — kept for kinds 0 and 1 when exit - entry > 1e-4; clipped to
// [t_min, best t]; the free flight -1/density * log(max(u, 1e-6)) from the
// medium's uniform row; a scatter at t_m = rec1 + distance / |d| inside the
// interval wins on a strict t_m < best t.  A scattered ray gets the
// medium's material, p = o + t d, normal (1, 0, 0) and u = v = 0; every
// other lane copies the surface record.  The kind comes from the table, so
// one kernel serves every scene.  The twin's operation order throughout
// (-fmad=false, no fast math): dots as (x x + y y) + z z, disc = b b - a
// (oc.oc - r r), sqrt(clamp_min(disc, 0)), (-b -/+ s) / a; torch.minimum /
// maximum / clamp_min as art::nan_min / nan_max and a NaN-keeping max;
// logf, sqrtf and the divisions IEEE as ATen's on the card.
//
// Bound on the H100: bytes.  Per ray 16 planes of 4 B and the hit byte in
// (o, d, the record's t, p, normal, u, v, mat), one uniform a medium, 9
// float planes, hit and mat out: 114 B at two media, 15 MB at R = 2^17, ~4.5
// us at 3.35 TB/s, against ~60 FP32 operations and a logf a medium.
// Design: planar loads and stores, neighbouring threads on neighbouring
// addresses, 256 threads a block; the medium table (two rows on
// final_scene) read through the read-only cache at one address a warp, a
// broadcast; the uniform rows read at the refill block's row stride, so the
// wrapper hands one pointer.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kRow = 16;  // scene/tables.py MED_ROW

struct MediaPlanes {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float* tm;  // null: time 0 (only kind 2's moving spheres read it)
  const float *t, *px, *py, *pz, *nx, *ny, *nz, *u, *v;  // the surface record
  const bool* hit;
  const int* mat;
  const float* um;  // medium m's uniform of ray i at um[m * um_stride + i]
  float* out;       // (9, R): t, p(3), normal(3), u, v
  bool* out_hit;
  int* out_mat;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// torch.clamp_min with a scalar: a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// the roots of the full quadratic through the sphere (c, r), valid where
// disc > 0 (ops/intersect.py _sphere_interval)
__device__ __forceinline__ bool sphere_interval(const Ray& r, float cx, float cy, float cz,
                                                float rad, float& t1, float& t2) {
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  const float a = (r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz;
  const float b = (ocx * r.dx + ocy * r.dy) + ocz * r.dz;
  const float disc = b * b - a * (((ocx * ocx + ocy * ocy) + ocz * ocz) - rad * rad);
  const float s = sqrtf(clamp_min(disc, 0.0f));
  t1 = (-b - s) / a;
  t2 = (-b + s) / a;
  return disc > 0.0f;
}

// one slab of ops/intersect.py _slabs, on safe_dir's clamped direction
__device__ __forceinline__ void slab(float lo, float ld, float mn, float mx, float& t0,
                                     float& t1) {
  const float sd = fabsf(ld) < 1e-12f ? (ld >= 0.0f ? 1e-12f : -1e-12f) : ld;
  const float inv = 1.0f / sd;
  const float ta = (mn - lo) * inv, tb = (mx - lo) * inv;
  t0 = art::nan_min(ta, tb);
  t1 = art::nan_max(ta, tb);
}

// (entry, exit) through the oriented box b = [min(3) max(3) cos sin off(3)]
// (ops/intersect.py _box_interval: p_rotate_y_inv, then the slabs)
__device__ __forceinline__ void box_interval(const Ray& r, const float* __restrict__ b,
                                             float& entry, float& exit) {
  const float c = __ldg(b + 6), s = __ldg(b + 7);
  const float px = r.ox - __ldg(b + 8), py = r.oy - __ldg(b + 9), pz = r.oz - __ldg(b + 10);
  float t0x, t1x, t0y, t1y, t0z, t1z;
  slab(c * px - s * pz, c * r.dx - s * r.dz, __ldg(b + 0), __ldg(b + 3), t0x, t1x);
  slab(py, r.dy, __ldg(b + 1), __ldg(b + 4), t0y, t1y);
  slab(s * px + c * pz, s * r.dx + c * r.dz, __ldg(b + 2), __ldg(b + 5), t0z, t1z);
  entry = art::nan_max(art::nan_max(t0x, t0y), t0z);
  exit = art::nan_min(art::nan_min(t1x, t1y), t1z);
}

// the closest hit with t > t_lo over a kind-2 medium's boundary rows
// (ops/intersect.py _gb_first_hit): spheres, then quads, then boxes
__device__ float first_hit(const float* __restrict__ tab, const float* __restrict__ med,
                           const Ray& r, float time, float t_lo, bool& hit) {
  float best = art::kBig;
  hit = false;
  auto consider = [&](float t, bool ok) {
    if (ok && t > t_lo && t < best) {
      best = t;
      hit = true;
    }
  };
  const int s0 = (int)__ldg(med + 3), ns = (int)__ldg(med + 4);
  for (int k = s0; k < s0 + ns; ++k) {  // [c(3) vel(3) r]
    const float* q = tab + (size_t)k * kRow;
    float t1, t2;
    const bool crosses = sphere_interval(r, __ldg(q + 0) + time * __ldg(q + 3),
                                         __ldg(q + 1) + time * __ldg(q + 4),
                                         __ldg(q + 2) + time * __ldg(q + 5), __ldg(q + 6),
                                         t1, t2);
    consider(t1 > t_lo ? t1 : t2, crosses);
  }
  const int q0 = (int)__ldg(med + 5), nq = (int)__ldg(med + 6);
  for (int k = q0; k < q0 + nq; ++k) {  // [q(3) u(3) v(3) w(3) n(3) d]
    const float* q = tab + (size_t)k * kRow;
    const float n0 = __ldg(q + 12), n1 = __ldg(q + 13), n2 = __ldg(q + 14);
    const float denom = (n0 * r.dx + n1 * r.dy) + n2 * r.dz;
    const bool ok = fabsf(denom) > 1e-8f;  // src/quad.cuh:63-65
    const float t = (__ldg(q + 15) - ((n0 * r.ox + n1 * r.oy) + n2 * r.oz)) /
                    (ok ? denom : 1.0f);
    const float plx = (r.ox + t * r.dx) - __ldg(q + 0);
    const float ply = (r.oy + t * r.dy) - __ldg(q + 1);
    const float plz = (r.oz + t * r.dz) - __ldg(q + 2);
    const float u0 = __ldg(q + 3), u1 = __ldg(q + 4), u2 = __ldg(q + 5);
    const float v0 = __ldg(q + 6), v1 = __ldg(q + 7), v2 = __ldg(q + 8);
    const float w0 = __ldg(q + 9), w1 = __ldg(q + 10), w2 = __ldg(q + 11);
    // alpha = w . (pl x v), beta = w . (u x pl)
    const float alpha = (w0 * (ply * v2 - plz * v1) + w1 * (plz * v0 - plx * v2)) +
                        w2 * (plx * v1 - ply * v0);
    const float beta = (w0 * (u1 * plz - u2 * ply) + w1 * (u2 * plx - u0 * plz)) +
                       w2 * (u0 * ply - u1 * plx);
    consider(t, ok && alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f);
  }
  const int b0 = (int)__ldg(med + 7), nb = (int)__ldg(med + 8);
  for (int k = b0; k < b0 + nb; ++k) {  // [min(3) max(3) cos sin off(3)]
    float entry, exit;
    box_interval(r, tab + (size_t)k * kRow, entry, exit);
    consider(entry > t_lo ? entry : exit, entry < exit);
  }
  return best;
}

__global__ void __launch_bounds__(art::kBlock)
media_kernel(const float* __restrict__ tab, int C, int R, float t_min, long long um_stride,
             MediaPlanes p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const Ray r{p.ox[i], p.oy[i], p.oz[i], p.dx[i], p.dy[i], p.dz[i]};
  const float ray_len = sqrtf((r.dx * r.dx + r.dy * r.dy) + r.dz * r.dz);
  const bool len_ok = ray_len > 0.0f && ray_len <= FLT_MAX;  // > 0 and finite
  float best = p.t[i];
  int mat = p.mat[i];
  bool in_medium = false;
  for (int m = 0; m < C; ++m) {
    const float* med = tab + (size_t)m * kRow;
    const int kind = (int)__ldg(med + 0);
    float entry, exit;
    bool bnd_ok;
    if (kind == 0) {
      bnd_ok = sphere_interval(r, __ldg(med + 3), __ldg(med + 4), __ldg(med + 5),
                               __ldg(med + 6), entry, exit);
    } else if (kind == 1) {
      box_interval(r, med + 3, entry, exit);
      bnd_ok = entry < exit;
    } else {
      const float time = p.tm ? p.tm[i] : 0.0f;
      bool hit1, hit2;
      entry = first_hit(tab, med, r, time, -art::kBig, hit1);
      exit = first_hit(tab, med, r, time, entry + 1e-4f, hit2);
      bnd_ok = hit1 && hit2;
    }
    if (kind != 2) bnd_ok = bnd_ok && (exit - entry) > 1e-4f;
    const float rec1 = clamp_min(entry, t_min);
    const float rec2 = art::nan_min(exit, best);
    const bool ok = bnd_ok && rec1 < rec2 && len_ok;
    const float distance_inside = (rec2 - rec1) * ray_len;
    const float hit_distance =
        __ldg(med + 1) * logf(clamp_min(p.um[(long long)m * um_stride + i], 1e-6f));
    const float t_m = rec1 + hit_distance / ray_len;
    if (ok && hit_distance <= distance_inside && t_m < best) {
      best = t_m;
      in_medium = true;
      mat = (int)__ldg(med + 2);
    }
  }
  const size_t n = (size_t)R;
  float* out = p.out;
  out[i] = best;
  if (in_medium) {
    out[n + i] = r.ox + best * r.dx;
    out[2 * n + i] = r.oy + best * r.dy;
    out[3 * n + i] = r.oz + best * r.dz;
    out[4 * n + i] = 1.0f;
    out[5 * n + i] = 0.0f;
    out[6 * n + i] = 0.0f;
    out[7 * n + i] = 0.0f;
    out[8 * n + i] = 0.0f;
  } else {
    out[n + i] = p.px[i];
    out[2 * n + i] = p.py[i];
    out[3 * n + i] = p.pz[i];
    out[4 * n + i] = p.nx[i];
    out[5 * n + i] = p.ny[i];
    out[6 * n + i] = p.nz[i];
    out[7 * n + i] = p.u[i];
    out[8 * n + i] = p.v[i];
  }
  p.out_hit[i] = p.hit[i] || in_medium;
  p.out_mat[i] = mat;
}

}  // namespace

// tab: med_rows (C + G, 16); um_stride: floats between two media's uniform
// rows.  planes: ox oy oz dx dy dz tm (null: time 0), the surface record's t
// px py pz nx ny nz u v (f32), hit (bool), mat (i32), medium 0's uniform row
// (in); the (9, R) f32 block t p(3) normal(3) u v, hit (bool), mat (i32)
// (out); all (R,)
extern "C" int art_media(const float* tab, int C, int R, float t_min, long long um_stride,
                         void* const* planes, void* stream) {
  MediaPlanes p;
  const float* const* f = (const float* const*)planes;
  p.ox = f[0]; p.oy = f[1]; p.oz = f[2];
  p.dx = f[3]; p.dy = f[4]; p.dz = f[5];
  p.tm = f[6];
  p.t = f[7];
  p.px = f[8]; p.py = f[9]; p.pz = f[10];
  p.nx = f[11]; p.ny = f[12]; p.nz = f[13];
  p.u = f[14]; p.v = f[15];
  p.hit = (const bool*)planes[16];
  p.mat = (const int*)planes[17];
  p.um = f[18];
  p.out = (float*)planes[19];
  p.out_hit = (bool*)planes[20];
  p.out_mat = (int*)planes[21];
  const int grid = (R + art::kBlock - 1) / art::kBlock;
  if (grid > 0)
    media_kernel<<<grid, art::kBlock, 0, (cudaStream_t)stream>>>(tab, C, R, t_min, um_stride,
                                                                 p);
  return (int)cudaGetLastError();
}
