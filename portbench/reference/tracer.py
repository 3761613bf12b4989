"""A plain path tracer in PyTorch: the benchmark's reference.

It follows Shirley's "Ray Tracing in One Weekend" and "The Next Week" as the
reference repository (slbouknight/accelerated-ray-tracer, ``src/``) runs them:
a thin-lens camera with a shutter, moving spheres, quads and axis-aligned
boxes (slab test), constant media in a sphere boundary, lambertian
(``n + random_in_unit_sphere``), metal (fuzz times a point in the unit
ball), dielectric (Schlick, Book 1's cosine), diffuse lights (two-sided) and
isotropic scattering, solid, checker, nearest-texel image and marble
textures, ``t_min`` = 0.001 and at most ``max_depth`` segments a path.  Its
random numbers are its own (``torch.Generator``), so it agrees with the
program in distribution, not sample by sample.  Every operation runs in
``dtype``: float32 for the reference, bfloat16 for the control.

It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import perlin
from portbench.reference.scene import (
    CHECKER,
    DIELECTRIC,
    IMAGE,
    ISOTROPIC,
    LIGHT,
    METAL,
    NOISE,
    RefScene,
)

T_MIN = 1e-3
BIG = 1e30
CHUNK = 128  # primitives per broadcast block


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(a):
    return a / torch.sqrt(_dot(a, a)).unsqueeze(-1)


def _reflect(v, n):
    return v - 2.0 * _dot(v, n).unsqueeze(-1) * n


class Tracer:
    """The scene's tables on ``device`` in ``dtype``; ``radiance`` traces
    paths from pixel ids."""

    def __init__(self, scene: RefScene, device, dtype=torch.float32):
        self.s, self.dev, self.dt = scene, torch.device(device), dtype

        def t(a):
            return torch.as_tensor(a, device=self.dev).to(dtype)

        self.sph_c0, self.sph_vel, self.sph_r = t(scene.sph_c0), t(scene.sph_vel), t(scene.sph_r)
        self.sph_moving = bool((scene.sph_vel != 0).any())
        self.sph_mat = torch.as_tensor(scene.sph_mat, device=self.dev)
        self.quad_q, self.quad_u, self.quad_v = t(scene.quad_q), t(scene.quad_u), t(scene.quad_v)
        qn = torch.cross(self.quad_u, self.quad_v, dim=-1)
        self.quad_n = _unit(qn)
        self.quad_w = qn / _dot(qn, qn).unsqueeze(-1)
        self.quad_d = _dot(qn, self.quad_q)
        self.quad_nn = qn
        self.quad_mat = torch.as_tensor(scene.quad_mat, device=self.dev)
        self.box_min, self.box_max = t(scene.box_min), t(scene.box_max)
        self.box_mat = torch.as_tensor(scene.box_mat, device=self.dev)
        mats = scene.materials
        self.mat_kind = torch.tensor([m.kind for m in mats], device=self.dev)
        self.mat_tex = torch.tensor([m.tex for m in mats], device=self.dev)
        self.mat_albedo = t([m.albedo for m in mats])
        self.mat_fuzz = t([m.fuzz for m in mats])
        self.mat_ref = t([m.ref_idx for m in mats])
        texs = scene.textures
        self.tex_kind = torch.tensor([x.kind for x in texs], device=self.dev)
        self.tex_rgb = t([x.rgb for x in texs])
        self.tex_scale = t([x.scale for x in texs])
        self.tex_even = torch.tensor([x.even for x in texs], device=self.dev)
        self.tex_odd = torch.tensor([x.odd for x in texs], device=self.dev)
        self.images = {i: torch.as_tensor(x.image, device=self.dev)
                       for i, x in enumerate(texs) if x.kind == IMAGE}
        self.cam = {k: (t(v) if hasattr(v, "shape") else v)
                    for k, v in scene.camera.frame(scene.nx, scene.ny).items()}
        self.background = t(scene.background)

    # ---- random numbers -------------------------------------------------
    def _rand(self, gen, n, k):
        return torch.rand((n, k), generator=gen, device=self.dev).to(self.dt)

    def _ball(self, gen, n):
        """Uniform points in the unit ball: a Gaussian direction, radius
        u^(1/3)."""
        g = torch.randn((n, 3), generator=gen, device=self.dev)
        g = g / g.norm(dim=1, keepdim=True).clamp_min(1e-20)
        r = torch.rand((n, 1), generator=gen, device=self.dev).pow(1.0 / 3.0)
        return (g * r).to(self.dt)

    # ---- camera -----------------------------------------------------------
    def camera_rays(self, pix, gen):
        s, c = self.s, self.cam
        n = pix.shape[0]
        u = self._rand(gen, n, 5)
        i = (pix % s.nx).to(self.dt)
        j = torch.div(pix, s.nx, rounding_mode="floor").to(self.dt)
        sx = ((i + u[:, 0]) / s.nx).unsqueeze(1)
        ty = ((j + u[:, 1]) / s.ny).unsqueeze(1)
        r = c["lens_radius"] * torch.sqrt(u[:, 2])
        phi = 2.0 * math.pi * u[:, 3]
        off = ((r * torch.cos(phi)).unsqueeze(1) * c["u"]
               + (r * torch.sin(phi)).unsqueeze(1) * c["v"])
        o = c["origin"] + off
        d = c["llc"] + sx * c["horizontal"] + ty * c["vertical"] - o
        tm = c["time0"] + u[:, 4] * (c["time1"] - c["time0"])
        return o, d, tm

    # ---- intersection -----------------------------------------------------
    def _spheres(self, o, d, tm, best_t, best_id):
        a = _dot(d, d).unsqueeze(1)
        for lo in range(0, self.sph_r.shape[0], CHUNK):
            c = self.sph_c0[lo:lo + CHUNK].unsqueeze(0)
            if self.sph_moving:
                c = c + tm[:, None, None] * self.sph_vel[lo:lo + CHUNK].unsqueeze(0)
            oc = o.unsqueeze(1) - c
            b = (oc * d.unsqueeze(1)).sum(-1)
            cc = (oc * oc).sum(-1) - self.sph_r[lo:lo + CHUNK] ** 2
            disc = b * b - a * cc
            sq = torch.sqrt(disc.clamp_min(0.0))
            t1, t2 = (-b - sq) / a, (-b + sq) / a
            t = torch.where(t1 > T_MIN, t1, torch.where(t2 > T_MIN, t2, BIG))
            t = torch.where(disc > 0.0, t, BIG)
            tmin, k = t.min(dim=1)
            better = tmin < best_t
            best_t = torch.where(better, tmin, best_t)
            best_id = torch.where(better, 2_000_000 + lo + k, best_id)
        return best_t, best_id

    def _quads(self, o, d, best_t, best_id):
        for k in range(self.quad_mat.shape[0]):
            nn = self.quad_nn[k]
            den = _dot(d, nn)
            ok = den.abs() >= 1e-8
            t = (self.quad_d[k] - _dot(o, nn)) / torch.where(ok, den, 1.0)
            pl = o + t.unsqueeze(1) * d - self.quad_q[k]
            w = self.quad_w[k]
            al = _dot(w, torch.cross(pl, self.quad_v[k].expand_as(pl), dim=-1))
            be = _dot(w, torch.cross(self.quad_u[k].expand_as(pl), pl, dim=-1))
            ok = ok & (t > T_MIN) & (al >= 0) & (al <= 1) & (be >= 0) & (be <= 1) & (t < best_t)
            best_t = torch.where(ok, t, best_t)
            best_id = torch.where(ok, k, best_id)
        return best_t, best_id

    @staticmethod
    def _slabs(o, d, mn, mx):
        tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
        inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
        ta, tb = (mn - o) * inv, (mx - o) * inv
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    def _boxes(self, o, d, best_t, best_id):
        for lo in range(0, self.box_mat.shape[0], CHUNK):
            t0, t1 = self._slabs(o.unsqueeze(1), d.unsqueeze(1),
                                 self.box_min[lo:lo + CHUNK], self.box_max[lo:lo + CHUNK])
            tn, tf = t0.max(-1).values, t1.min(-1).values
            t = torch.where(tn > T_MIN, tn, torch.where(tf > T_MIN, tf, BIG))
            t = torch.where(tn < tf, t, BIG)
            tmin, k = t.min(dim=1)
            better = tmin < best_t
            best_t = torch.where(better, tmin, best_t)
            best_id = torch.where(better, 1_000_000 + lo + k, best_id)
        return best_t, best_id

    def closest(self, o, d, tm):
        """(t, id): id < 1e6 a quad, < 2e6 a box (1e6 + index), else a
        sphere (2e6 + index); t = BIG on a miss.  Quads, boxes and spheres
        merge in that order, a later kind winning only when strictly closer."""
        n = o.shape[0]
        best_t = torch.full((n,), BIG, dtype=self.dt, device=self.dev)
        best_id = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        best_t, best_id = self._quads(o, d, best_t, best_id)
        best_t, best_id = self._boxes(o, d, best_t, best_id)
        return self._spheres(o, d, tm, best_t, best_id)

    def attributes(self, o, d, tm, t, pid):
        """Point, unit normal facing as the reference does (spheres outward,
        quads and boxes against the ray), (u, v) and material of each hit."""
        n = o.shape[0]
        p = o + t.unsqueeze(1) * d
        normal = torch.zeros_like(o)
        uv = torch.zeros((n, 2), dtype=self.dt, device=self.dev)
        mat = torch.zeros(n, dtype=torch.int64, device=self.dev)
        q = pid < 1_000_000
        if q.any():
            k = pid[q]
            nq = self.quad_n[k]
            nq = torch.where((_dot(nq, d[q]) > 0).unsqueeze(1), -nq, nq)
            normal[q], mat[q] = nq, self.quad_mat[k]
        bx = (pid >= 1_000_000) & (pid < 2_000_000)
        if bx.any():
            k = pid[bx] - 1_000_000
            ob, db = o[bx], d[bx]
            t0, t1 = self._slabs(ob, db, self.box_min[k], self.box_max[k])
            tn, tf = t0.max(-1), t1.min(-1)
            entry = (t[bx] - tn.values).abs() <= (t[bx] - tf.values).abs()
            axis = torch.where(entry, tn.indices, tf.indices)
            sgn = torch.where(db.gather(1, axis[:, None])[:, 0] >= 0, -1.0, 1.0).to(self.dt)
            nb = torch.zeros_like(ob)
            nb.scatter_(1, axis[:, None], sgn[:, None])
            normal[bx], mat[bx] = nb, self.box_mat[k]
        sp = pid >= 2_000_000
        if sp.any():
            k = pid[sp] - 2_000_000
            c = self.sph_c0[k] + tm[sp].unsqueeze(1) * self.sph_vel[k]
            ns = (p[sp] - c) / self.sph_r[k].unsqueeze(1)
            theta = torch.acos((-ns[:, 1]).clamp(-1.0, 1.0))
            phi = torch.atan2(-ns[:, 2], ns[:, 0]) + math.pi
            normal[sp], mat[sp] = ns, self.sph_mat[k]
            uv[sp] = torch.stack([phi / (2 * math.pi), theta / math.pi], 1).to(self.dt)
        return p, normal, uv, mat

    def media(self, o, d, best_t, gen):
        """Constant media (The Next Week §9) over the surface hit: a medium
        event at a free flight of -ln(u)/density inside the boundary's span,
        clipped to [t_min, surface t], wins when closer.  Returns (t, the
        medium's material or -1)."""
        n = o.shape[0]
        ray_len = torch.sqrt(_dot(d, d))
        med = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        for center, radius, density, mat in self.s.media:
            oc = o - torch.as_tensor(center, device=self.dev).to(self.dt)
            a, b = _dot(d, d), _dot(oc, d)
            disc = b * b - a * (_dot(oc, oc) - radius * radius)
            sq = torch.sqrt(disc.clamp_min(0.0))
            entry, exit_ = (-b - sq) / a, (-b + sq) / a
            rec1 = entry.clamp_min(T_MIN)
            rec2 = torch.minimum(exit_, best_t)
            ok = (disc > 0) & (exit_ - entry > 1e-4) & (rec1 < rec2)
            u = 1.0 - torch.rand(n, generator=gen, device=self.dev)  # (0, 1]
            dist = (-(1.0 / density) * torch.log(u)).to(self.dt)
            tm = rec1 + dist / ray_len
            hit = ok & (dist <= (rec2 - rec1) * ray_len) & (tm < best_t)
            best_t = torch.where(hit, tm, best_t)
            med = torch.where(hit, mat, med)
        return best_t, med

    # ---- textures and materials ---------------------------------------------
    def texture(self, tex, uv, p):
        for _ in range(3):  # checker children
            chk = self.tex_kind[tex] == CHECKER
            if not chk.any():
                break
            inv = 1.0 / self.tex_scale[tex]
            f = torch.floor(inv.unsqueeze(1) * p).to(torch.int64).sum(1)
            child = torch.where(f % 2 == 0, self.tex_even[tex], self.tex_odd[tex])
            tex = torch.where(chk, child, tex)
        kind = self.tex_kind[tex]
        col = self.tex_rgb[tex].clone()
        for img_id, img in self.images.items():
            m = tex == img_id
            if m.any():
                h, w = img.shape[0], img.shape[1]
                u = uv[m, 0].clamp(0.0, 1.0).float()
                v = uv[m, 1].clamp(0.0, 1.0).float()
                i = torch.clamp((u * w).to(torch.int64), max=w - 1)
                j = torch.clamp(((1.0 - v) * h).to(torch.int64), max=h - 1)
                col[m] = (img[j, i].float() / 255.0).to(self.dt)
        nz = kind == NOISE
        if nz.any():
            pn = p[nz]
            val = 0.5 * (1.0 + torch.sin(self.tex_scale[tex[nz]] * pn[:, 2]
                                         + 10.0 * perlin.turbulence(pn, 7)))
            col[nz] = val.unsqueeze(1).expand(-1, 3)
        return col

    def scatter(self, d, p, normal, uv, mat, gen):
        """(emitted, attenuation, new direction, scattered) of each hit."""
        n = d.shape[0]
        kind = self.mat_kind[mat]
        texcol = self.texture(self.mat_tex[mat].clamp_min(0), uv, p)
        ball = self._ball(gen, n)
        emitted = torch.where((kind == LIGHT).unsqueeze(1), texcol, 0.0)
        # lambertian
        direction = normal + ball
        att = texcol
        # metal
        metal = (kind == METAL).unsqueeze(1)
        mdir = _reflect(_unit(d), normal) + self.mat_fuzz[mat].unsqueeze(1) * ball
        direction = torch.where(metal, mdir, direction)
        att = torch.where(metal, self.mat_albedo[mat], att)
        alive = (kind != LIGHT) & ((kind != METAL) | (_dot(mdir, normal) > 0))
        # dielectric
        ref = self.mat_ref[mat]
        dn = _dot(d, normal)
        inside = dn > 0
        out_n = torch.where(inside.unsqueeze(1), -normal, normal)
        ni = torch.where(inside, ref, 1.0 / ref)
        cos_raw = dn / torch.sqrt(_dot(d, d))
        cosine = torch.where(inside, torch.sqrt((1.0 - ref * ref * (1.0 - cos_raw * cos_raw))
                                                .clamp_min(0.0)), -cos_raw)
        ud = _unit(d)
        dt = _dot(ud, out_n)
        disc = 1.0 - ni * ni * (1.0 - dt * dt)
        refr = ni.unsqueeze(1) * (ud - out_n * dt.unsqueeze(1)) \
            - out_n * torch.sqrt(disc.clamp_min(0.0)).unsqueeze(1)
        r0 = ((1.0 - ref) / (1.0 + ref)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cosine) ** 5
        prob = torch.where(disc > 0, schlick, 1.0)
        u = torch.rand(n, generator=gen, device=self.dev).to(self.dt)
        ddir = torch.where((u < prob).unsqueeze(1), _reflect(d, normal), refr)
        diel = (kind == DIELECTRIC).unsqueeze(1)
        direction = torch.where(diel, ddir, direction)
        att = torch.where(diel, 1.0, att)
        iso = (kind == ISOTROPIC).unsqueeze(1)
        direction = torch.where(iso, ball, direction)
        return emitted, att, direction, alive

    # ---- paths ------------------------------------------------------------
    def radiance(self, pix: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """(n, 3) float32 radiance of one path from each pixel id in ``pix``."""
        n = pix.shape[0]
        out = torch.zeros((n, 3), dtype=torch.float32, device=self.dev)
        o, d, tm = self.camera_rays(pix, gen)
        ids = torch.arange(n, device=self.dev)
        thr = torch.ones((n, 3), dtype=self.dt, device=self.dev)
        for _ in range(self.s.max_depth):
            if ids.numel() == 0:
                break
            t, pid = self.closest(o, d, tm)
            t, med = self.media(o, d, t, gen)
            hit = t < BIG
            miss = ~hit
            if miss.any():
                out.index_add_(0, ids[miss], (thr[miss] * self.background).float())
            o, d, tm, thr, ids, t, pid, med = (x[hit] for x in (o, d, tm, thr, ids, t, pid, med))
            p, normal, uv, mat = self.attributes(o, d, tm, t, pid.clamp_min(0))
            inm = med >= 0
            if inm.any():
                p[inm] = o[inm] + t[inm].unsqueeze(1) * d[inm]
                normal[inm] = torch.tensor([1.0, 0.0, 0.0], dtype=self.dt, device=self.dev)
                uv[inm] = 0.0
                mat = torch.where(inm, med, mat)
            emitted, att, direction, alive = self.scatter(d, p, normal, uv, mat, gen)
            out.index_add_(0, ids, (thr * emitted).float())
            thr = thr * att
            o, d, tm, thr, ids = (x[alive] for x in (p, direction, tm, thr, ids))
        return out
