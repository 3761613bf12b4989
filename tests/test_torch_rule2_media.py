"""The arithmetic of K18 (``csrc/media.cu``: the constant media over the
surface hit record in one launch), held on the CPU on numpy-seeded inputs,
bit for bit.

* (a) A float32 model of the kernel's own operation order
  (``_kernel_order``: numpy float32, reading ``tables.med_rows`` as the
  kernel reads it, each product and sum rounded, sums left to right) equals
  the twin ``apply_media_p_plain`` in every output, signed zeros included,
  on the tables of final_scene (two spheres), original_scene (one sphere),
  cornell_smoke (two rotated boxes) and a table of every kind
  (``chip_smoke._every_kind_media``: an analytic sphere, a rotated box, and
  kind-2 boundaries from tests/test_media_general.py's cases, a group of a
  box and a sphere, a bare quad, a union of two boxes, a moving sphere).  The rays start inside a
  medium, cross it, graze it (disc near 0), miss it, run parallel to a
  box's slab (exact zero and sub-1e-12 direction components) or have no
  direction at all; u sits at 0, 1e-6, 1 - 2^-24 and 1e-7 on some lanes;
  the surface hit lies before, inside or beyond the medium, or is a miss.
  The log is torch's on both sides: on the card ``chip_smoke.py`` holds
  the kernel's ``logf`` to ATen's ``log`` with the rest.
* (b) ``apply_media_p`` takes the twin for CPU tensors and with
  ``plain=True`` (no launch); (c) a scene with no media gets ``surf`` back.
* (d) ``med_rows`` holds each medium's fields and, for kind 2, the ranges of
  its own boundary rows in ``gb_*`` order.
* (e) K18's wrapper refuses uniform rows that are not one row stride apart
  and a plane of the wrong type before it loads the library.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from art_tpu_torch.core.vecmath import BIG, T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import media_kernel
from art_tpu_torch.ops.intersect import HitRecordP, apply_media_p, apply_media_p_plain

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
R = 6144
F = np.float32
TABLES = ("final_scene", "original_scene", "cornell_smoke", "every_kind")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _tables(name):
    if name == "every_kind":  # the table chip_smoke.py holds K18 to on the card
        return _smoke()._every_kind_media()
    return build_scene(name, 32, 32).tables


def _box_anchor(row):
    """(center, half diagonal) of an oriented box row [min max cos sin off]."""
    mid, half = (row[0:3] + row[3:6]) / 2, np.linalg.norm(row[3:6] - row[0:3]) / 2
    c, s = row[6], row[7]
    return np.array([c * mid[0] + s * mid[2], mid[1], -s * mid[0] + c * mid[2]]) + row[8:11], half


def _anchors(t):
    """(center, size) of each medium, kind 2's from its first boundary row."""
    out = []
    for m, kind in enumerate(t.med_kinds):
        if kind == 0:
            out.append((t.med_center[m].double().numpy(), abs(float(t.med_radius[m]))))
        elif kind == 1:
            out.append(_box_anchor(np.concatenate([x[m].double().numpy().reshape(-1) for x in (
                t.med_min, t.med_max, t.med_cos, t.med_sin, t.med_off)])))
        elif m in t.gb_sph_meds:
            row = t.gb_sph[t.gb_sph_meds.index(m)].double().numpy()
            out.append((row[0:3], abs(row[6])))
        elif m in t.gb_quad_meds:
            row = t.gb_quad[t.gb_quad_meds.index(m)].double().numpy()
            out.append((row[0:3] + (row[3:6] + row[6:9]) / 2,
                        np.linalg.norm(row[3:6] + row[6:9]) / 2))
        else:
            out.append(_box_anchor(t.gb_box[t.gb_box_meds.index(m)].double().numpy()))
    return out


def _unit(rng, n):
    w = rng.normal(size=(n, 3))
    return w / np.linalg.norm(w, axis=1, keepdims=True)


def _inputs(t, seed):
    """Rays, shutter times, uniforms and a surface record around the media:
    six lane classes by lane index mod 6 (module docstring)."""
    rng = np.random.default_rng(seed)
    anchors = _anchors(t)
    m = rng.integers(0, len(anchors), R)
    P = np.stack([anchors[k][0] for k in m])
    S = np.array([anchors[k][1] for k in m])[:, None]
    w, a = _unit(rng, R), _unit(rng, R)
    cls = np.arange(R) % 6
    scale = rng.uniform(0.3, 3.0, (R, 1))
    o = P + w * S * rng.uniform(1.5, 6.0, (R, 1))  # cross: from outside, through the middle
    d = (P + 0.5 * S * a * rng.random((R, 1)) - o) * scale / S
    inside = cls == 1
    o[inside] = (P + 0.5 * S * a * rng.random((R, 1)))[inside]
    d[inside] = _unit(rng, R)[inside] * scale[inside]
    # graze: along a tangent through a point of the anchor's sphere
    tang = np.cross(w, a)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    graze = cls == 2
    o[graze] = (P + S * w - tang * S * rng.uniform(1.0, 4.0, (R, 1)))[graze]
    d[graze] = tang[graze]
    # miss: away from the medium (its interval behind the origin), or past it
    miss = cls == 3
    d[miss] = np.where(rng.random((R, 1)) < 0.5, w, tang)[miss] * scale[miss]
    o[miss] = (P + 3.0 * S * w)[miss]
    # parallel to a slab: one component exactly 0 or below 1e-12 (of either
    # sign), from inside or outside
    par = cls == 4
    axis = rng.integers(0, 3, R)
    tiny = rng.choice([0.0, -0.0, 1e-13, -1e-13, 1e-30], R)
    d[par, axis[par]] = tiny[par]
    # no direction at all, or one far from unit length
    odd = cls == 5
    d[odd] = np.where(rng.random((R, 1)) < 0.3, 0.0, d * rng.choice([1e-3, 1e3], (R, 1)))[odd]
    o, d = o.astype(F), d.astype(F)
    tm = rng.random(R, dtype=F)
    u = rng.random((len(anchors), R), dtype=F)
    for k in range(len(anchors)):
        pick = (np.arange(R) + 2 * k) % 9
        for j, value in enumerate((0.0, 1e-6, 1.0 - 2.0 ** -24, 1e-7)):
            u[k, pick == j] = value
    # the surface hit before, inside or beyond the lane's medium, or none
    dd = np.maximum((d.astype(np.float64) ** 2).sum(1), 1e-30)
    tp = ((P - o) * d).sum(1) / dd
    half = S[:, 0] / np.sqrt(dd)
    where = rng.integers(0, 4, R)
    t_s = np.select([where == 0, where == 1, where == 2],
                    [np.maximum(tp - 2 * half, 0.01), tp, tp + 2 * half + 1.0], BIG)
    t_s = np.where(np.isfinite(t_s) & (t_s > T_MIN), t_s, BIG).astype(F)
    surf = dict(hit=t_s < BIG, t=t_s, p=rng.uniform(-5, 5, (3, R)).astype(F),
                normal=np.ascontiguousarray(_unit(rng, R).T, dtype=F), u=rng.random(R, dtype=F),
                v=rng.random(R, dtype=F), mat=rng.integers(0, 6, R).astype(np.int32))
    return o.T.copy(), d.T.copy(), tm, u, surf


def _record(surf):
    T = torch.from_numpy
    return HitRecordP(hit=T(surf["hit"]), t=T(surf["t"]), p=tuple(map(T, surf["p"])),
                      normal=tuple(map(T, surf["normal"])), u=T(surf["u"]), v=T(surf["v"]),
                      mat=T(surf["mat"]))


def _log(x):
    return torch.log(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _clamp_min(x, lo):
    return np.where(np.isnan(x), x, np.maximum(x, F(lo)))


def _sphere(o, d, cx, cy, cz, r):
    ocx, ocy, ocz = o[0] - cx, o[1] - cy, o[2] - cz
    a = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    b = (ocx * d[0] + ocy * d[1]) + ocz * d[2]
    disc = b * b - a * (((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r)
    s = np.sqrt(_clamp_min(disc, 0.0))
    return (-b - s) / a, (-b + s) / a, disc > F(0)


def _slab(lo, ld, mn, mx):
    sd = np.where(np.abs(ld) < F(1e-12), np.where(ld >= F(0), F(1e-12), F(-1e-12)), ld)
    inv = F(1) / sd
    ta, tb = (mn - lo) * inv, (mx - lo) * inv
    return np.minimum(ta, tb), np.maximum(ta, tb)


def _box(o, d, b):
    c, s = b[6], b[7]
    px, py, pz = o[0] - b[8], o[1] - b[9], o[2] - b[10]
    t0x, t1x = _slab(c * px - s * pz, c * d[0] - s * d[2], b[0], b[3])
    t0y, t1y = _slab(py, d[1], b[1], b[4])
    t0z, t1z = _slab(s * px + c * pz, s * d[0] + c * d[2], b[2], b[5])
    return (np.maximum(np.maximum(t0x, t0y), t0z), np.minimum(np.minimum(t1x, t1y), t1z))


def _first_hit(tab, med, o, d, tm, t_lo):
    best, hit = np.full_like(o[0], F(BIG)), np.zeros(o[0].shape, bool)

    def consider(t, ok):
        nonlocal best, hit
        ok = ok & (t > t_lo) & (t < best)
        best, hit = np.where(ok, t, best), hit | ok

    s0, ns, q0, nq, b0, nb = (int(x) for x in med[3:9])
    for q in tab[s0:s0 + ns]:
        t1, t2, crosses = _sphere(o, d, q[0] + tm * q[3], q[1] + tm * q[4], q[2] + tm * q[5],
                                  q[6])
        consider(np.where(t1 > t_lo, t1, t2), crosses)
    for q in tab[q0:q0 + nq]:
        n0, n1, n2 = q[12:15]
        denom = (n0 * d[0] + n1 * d[1]) + n2 * d[2]
        ok = np.abs(denom) > F(1e-8)
        t = (q[15] - ((n0 * o[0] + n1 * o[1]) + n2 * o[2])) / np.where(ok, denom, F(1))
        plx, ply, plz = ((o[k] + t * d[k]) - q[k] for k in range(3))
        u0, u1, u2, v0, v1, v2, w0, w1, w2 = q[3:12]
        alpha = ((w0 * (ply * v2 - plz * v1) + w1 * (plz * v0 - plx * v2))
                 + w2 * (plx * v1 - ply * v0))
        beta = ((w0 * (u1 * plz - u2 * ply) + w1 * (u2 * plx - u0 * plz))
                + w2 * (u0 * ply - u1 * plx))
        consider(t, ok & (alpha >= F(0)) & (alpha <= F(1)) & (beta >= F(0)) & (beta <= F(1)))
    for q in tab[b0:b0 + nb]:
        entry, exit_ = _box(o, d, q)
        consider(np.where(entry > t_lo, entry, exit_), entry < exit_)
    return best, hit


def _kernel_order(tables, o, d, tm, t_min, surf, u):
    """csrc/media.cu in float32 numpy, medium by medium from ``med_rows``."""
    tab = tables.med_rows.numpy()
    with np.errstate(all="ignore"):
        ray_len = np.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
        len_ok = (ray_len > F(0)) & np.isfinite(ray_len)
        best, mat = surf["t"].copy(), surf["mat"].copy()
        in_medium = np.zeros(best.shape, bool)
        for m in range(tables.n_media):
            med = tab[m]
            kind = int(med[0])
            if kind == 0:
                entry, exit_, bnd_ok = _sphere(o, d, *med[3:7])
            elif kind == 1:
                entry, exit_ = _box(o, d, med[3:14])
                bnd_ok = entry < exit_
            else:
                entry, hit1 = _first_hit(tab, med, o, d, tm, np.full_like(tm, F(-BIG)))
                exit_, hit2 = _first_hit(tab, med, o, d, tm, entry + F(1e-4))
                bnd_ok = hit1 & hit2
            if kind != 2:
                bnd_ok = bnd_ok & ((exit_ - entry) > F(1e-4))
            rec1 = _clamp_min(entry, t_min)
            rec2 = np.minimum(exit_, best)
            ok = bnd_ok & (rec1 < rec2) & len_ok
            inside = (rec2 - rec1) * ray_len
            hit_distance = med[1] * _log(_clamp_min(u[m], 1e-6))
            t_m = rec1 + hit_distance / ray_len
            accept = ok & (hit_distance <= inside) & (t_m < best)
            best = np.where(accept, t_m, best)
            in_medium |= accept
            mat = np.where(accept, np.int32(med[2]), mat)
        zero, one = np.zeros_like(best), np.ones_like(best)
        p = [np.where(in_medium, o[k] + best * d[k], surf["p"][k]) for k in range(3)]
        normal = [np.where(in_medium, x, surf["normal"][k]) for k, x in enumerate((one, zero,
                                                                                 zero))]
    return [surf["hit"] | in_medium, best, *p, *normal,
            np.where(in_medium, zero, surf["u"]), np.where(in_medium, zero, surf["v"]), mat]


def _flat(rec):
    return [x.numpy() for x in (rec.hit, rec.t, *rec.p, *rec.normal, rec.u, rec.v, rec.mat)]


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", TABLES)
def test_kernel_order_is_the_twin(name):
    t = _tables(name)
    o, d, tm, u, surf = _inputs(t, seed=23 + TABLES.index(name))
    T = torch.from_numpy
    twin = _flat(apply_media_p_plain(t, tuple(map(T, o)), tuple(map(T, d)), T_MIN,
                                     _record(surf), T(u), time=T(tm)))
    model = _kernel_order(t, o, d, tm, T_MIN, surf, u)
    for k, (a, b) in enumerate(zip(model, twin)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"output {k}")
    scattered = twin[1] != surf["t"]
    assert 0.02 * R < scattered.sum() < R  # the media scatter some lanes, not all
    assert set(np.unique(twin[-1][scattered])) <= {int(x) for x in t.med_mat[:t.n_media]}


@pytest.mark.parametrize("how", ["cpu", "plain"])
def test_apply_media_p_takes_the_twin(how, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("K18 launched")

    monkeypatch.setattr(media_kernel, "apply_media", refuse)
    t = _tables("cornell_smoke")
    o, d, tm, u, surf = _inputs(t, seed=5)
    T = torch.from_numpy
    args = (t, tuple(map(T, o)), tuple(map(T, d)), T_MIN, _record(surf), T(u))
    before = dict(_build.launches)
    got = apply_media_p(*args, time=T(tm), plain=how == "plain")
    want = apply_media_p_plain(*args, time=T(tm))
    for a, b in zip(_flat(got), _flat(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert dict(_build.launches) == before


def test_no_media_gives_surf_back():
    t = _tables("cornell_smoke")
    o, d, tm, u, surf = _inputs(t, seed=6)
    bare = build_scene("three_spheres", 16, 16).tables
    assert bare.n_media == 0 and bare.med_rows.shape == (0, 16)
    rec = _record(surf)
    T = torch.from_numpy
    for plain in (False, True):
        assert apply_media_p(bare, tuple(map(T, o)), tuple(map(T, d)), T_MIN, rec, T(u[:0]),
                             time=T(tm), plain=plain) is rec


def test_med_rows_layout():
    t = _tables("every_kind")
    tab = t.med_rows.numpy()
    C = t.n_media
    assert t.med_kinds == (0, 2, 1, 2, 2, 2)
    assert tab.shape == (C + len(t.gb_sph_meds) + len(t.gb_quad_meds) + len(t.gb_box_meds), 16)
    for m, kind in enumerate(t.med_kinds):
        row = tab[m]
        assert (row[0], row[1], row[2]) == (kind, float(t.med_neg_inv_density[m]),
                                            int(t.med_mat[m]))
        if kind == 0:
            np.testing.assert_array_equal(row[3:7], [*t.med_center[m], t.med_radius[m]])
        elif kind == 1:
            np.testing.assert_array_equal(row[3:14], np.concatenate([
                t.med_min[m], t.med_max[m], [t.med_cos[m], t.med_sin[m]], t.med_off[m]]))
        else:
            for k, (rows, meds) in enumerate(((t.gb_sph, t.gb_sph_meds),
                                              (t.gb_quad, t.gb_quad_meds),
                                              (t.gb_box, t.gb_box_meds))):
                first, n = int(row[3 + 2 * k]), int(row[4 + 2 * k])
                own = rows.numpy()[[i for i, mi in enumerate(meds) if mi == m]]
                np.testing.assert_array_equal(tab[first:first + n, :own.shape[1]], own)


def test_wrapper_refuses_before_the_build(monkeypatch):
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "library", no_library)
    t = _tables("every_kind")
    o, d, tm, u, surf = _inputs(t, seed=8)
    T = torch.from_numpy
    rays = (tuple(map(T, o)), tuple(map(T, d)))
    apart = tuple(T(row.copy()) for row in u)  # six allocations
    with pytest.raises(ValueError, match="one row stride"):
        media_kernel.apply_media(t, *rays, T_MIN, _record(surf), apart, T(tm))
    bad = _record(surf)._replace(mat=T(surf["mat"].astype(np.int64)))
    with pytest.raises(ValueError, match="surf.mat"):
        media_kernel.apply_media(t, *rays, T_MIN, bad, T(u), T(tm))
    with pytest.raises(AssertionError, match="library"):  # every check passed
        media_kernel.apply_media(t, *rays, T_MIN, _record(surf), T(u), T(tm))
