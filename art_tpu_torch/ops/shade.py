"""Masked material shading, component-planar (``art_tpu/ops/shade.py``).

Every material family is evaluated for the whole batch and blended by type
tag (reference src/material.cuh:46-201); rejection loops are analytic
equal-distribution samplers fed by raw uniform planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from art_tpu_torch.core.camera import TWO_PI
from art_tpu_torch.core.vecmath import (
    p_dot,
    p_length,
    p_mul,
    p_reflect,
    p_refract,
    p_unit,
    p_where,
    schlick,
    sqrt,
)
from art_tpu_torch.ops.gather import take_rows
from art_tpu_torch.ops.intersect import HitRecordP, background_color_p
from art_tpu_torch.ops.texture_eval import eval_texture_p
from art_tpu_torch.scene.tables import MatType, SceneTables


class ScatterResultP(NamedTuple):
    emitted: tuple  # 3 x (R,) emission at the hit
    attenuation: tuple  # 3 x (R,)
    direction: tuple  # 3 x (R,) new direction (unnormalized, as the reference)
    scattered: torch.Tensor  # (R,) bool; False = absorbed


def cbrt(u: torch.Tensor) -> torch.Tensor:
    """Cube root, correctly rounded to float32 (but for about 1 input in
    10^8).  PyTorch has no cbrt, and ``u ** (1/3)`` in float32 is off by an
    ulp on ~12% of inputs, so the root is taken in float64 and rounded once;
    the shade kernel rounds CUDA's float64 ``cbrt`` the same way, so kernel
    and twin agree bit for bit.  (art_tpu's ``jnp.cbrt`` is itself an ulp
    off on ~12% of inputs, its TPU kernel uses ``exp(log(u)/3)``.)"""
    return torch.pow(u.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def _ball_from_uniforms_p(u0, u1, u2):
    """Uniform-in-ball sample from three U[0,1) planes (core.rng)."""
    z = 2.0 * u0 - 1.0
    phi = TWO_PI * u1
    s = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    r = cbrt(u2)
    return (r * s * torch.cos(phi), r * s * torch.sin(phi), r * z)


def shade_params_p(tables: SceneTables, rec: HitRecordP, valid=None, *,
                   plain: bool = False):
    """Per-ray material/texture parameters for the shade kernel: one packed
    material row fetch (``[type, tex, fuzz, ref_idx, r, g, b, _]``) plus one
    texture evaluation (``plain`` takes the turbulence twin on any device).
    Returns (mtype f32, fuzz, ref_idx, metal_albedo 3-tuple, tex_val
    3-tuple)."""
    # (8, R): every parameter plane comes out contiguous for the kernel
    mrow = take_rows(tables.mat_packed, rec.mat).T.contiguous()
    tex_id = mrow[1].to(torch.int32)
    tex_val = eval_texture_p(tables, tex_id, rec.u, rec.v, rec.p, valid=valid,
                             plain=plain)
    return mrow[0], mrow[2], mrow[3], (mrow[4], mrow[5], mrow[6]), tex_val


def shade_p(d, n, params, u_ball, u_choice) -> ScatterResultP:
    """Emission + scatter for every ray from its normal ``n`` and its
    ``shade_params_p`` planes ``params``.

    This is the one plain form of the material math: the operation order is
    the one ``csrc/shade_flush.cu`` rounds, so kernel and twin agree bit for
    bit (a divisor is a tensor, never a Python scalar: ATen on CUDA turns
    ``x / scalar`` into ``x * (1 / scalar)``)."""
    mtype_f, fuzz, ref_idx, metal_albedo, tex_val = params
    mtype = mtype_f.to(torch.int32)
    is_metal = mtype == MatType.METAL
    is_dielectric = mtype == MatType.DIELECTRIC
    is_light = mtype == MatType.DIFFUSE_LIGHT
    is_isotropic = mtype == MatType.ISOTROPIC

    zero = torch.zeros_like(u_choice)
    emitted = p_where(is_light, tex_val, (zero, zero, zero))
    ball = _ball_from_uniforms_p(*u_ball)
    lambert_dir = (n[0] + ball[0], n[1] + ball[1], n[2] + ball[2])

    metal_refl = p_reflect(p_unit(d), n)
    metal_dir = tuple(metal_refl[c] + fuzz * ball[c] for c in range(3))
    metal_alive = p_dot(metal_dir, n) > 0.0

    d_dot_n = p_dot(d, n)
    inside = d_dot_n > 0.0
    outward_n = p_where(inside, (-n[0], -n[1], -n[2]), n)
    ni_over_nt = torch.where(inside, ref_idx, 1.0 / ref_idx)
    cos_raw = d_dot_n / p_length(d)
    cos_inside = sqrt(torch.clamp_min(
        1.0 - ref_idx * ref_idx * (1.0 - cos_raw * cos_raw), 0.0))
    cosine = torch.where(inside, cos_inside, -cos_raw)
    can_refract, refracted = p_refract(d, outward_n, ni_over_nt)
    reflect_prob = torch.where(can_refract, schlick(cosine, ref_idx),
                               torch.ones_like(cosine))
    diel_dir = p_where(u_choice < reflect_prob, p_reflect(d, n), refracted)

    direction = p_where(is_metal, metal_dir, lambert_dir)
    direction = p_where(is_dielectric, diel_dir, direction)
    direction = p_where(is_isotropic, ball, direction)
    attenuation = p_where(is_metal, metal_albedo, tex_val)
    one = torch.ones_like(u_choice)
    attenuation = p_where(is_dielectric, (one, one, one), attenuation)
    scattered = ~is_light & (~is_metal | metal_alive)
    return ScatterResultP(emitted, attenuation, direction, scattered)


def bounce_p(o, d, throughput, radiance, active, hit, p, n, params, u_ball, u_choice,
             background, gradient_bg: bool):
    """One bounce after the intersection (``art_tpu`` ``_bounce_step`` less
    its intersection): background radiance for live misses, emission and
    scatter for live hits, and the throughput / origin / direction update.

    Returns (new_o, new_d, new_throughput, new_radiance, survived)."""
    bg = background_color_p(d, background, gradient_bg)
    miss = active & ~hit
    zero = torch.zeros_like(u_choice)
    radiance = tuple(radiance[c] + torch.where(miss, throughput[c] * bg[c], zero)
                     for c in range(3))
    live_hit = active & hit
    sc = shade_p(d, n, params, u_ball, u_choice)
    radiance = tuple(radiance[c] + torch.where(live_hit, throughput[c] * sc.emitted[c],
                                               zero) for c in range(3))
    survived = live_hit & sc.scattered
    throughput = p_where(survived, p_mul(throughput, sc.attenuation), throughput)
    o = p_where(survived, p, o)
    d = p_where(survived, sc.direction, d)
    return o, d, throughput, radiance, survived
