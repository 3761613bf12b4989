"""Component-planar 3-vector helpers over 3-tuples of ``(R,)`` tensors.

Port of the planar half of ``art_tpu/core/vecmath.py``.  The operation
order of every helper is the reference's, so float32 results agree with
the JAX package bit for bit wherever both round the same primitive ops.
"""

from __future__ import annotations

import numpy as np
import torch

# Large finite stand-in for FLT_MAX and the reference t_min (src/main.cu:57),
# as the exact float32 values art_tpu uses.
BIG = float(np.float32(1e30))
T_MIN = float(np.float32(1e-3))
# quad parallel-plane epsilon (src/quad.cuh:64) and slab-division guard
# (art_tpu/ops/intersect.py:45-46)
PARALLEL_EPS = 1e-8
DIR_EPS = 1e-12


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's vectorized CPU sqrt is one ulp off on ~0.6% of float32 inputs,
    while CUDA's sqrtf (the kernels'), XLA's and numpy's are correctly
    rounded; a float64 sqrt rounded once to float32 is correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device, to divide by: ATen on
    CUDA turns ``x / python_scalar`` (and ``x / cpu_scalar_tensor``) into
    ``x * (1 / scalar)``, which rounds differently from ``art_tpu``'s
    division."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def p_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def p_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def p_mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def p_scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def p_where(mask, a, b):
    return tuple(torch.where(mask, a[c], b[c]) for c in range(3))


def p_length(a):
    return sqrt(p_dot(a, a))


def p_unit(a):
    inv = 1.0 / p_length(a)
    return p_scale(a, inv)


def p_reflect(v, n):
    return p_sub(v, p_scale(n, 2.0 * p_dot(v, n)))


def p_refract(v, n, ni_over_nt):
    """Book-1 Snell refraction; returns (ok, refracted 3-tuple)."""
    uv = p_unit(v)
    dt = p_dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    root = sqrt(torch.clamp_min(disc, 0.0))
    refracted = p_sub(p_scale(p_sub(uv, p_scale(n, dt)), ni_over_nt), p_scale(n, root))
    return ok, refracted


def schlick(cosine, ref_idx):
    """Schlick reflectance (reference src/material.cuh:38-43), (1-c)^5 by
    multiplies as in art_tpu."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def p_ray_at(o, d, t):
    return (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])


def p_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def p_rotate_y(p, cos_t, sin_t):
    """world = R(theta) * local (reference src/main.cu:491-496)."""
    return (cos_t * p[0] + sin_t * p[2], p[1], -sin_t * p[0] + cos_t * p[2])


def p_rotate_y_inv(p, cos_t, sin_t):
    """local = R(-theta) * world (reference src/hittable.cuh:118-127)."""
    return (cos_t * p[0] - sin_t * p[2], p[1], sin_t * p[0] + cos_t * p[2])


def safe_dir(d: torch.Tensor) -> torch.Tensor:
    """Direction components clamped away from zero for the slab division
    (``art_tpu/ops/intersect.py:_safe_dir``): an exactly parallel ray can
    neither enter nor leave through that slab axis."""
    sign = torch.where(d >= 0.0, 1.0, -1.0)
    return torch.where(d.abs() < DIR_EPS, sign * DIR_EPS, d)
