"""Thin-lens + motion-blur camera (port of ``art_tpu/core/camera.py``).

The camera frame is built on the host in numpy float32 with the JAX
package's operation order, so ``make_camera`` gives the same 21 floats as
``art_tpu``'s (reference src/camera.cuh:59-78).  ``pack_camera`` is the
21-float layout of ``art_tpu/ops/refill_kernel.py:pack_camera`` that the
refill kernel reads.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from art_tpu_torch.core.vecmath import sqrt

TWO_PI = 2.0 * math.pi  # rounds to float32 6.2831855 against f32 tensors


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame; vectors are (3,) float32, scalars float32."""

    origin: np.ndarray
    lower_left_corner: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    lens_radius: np.float32
    time0: np.float32
    time1: np.float32


def _unit(a: np.ndarray) -> np.ndarray:
    return a / np.sqrt(np.sum(a * a))


def make_camera(lookfrom, lookat, vup, vfov_degrees: float, aspect: float,
                aperture: float = 0.0, focus_dist: float | None = None,
                time0: float = 0.0, time1: float = 0.0) -> Camera:
    """Build the camera basis exactly as the reference init (src/camera.cuh:59-78)."""
    lookfrom = np.asarray(lookfrom, np.float32)
    lookat = np.asarray(lookat, np.float32)
    vup = np.asarray(vup, np.float32)
    if focus_dist is None:
        focus_dist = float(np.linalg.norm(lookfrom - lookat))

    theta = vfov_degrees * math.pi / 180.0
    half_height = math.tan(theta * 0.5)
    half_width = aspect * half_height

    origin = lookfrom
    w = _unit(lookfrom - lookat)
    u = _unit(np.cross(vup, w))
    v = np.cross(w, u)
    lower_left_corner = (
        origin
        - half_width * focus_dist * u
        - half_height * focus_dist * v
        - focus_dist * w
    )
    return Camera(
        origin=origin,
        lower_left_corner=lower_left_corner,
        horizontal=2.0 * half_width * focus_dist * u,
        vertical=2.0 * half_height * focus_dist * v,
        u=u,
        v=v,
        w=w,
        lens_radius=np.float32(aperture * 0.5),
        time0=np.float32(time0),
        time1=np.float32(time1),
    )


def pack_camera(cam: Camera) -> np.ndarray:
    """(21,) f32: origin, llc, horizontal, vertical, u, v, lens_r, t0, t1."""
    return np.concatenate([
        cam.origin, cam.lower_left_corner, cam.horizontal, cam.vertical,
        cam.u, cam.v, np.asarray([cam.lens_radius, cam.time0, cam.time1]),
    ]).astype(np.float32)


def rays_from_uniforms_p(cam: Camera, s, t, u_lens0, u_lens1, u_time):
    """Batched get_ray (reference src/camera.cuh:35-47), component-planar.

    ``s``/``t`` are (R,) viewport coordinates (already jittered).  Returns
    (o 3-tuple, d 3-tuple, times); directions are not normalized."""
    r = float(cam.lens_radius) * sqrt(u_lens0)
    phi = TWO_PI * u_lens1
    rdx = r * torch.cos(phi)
    rdy = r * torch.sin(phi)
    times = float(cam.time0) + u_time * float(cam.time1 - cam.time0)
    o = tuple(
        float(cam.origin[c]) + rdx * float(cam.u[c]) + rdy * float(cam.v[c])
        for c in range(3)
    )
    d = tuple(
        float(cam.lower_left_corner[c]) + s * float(cam.horizontal[c])
        + t * float(cam.vertical[c]) - o[c]
        for c in range(3)
    )
    return o, d, times
