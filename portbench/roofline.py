"""The least time the rays' work could take on one H100, whatever kernel or
route does it.

Each live ray's inputs are read once and its outputs written once, the
scene's tables once a call; the time is the larger of bytes over the
memory's peak and operations over the FP32 peak.  The counts come from the
rays (how many were live, how many were started) and from the reference
scene's table sizes, never from a kernel's loop (rows times rays, cells
tested): a culling route does less of that loop, and its share would pass
100%.  On this much arithmetic a ray needs, the bytes always bound it.

Peaks: NVIDIA H100 SXM data sheet (dense, without sparsity), at the full
power limit of 700 W; the run prints the card's limit beside them.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_FP32_PER_S = 67e12  # outside the tensor cores

F32 = 4
# a ray's path state: origin, direction, throughput, radiance (12 float32)
# and its shutter time
PATH_STATE = 13 * F32
# refill: each slot's live flag read; a started ray's state, bounce, pixel
# and live flag written
REFILL_SLOT_BYTES = 1
REFILL_RAY_BYTES = PATH_STATE + 2 * 4 + 1
REFILL_RAY_OPS = 30  # camera ray: jitter, lens, direction
# closest hit: origin, direction, time in; hit flag, t, point, normal,
# (u, v) and material out
INTERSECT_RAY_BYTES = 7 * F32 + 1 + 11 * F32
INTERSECT_RAY_OPS = 30  # one sphere test and the winner's attributes
# shade: direction, throughput, radiance, hit flag, point, normal and
# material in; origin, direction, throughput, radiance and live flag out
SHADE_RAY_BYTES = (9 * F32 + 1 + 7 * F32) + (12 * F32 + 1)
SHADE_RAY_OPS = 40
# table rows at their least: sphere (centre, velocity, radius, material),
# quad (corner, two edges, material), box (min, max, material), material
SPHERE_ROW, QUAD_ROW, BOX_ROW, MATERIAL_ROW = 32, 40, 28, 32


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)


def geometry_bytes(counts: dict) -> int:
    return (counts["spheres"] * SPHERE_ROW + counts["quads"] * QUAD_ROW
            + counts["boxes"] * BOX_ROW)


def refill_s(iterations: int, slots: int, started: int) -> float:
    return least_s(iterations * slots * REFILL_SLOT_BYTES + started * REFILL_RAY_BYTES,
                   started * REFILL_RAY_OPS)


def intersect_s(iterations: int, live: int, counts: dict) -> float:
    return least_s(live * INTERSECT_RAY_BYTES + iterations * geometry_bytes(counts),
                   live * INTERSECT_RAY_OPS)


def shade_s(iterations: int, live: int, counts: dict) -> float:
    return least_s(live * SHADE_RAY_BYTES + iterations * counts["materials"] * MATERIAL_ROW,
                   live * SHADE_RAY_OPS)
