"""Faults planted under the timed path, for the tests and readings that
show the comparison catches them (``portbench/control.py``,
``tests/test_portbench_faults.py``).  None is ever planted in a benchmark run.

* ``unchanged``: every dispatch returns its accumulator as it was (zero);
* ``half``: every dispatch renders half its samples and doubles the sum,
  the mean taken over the rest;
* ``altered``: every dispatch's radiance is halved where it is produced.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("unchanged", "half", "altered")


def _broken_dispatch(orig, fault: str):
    def render_wavefront(tables, cam, pix_offset, spp, *args, **kwargs):
        if fault == "half":
            half = max(1, spp // 2)
            fb, rays, iters = orig(tables, cam, pix_offset, half, *args, **kwargs)
            return fb * (spp / half), rays, iters
        fb, rays, iters = orig(tables, cam, pix_offset, spp, *args, **kwargs)
        if fault == "unchanged":
            return torch.zeros_like(fb), rays, iters
        return fb * 0.5, rays, iters

    return render_wavefront


@contextlib.contextmanager
def planted(fault: str | None):
    if fault is None:
        yield
        return
    if fault not in NAMES:
        raise ValueError(f"unknown fault {fault!r}; there are {NAMES}")
    from art_tpu_torch.render import integrator

    orig = integrator.render_wavefront
    integrator.render_wavefront = _broken_dispatch(orig, fault)
    try:
        yield
    finally:
        integrator.render_wavefront = orig
