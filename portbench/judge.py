"""The comparison that decides ``correct``.

The program renders by Monte Carlo from its own Philox streams, laid out by
pool slot and iteration, so no independent code can replay its samples one
by one.  What it must get right is the estimate: each pixel's radiance sum
over its samples is an unbiased estimate of the pixel's radiance, with the
variance of that many samples.  So after the window the harness draws
``pixels`` pixels from the seed among those the window rendered, the plain
reference (``portbench/reference/``) traces ``ref_spp`` paths from each with
its own random numbers, and three numbers are compared, over the pixels and
their three channels, with d the program's mean less the reference's and v
the variance of d that the reference's per-sample variance predicts,
``s_r^2 (1 / n_program + 1 / ref_spp)``:

* ``var_ratio`` = sum d^2 / sum v: near 1 for a sound estimate; a bias, a
  lost block of pixels or fewer samples than counted (half of them, the sum
  doubled) raise it;
* ``bias_z`` = |sum_p e_p| / sqrt(sum_p w_p), with e_p the pixel's d summed
  over its channels and w_p the variance of that sum (the channels of a path
  are correlated, so it is taken from each path's channel sum): a standard
  normal's magnitude for a sound estimate; a bias of one sign over the image
  raises it;
* ``z2_clipped`` = the mean over pixel-channels of min(d^2 / v, ``CLIP``)
  (those the reference saw lit; a lit one where the reference saw none
  counts as ``CLIP``): near 1 (a chi-square's mean so clipped, 0.995) for a
  sound estimate.  The clip keeps out the few pixels whose rare bright paths
  dominate the sums, and the mean takes no lattice values as a median of
  few distinct sample values does, so it sees fewer samples than counted
  (half of them, the sum doubled) where ``var_ratio`` swings too widely to.
  The reference's own noise is part of d, so ``ref_spp`` is kept well
  above the program's samples a pixel, where halving shows most.

The control (``portbench/control.py``) puts the reference in the program's
place in bfloat16, the precision below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.tracer import Tracer

BATCH = 1 << 19  # paths a batch
CLIP = 9.0  # z2_clipped's clip: three standard deviations


def sample_pixels(counts: np.ndarray, n: int, seed: int) -> np.ndarray:
    covered = np.flatnonzero(counts)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    return np.sort(rng.choice(covered, size=min(n, covered.size), replace=False))


def reference_scene(cell, size: dict):
    return cell.config_module().build(cell.config, cell.root, size["nx"], size["ny"])


def trace_pixels(scene, pix: np.ndarray, n: int, seed: int, dev, dtype=torch.float32):
    """(mean, unbiased variance) a sample of ``n`` paths from each pixel of
    ``pix``: (len(pix), 4) float64, the three channels and their sum."""
    tracer = Tracer(scene, dev, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed * 2654435761 + 97) & 0x7FFFFFFFFFFFFFFF)
    pt = torch.as_tensor(pix, device=dev)
    order = pt.repeat(n)
    slot = torch.arange(pix.size, device=dev).repeat(n)
    s1 = torch.zeros((pix.size, 4), dtype=torch.float64, device=dev)
    s2 = torch.zeros_like(s1)
    for lo in range(0, order.numel(), BATCH):
        r = tracer.radiance(order[lo:lo + BATCH], gen).double()
        r = torch.cat([r, r.sum(1, keepdim=True)], 1)
        s1.index_add_(0, slot[lo:lo + BATCH], r)
        s2.index_add_(0, slot[lo:lo + BATCH], r * r)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0) * (n / max(n - 1, 1))
    return mean.cpu().numpy(), var.cpu().numpy()


def compare(m_p: np.ndarray, n_p: np.ndarray, m_r: np.ndarray, v_r: np.ndarray,
            n_r: int) -> dict:
    """``var_ratio``, ``bias_z`` and ``z2_clipped`` of the program's means ``m_p`` ((k, 3),
    from ``n_p`` samples a pixel) against the reference's ``trace_pixels``."""
    d = m_p - m_r[:, :3]
    v = v_r * (1.0 / np.asarray(n_p, np.float64)[:, None] + 1.0 / n_r)

    def ratio(num, den):
        return num / den if den > 0.0 else (0.0 if num == 0.0 else math.inf)

    vc = v[:, :3]
    lit = (vc > 0.0) | (d != 0.0)
    z2 = np.where(vc > 0.0, d * d / np.where(vc > 0.0, vc, 1.0), math.inf)[lit]
    return dict(var_ratio=ratio(float((d * d).sum()), float(vc.sum())),
                bias_z=math.sqrt(ratio(float(d.sum()) ** 2, float(v[:, 3].sum()))),
                z2_clipped=float(np.minimum(z2, CLIP).mean()) if z2.size else 0.0)


def judge(cell, size: dict, sums: np.ndarray, counts: np.ndarray, seed: int, dev) -> dict:
    """The readings of the window's estimate against the reference."""
    js = cell.settings["judge"]
    pix = sample_pixels(counts, js["pixels"], seed)
    m_r, v_r = trace_pixels(reference_scene(cell, size), pix, js["ref_spp"], seed, dev)
    n_p = counts[pix]
    return compare(sums[pix] / n_p[:, None], n_p, m_r, v_r, js["ref_spp"])


def verdict(readings: dict, limits: dict) -> bool:
    return all(math.isfinite(readings[k]) and readings[k] <= limits[k] for k in limits)
