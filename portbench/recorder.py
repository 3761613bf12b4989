"""What the per-layer metrics read from the program's own recorder
(``art_tpu_torch/utils/tracing.py``): self time and host reads by layer,
kernel, memcpy and memset nodes by layer from the set-up's graph capture,
and the set-up spans.

The window's dispatches are the recorder's last ``ctx.window.attempted``
dispatch records; a reader uses them only where their iterations add up to
``ctx.window.iterations``.  The self times and host reads leave out the
dispatches that ran partly under ``torch.profiler`` (``Record.profiled``):
those of the traced run's profiled stretch, as a rule the first of the
window's ten or more.  The stretch's own work lands inside the program's
spans (the profiler's start and stop in the ``refill`` span, where the
harness's wrapper of ``fused_refill`` runs them) and the profiler and the
span markers slow its iterations, so its dispatches would read the
harness's cost.  The readers divide by the iterations of the dispatches
they keep.  Against a
program that has no recorder every reader returns None, and the metric is
left out of the line.
"""

from __future__ import annotations

import sys


def _tracing():
    try:
        from art_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def window_records(ctx) -> list | None:
    """The window's dispatch records, or None."""
    tr = _tracing()
    n = ctx.window.attempted
    if tr is None or not n:
        return None
    recs = tr.records()[-n:]
    held = sum(r.iterations for r in recs)
    if len(recs) != n or held != ctx.window.iterations:
        print(f"portbench: the recorder's last {len(recs)} dispatch records hold {held} "
              f"iterations, the window {ctx.window.iterations}; no recorder metric",
              file=sys.stderr)
        return None
    return recs


def self_ms(ctx, *layers: str) -> float | None:
    """Self milliseconds an iteration in ``layers`` over the window's
    dispatches that ran with no profiler, or None where none did or none of
    them holds any of the layers."""
    recs = [r for r in window_records(ctx) or () if not r.profiled]
    iters = sum(r.iterations for r in recs)
    times = [r.self_times() for r in recs]
    if not iters or not any(k in t for t in times for k in layers):
        return None
    return 1e-6 * sum(t.get(k, 0) for t in times for k in layers) / iters


def launches(ctx, layer: str) -> float | None:
    """The graph nodes of ``layer`` in the set-up's capture of one staged
    iteration (``launches_per_iter``'s), where the layers' counts add up to
    that capture's."""
    tr = _tracing()
    got = tr.last_capture() if tr is not None else None
    if got is None or ctx.window.launches is None:
        return None
    if sum(got.values()) != ctx.window.launches:
        print(f"portbench: the recorder's capture counts {sum(got.values())} launches, "
              f"launches_per_iter {ctx.window.launches}; no launches by layer", file=sys.stderr)
        return None
    return float(got.get(layer, 0))


def setup_s(layer: str) -> float | None:
    """Seconds of the set-up layer ``layer`` in this process, or None."""
    tr = _tracing()
    return tr.setup_seconds().get(layer) if tr is not None else None
