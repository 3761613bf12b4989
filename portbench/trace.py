"""The traced run's instruments: stage spans around the program's module
attributes, a device profiler over a bounded stretch of the window, the
reduction of its trace to busy time, per-span host and device time and idle
gaps, and a launch count from a CUDA graph capture of one iteration.

Spans are named ``module:attribute``.  A span whose attribute no longer
exists is left out (its metrics go absent) for a later benchmark change to
re-point.  The stretch is counted in calls of the refill (one an iteration):
it starts at ``start`` and ends ``iters`` calls later, or where the dispatch
ends, so that it stays within one dispatch's queue.

The profiler records device activity only: recording every host operator
slowed the host loop about threefold, and the stretch would measure that.
A span's host time is the host clock inside it.  Its device time comes from
markers: the span enqueues an empty kernel (``torch.cuda._sleep(0)``, named
``spin_kernel``) where it starts and where it ends, and on the one stream the
device runs work in the order it was enqueued, so every device operation
between a span's two markers is that span's.  The port's kernels are
launched through ``ctypes``, where the profiler links no host call to them,
so no host-side attribution would find them.  The markers cost two empty
launches a span, and a stretch whose markers do not all come back
attributes nothing.
"""

from __future__ import annotations

import bisect
import collections
import ctypes
import importlib
import sys
import time

import torch

REFILL = "art_tpu_torch.ops.refill_kernel:fused_refill"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def resolve(spec: str):
    mod_name, attr = spec.split(":")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None, attr
    return (mod, attr) if hasattr(mod, attr) else (None, attr)


class Stretch:
    """Span wrappers and the profiler over iterations ``[start, start +
    iters)`` of the window."""

    def __init__(self, spans, start: int, iters: int):
        self.spans = sorted(set(spans))
        self.start, self.iters = start, iters
        self.calls = 0
        self.prof = None
        self.done = False
        self.profiled = []  # (hist, it) of each profiled iteration
        self.q_first = self.q_last = None
        self.head = None
        self.wall_s = 0.0
        self.missing = []
        self.marks = []  # (span, +1 start / -1 end), in the order enqueued
        self.host = collections.Counter()
        self._patched = []
        self._t0 = 0.0
        self._marker = torch.cuda.is_available()

    # -- installing ---------------------------------------------------------
    def install(self) -> None:
        """Wrap the span attributes, and start and stop the profiler once: its
        first start in a process loads CUPTI (~9 s on the H100's machine),
        which belongs in set-up, not in the window."""
        if self._marker:
            warm = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            warm.start()
            torch.cuda._sleep(0)
            _sync()
            warm.stop()
        for spec in sorted(set(self.spans) | {REFILL}):
            mod, attr = resolve(spec)
            if mod is None:
                self.missing.append(spec)
                continue
            fn = getattr(mod, attr)
            setattr(mod, attr, self._wrap(spec, fn))
            self._patched.append((mod, attr, fn))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._patched):
            setattr(mod, attr, fn)
        self._patched = []

    def _wrap(self, spec, fn):
        refill = spec == REFILL
        named = spec in self.spans

        def wrapped(*args, **kwargs):
            if refill:
                self._tick(*args[:6])
            if self.prof is None or self.done or not named:
                return fn(*args, **kwargs)
            self._mark(spec, 1)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.host[spec] += time.perf_counter() - t0
                self._mark(spec, -1)

        return wrapped

    def _mark(self, spec: str, side: int) -> None:
        if self._marker:
            self.marks.append((spec, side))
            torch.cuda._sleep(0)

    # -- the stretch ----------------------------------------------------------
    def _tick(self, pool, cam, q, parity, hist, it) -> None:
        if self.done:
            return
        if self.prof is not None and (self.calls >= self.start + self.iters
                                      or q is not self.q_last[0]):
            self.stop()
            return
        if self.prof is None and self.calls >= self.start:
            self.q_first = (q.clone(), parity)
            _sync()
            acts = [torch.profiler.ProfilerActivity.CUDA if self._marker
                    else torch.profiler.ProfilerActivity.CPU]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._t0 = time.perf_counter()
        if self.prof is not None:
            self.profiled.append((hist, it))
            self.q_last = (q, parity)
        self.calls += 1

    def stop(self) -> None:
        """End the stretch (the window calls it too, once it has closed)."""
        if self.prof is None or self.done:
            return
        _sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        q, parity = self.q_last
        # the queue head after the last profiled refill, less the one before
        # the first: the rays the stretch started
        self.head = (int(q[1 - parity]) - int(self.q_first[0][self.q_first[1]]))
        self.done = True

    # -- reading --------------------------------------------------------------
    def summary(self, top: int = 10) -> dict | None:
        """The stretch's numbers: iterations, wall and busy seconds, live rays
        and started rays, per-span host and device seconds, the device
        operations that took most time and the idle gaps by the span whose
        operation ended them.  None where no stretch ran."""
        if not self.done:
            return None
        from torch.autograd import DeviceType

        dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in self.prof.events()
                     if e.device_type == DeviceType.CUDA and e.name not in self.spans)
        markers = [e for e in dev if "spin_kernel" in e[2]]
        work = [e for e in dev if "spin_kernel" not in e[2]]
        merged = []
        for s, e, _ in work:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        by_op = collections.Counter()
        for s, e, name in work:
            by_op[name] += (e - s) * 1e-6
        device, owner = collections.Counter(), {}
        if len(markers) == len(self.marks):
            stack, marks = [], iter(self.marks)
            for s, e, name in dev:
                if "spin_kernel" in name:
                    spec, side = next(marks)
                    if side > 0:
                        stack.append(spec)
                    elif stack:
                        stack.pop()
                elif stack:
                    device[stack[-1]] += (e - s) * 1e-6
                    owner[s] = stack[-1]
        else:
            print(f"portbench: {len(markers)} of {len(self.marks)} span markers came back; "
                  "no device time by span", file=sys.stderr)
        gaps = collections.Counter()
        starts = [w[0] for w in work]
        for (_, end), (start, _) in zip(merged, merged[1:]):
            k = bisect.bisect_left(starts, start)
            gaps[owner.get(starts[k], "loop") if k < len(starts) else "loop"] += \
                (start - end) * 1e-6
        live = sum(int(h[it]) for h, it in self.profiled)
        return dict(iterations=len(self.profiled), wall_s=self.wall_s,
                    busy_s=sum(e - s for s, e in merged) * 1e-6, live=live,
                    started=self.head, host_s=dict(self.host), device_s=dict(device),
                    device_ops=[[k, v] for k, v in by_op.most_common(top)],
                    idle_gaps=[[k, v] for k, v in gaps.most_common(top)],
                    missing=list(self.missing))


# CUgraphNodeType: the nodes that are device work, one launch each
GRAPH_WORK_NODES = {0: None, 1: "memcpy", 2: "memset"}


def captured_launches(fn) -> dict:
    """{device kernel name: launches} of one call of ``fn`` after a warm-up
    call, from a CUDA graph capture of the call: its kernel, memcpy and
    memset nodes (a copy of the method of the repository's ``chip_smoke.py``
    ``_captured_names``; a profiler window loses launches late in a long
    process).  The capture runs none of them.  Raises where the call cannot
    be captured, e.g. on a host synchronisation inside it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    names = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value not in GRAPH_WORK_NODES:
            continue
        label = GRAPH_WORK_NODES[kind.value]
        if label is None:
            params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2: func first
            name = ctypes.c_char_p()
            if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) != 0
                    or cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p.from_buffer(
                        params).value) != 0):
                raise RuntimeError("a kernel node's function name was not readable")
            label = name.value.decode()[:80]
        names[label] += 1
    graph.reset()
    return dict(names)


def step_launches(step, pool_args, kwargs) -> float | None:
    """Device launches of one staged iteration, or None (with the reason on
    standard error) where the capture fails."""
    try:
        return float(sum(captured_launches(lambda: step(*pool_args, **kwargs)).values()))
    except (RuntimeError, OSError, AttributeError) as exc:
        print(f"portbench: launches_per_iter left out: capture failed: {exc!r}", file=sys.stderr)
        return None
