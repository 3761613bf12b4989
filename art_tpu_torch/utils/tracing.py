"""The program's one recorder of spans and counters (PERF.md §3).

A span is a layer of the program timed on the host: ``begin(REFILL)`` ...
``end()`` on the hot path, where ``REFILL = layer("refill")`` (two calls cost
less than a ``with`` block; ``switch(INTERSECT)`` closes one stage and opens
the next at one clock read), ``with span("library"):`` elsewhere.  Spans
nest; a layer's self time is its spans' durations less the parts their child
spans cover, and the recorder keeps it by charging the time since the last
span boundary to the innermost open layer at each boundary.  Layers are
named for what the code does, not for a function, so that a fusion or a
rename keeps its metric:

==============  ============================================================
``dispatch``    one ``render_wavefront`` call, the parent of the layers below
``loop``        one iteration of the pool, less its stage spans
``refill``      K1 (K12 on the seam route)
``intersect``   ``closest_surface_p``: the closest hit, every primitive kind
``media``       ``apply_media_p``: the constant media
``textures``    ``eval_special_p``: the special leaves of baked materials
``shade``       ``shade_params_p`` and K3 (the bounce on the seam route)
``short_path``  K11, the whole iteration in one call
``sync``        a blocking host read of the loop (``begin_sync`` counts it)
``scene``       ``build_scene`` (set-up)
``tables``      ``SceneTables.to`` (set-up)
``library``     the kernels' library built or loaded (set-up)
``collective``  the all-reduce of ``sharded_render_step``
==============  ============================================================

Off (the default), the recorder keeps sums only, one ``Record`` a dispatch in
a bounded deque: self nanoseconds by layer, iterations and live segments, host
reads, and the port's kernel launches by (layer, kernel).  A span then costs
two clock reads, a list push and pop and one test of ``_watch``, the tuple of
what else sees each boundary (empty when off); the state lives in module
globals so that each costs one lookup.  On (``enable``, the variable
``ART_TPU_TRACE=<path>`` read once at import, or the CLI's ``--trace``), a
``Keeper`` in ``_watch`` also keeps every span: its layer, start and end
(``time.perf_counter_ns``), parent, dispatch ``(tile, chunk)`` and
iteration, and ``export`` writes them as a Chrome trace in the clock of
``torch.profiler``'s events (Unix-epoch nanoseconds), beside the device
events of a profiled stretch where there is one.

``KERNELS`` counts the port's kernel launches by wrapper name (``launch``);
``ops/_build.py`` exports it as ``launches``.  It cannot see ATen's launches:
those are counted where ``staged_step`` or ``seam_step`` runs under a CUDA
graph capture, as the graph nodes each span adds (``capturing``,
``last_capture``).  ``idle_by_span`` files the gaps between device intervals
under the host span that was open.
"""

from __future__ import annotations

import atexit
import bisect
import collections
import ctypes
import json
import os
import time

import torch

_clock = time.perf_counter_ns
MAX_RECORDS = 4096  # dispatch records kept
MAX_SPANS = 1 << 20  # spans kept when on; later ones are counted as dropped
MAX_LAYERS = 32

KERNELS: collections.Counter = collections.Counter()

NAMES: list = []  # layer id -> name
_IDS: dict = {}


def layer(name: str) -> int:
    """The id of the layer ``name`` (registered on first use)."""
    k = _IDS.get(name)
    if k is None:
        if len(NAMES) == MAX_LAYERS:
            raise ValueError(f"more than {MAX_LAYERS} layers")
        k = _IDS[name] = len(NAMES)
        NAMES.append(name)
    return k


NONE = layer("none")  # time under no span
DISPATCH, LOOP, SYNC = layer("dispatch"), layer("loop"), layer("sync")
SETUP_LAYERS = frozenset(map(layer, ("scene", "tables", "library")))
LOOP_LAYERS = (NONE, DISPATCH, LOOP)  # idle time and graph nodes under these: "loop"


class Record:
    """One dispatch's sums: ``dispatch`` is its ``(tile, chunk)`` (None for
    the time outside any dispatch), ``self_ns`` the self ns by layer id,
    ``launches`` the port's kernel launches by ``(layer id, kernel)``;
    ``profiled`` is set where some of it ran under ``torch.profiler``
    (checked where each iteration starts and where the dispatch ends), whose
    start, stop and slowing its self times then hold."""

    __slots__ = ("dispatch", "iterations", "segments", "self_ns", "syncs", "launches",
                 "profiled")

    def __init__(self, dispatch=None):
        self.dispatch = dispatch
        self.iterations = 0
        self.segments = 0
        self.self_ns = [0] * MAX_LAYERS
        self.syncs = 0
        self.launches: dict = {}
        self.profiled = False

    def self_times(self) -> dict:
        """{layer: self ns} of the layers that ran."""
        return {NAMES[k]: v for k, v in enumerate(self.self_ns) if v and k != NONE}

    def launches_by_layer(self) -> dict:
        """{layer: {kernel: launches}} of the port's own kernels."""
        out = {}
        for (k, name), n in self.launches.items():
            out.setdefault(NAMES[k], {})[name] = n
        return out


# The recorder's state, kept in module globals for the hot path's sake.
_outside = Record()
_rec = _outside  # the record spans are filed under
_self = _outside.self_ns
_launches = _outside.launches
_layer = NONE  # the innermost open span's layer
_t = _clock()  # the last span boundary
_open: list = []  # the enclosing layer of each open span
_watch: tuple = ()  # what else sees each boundary: the span keeper (on), a capture
_keeper = None  # when on, the ``Keeper``
_it = -1  # the iteration under way, -1 outside one
_hook = None  # called with the iteration where one starts
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_setup_ns: collections.Counter = collections.Counter()  # inclusive ns by set-up layer
_capture = None
_captured = None
_path = None
_profiler = torch.autograd.profiler  # ``_is_profiler_enabled``: torch.profiler is on


def begin(k: int) -> None:
    """Open a span of layer id ``k`` (close it with ``end``)."""
    global _layer, _t
    t = _clock()
    _self[_layer] += t - _t
    if _watch:
        for w in _watch:
            w.begin(k, t)
    _open.append(_layer)
    _layer, _t = k, t


def end() -> None:
    """Close the innermost open span."""
    global _layer, _t
    t = _clock()
    _self[_layer] += t - _t
    if _watch:
        for w in _watch:
            w.end(t)
    _layer, _t = _open.pop(), t


def switch(k: int) -> None:
    """Close the innermost open span and open one of layer id ``k`` in its
    place, at one clock read: ``end(); begin(k)`` for consecutive stages."""
    global _layer, _t
    t = _clock()
    _self[_layer] += t - _t
    if _watch:
        for w in _watch:
            w.end(t)
        parent = _open.pop()
        for w in _watch:
            w.begin(k, t)
        _open.append(parent)
    _layer, _t = k, t


def begin_iteration(it: int) -> None:
    """Open iteration ``it``'s ``loop`` span (the hook, if any, runs first,
    after the check for the profiler: a profiler it stops has run here)."""
    global _it
    _it = it
    if _profiler._is_profiler_enabled:
        _rec.profiled = True
    if _hook is not None:
        _hook(it)
    begin(LOOP)


def end_iteration() -> None:
    global _it
    end()
    _it = -1


def begin_sync() -> None:
    """Open a ``sync`` span, a blocking host read, and count the read."""
    _rec.syncs += 1
    begin(SYNC)


def launch(name: str) -> None:
    """Count one launch of the port's kernel ``name``, under the open layer."""
    KERNELS[name] += 1
    try:
        _launches[_layer, name] += 1
    except KeyError:
        _launches[_layer, name] = 1


def _unwind(depth: int) -> None:
    """Close the spans that an exception left open above ``depth``."""
    while len(_open) > depth:
        end()


class span:
    """``with span(name):``, where a ``with`` block's cost does not matter;
    ``ns`` is its duration once closed.  A set-up layer's whole duration
    also adds to ``setup_seconds``."""

    __slots__ = ("layer", "ns", "t0", "depth")

    def __init__(self, name: str):
        self.layer = layer(name)
        self.ns = 0

    def __enter__(self):
        begin(self.layer)
        self.t0, self.depth = _t, len(_open)
        return self

    def __exit__(self, *exc):
        _unwind(self.depth)
        end()
        self.ns = _t - self.t0
        if self.layer in SETUP_LAYERS:
            _setup_ns[NAMES[self.layer]] += self.ns
        return False


class dispatch:
    """``with dispatch(tile, chunk) as record:``: the ``dispatch`` span of one
    dispatch, filing the spans inside it under a new ``Record``."""

    __slots__ = ("record", "outer", "depth")

    def __init__(self, tile: int, chunk: int):
        self.record = Record((tile, chunk))

    def __enter__(self) -> Record:
        global _rec, _self, _launches, _it
        _it = -1
        begin(DISPATCH)  # the time before it stays with the outer record
        self.outer = _rec
        rec = _rec = self.record
        _self, _launches = rec.self_ns, rec.launches
        _records.append(rec)
        self.depth = len(_open)
        return rec

    def __exit__(self, *exc):
        global _rec, _self, _launches, _it
        _unwind(self.depth)
        _it = -1
        if _profiler._is_profiler_enabled:
            self.record.profiled = True
        end()
        _rec = self.outer
        _self, _launches = _rec.self_ns, _rec.launches
        return False


class Keeper:
    """Keeps every span opened while on, in the order they opened, each
    ``(layer id, start, end, parent, dispatch, iteration)`` once closed
    (None while open); ``parent`` is the enclosing kept span's index (-1:
    none).  Past ``MAX_SPANS`` spans are counted as ``dropped``."""

    def __init__(self):
        self.spans: list = []
        self.open: list = []  # (depth, index, start, layer, parent) of each open kept span
        self.dropped = 0

    def begin(self, k: int, t: int) -> None:
        idx = len(self.spans)
        if idx < MAX_SPANS:
            self.spans.append(None)
        else:
            idx = -1
            self.dropped += 1
        parent = self.open[-1][1] if self.open else -1
        self.open.append((len(_open), idx, t, k, parent))

    def end(self, t: int) -> None:
        # a span opened before the keeper has no entry: it stays unkept
        if self.open and self.open[-1][0] == len(_open) - 1:
            _, idx, t0, k, parent = self.open.pop()
            if idx >= 0:
                self.spans[idx] = (k, t0, t, parent, _rec.dispatch, _it)


def _rewatch() -> None:
    global _watch
    _watch = tuple(w for w in (_keeper, _capture) if w is not None)


# -- reading ---------------------------------------------------------------------


def records() -> list:
    """The dispatch records kept, oldest first."""
    return list(_records)


def last_record() -> Record | None:
    return _records[-1] if _records else None


def setup_seconds() -> dict:
    """Seconds spent in each set-up layer in this process (inclusive)."""
    return {k: v * 1e-9 for k, v in _setup_ns.items()}


def summary(recs) -> dict:
    """The operator's view of ``recs``: ``iterations``, ``self_ms`` (ms an
    iteration by layer; ``dispatch`` is the dispatches' own time outside
    their iterations), ``host_reads`` and ``host_read_ms`` (the ``sync``
    layer's time, in all) and ``launches`` ({layer: {kernel: n}}, the port's
    own kernels)."""
    iters = sum(r.iterations for r in recs)
    self_ns, launches = collections.Counter(), {}
    for r in recs:
        self_ns.update(r.self_times())
        for name, by in r.launches_by_layer().items():
            launches.setdefault(name, collections.Counter()).update(by)
    return {"iterations": iters,
            "self_ms": {k: v * 1e-6 / iters for k, v in self_ns.items()} if iters else {},
            "host_reads": sum(r.syncs for r in recs),
            "host_read_ms": self_ns.get("sync", 0) * 1e-6,
            "launches": {k: dict(v) for k, v in launches.items()}}


def summary_line(layers: dict) -> str:
    """``summary`` in one line."""
    stages = " ".join(f"{k} {v:.4f}" for k, v in sorted(
        layers["self_ms"].items(), key=lambda kv: -kv[1]))
    n = sum(sum(v.values()) for v in layers["launches"].values())
    return (f"layers (ms an iteration, {layers['iterations']} iterations): {stages}; "
            f"{layers['host_reads']} host reads, {layers['host_read_ms']:.1f} ms; "
            f"{n} kernel launches")


def spans() -> list:
    """The spans kept (on), in the order they opened, each ``(layer, start
    ns, end ns, parent, dispatch, iteration)``: ``parent`` is the index of
    the parent span in this list (-1: none kept), ``iteration`` -1 outside
    an iteration, a span still open None; [] when off."""
    kept = _keeper.spans if _keeper is not None else ()
    return [None if s is None else (NAMES[s[0]],) + s[1:] for s in kept]


# -- switching -------------------------------------------------------------------


def enable(path: str | None = None) -> None:
    """Keep every span opened from now on; with ``path``, export them there
    when the process exits."""
    global _keeper, _path
    if _keeper is None:
        _keeper = Keeper()
        _rewatch()
    if path and _path is None:
        atexit.register(_export_at_exit)
    _path = path or _path


def disable() -> None:
    global _keeper
    _keeper = None
    _rewatch()


def reset() -> None:
    """Forget every record, span and count, and stay on or off (tests)."""
    global _outside, _rec, _self, _launches, _layer, _t, _keeper, _it, _hook, _captured
    if _capture is not None:
        _capture.close()
    _outside = _rec = Record()
    _self, _launches = _rec.self_ns, _rec.launches
    _layer, _t, _it, _hook, _captured = NONE, _clock(), -1, None, None
    _open.clear()
    _records.clear()
    _setup_ns.clear()
    KERNELS.clear()
    _keeper = None if _keeper is None else Keeper()
    _rewatch()


def _export_at_exit() -> None:
    if _path and _keeper is not None:
        export(_path)


def set_hook(fn) -> None:
    """Call ``fn(it)`` where each iteration starts (None: no hook)."""
    global _hook
    _hook = fn


def current_record() -> Record:
    return _rec


# -- clocks, the profiler and idle time ------------------------------------------


def epoch_offset_ns() -> int:
    """Unix-epoch ns less ``perf_counter_ns`` now, from the tightest of a few
    bracketed reads: the shift from the recorder's clock to the profiler's."""
    best = None
    for _ in range(5):
        a = _clock()
        e = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


def device_intervals(prof) -> list:
    """``(start, end, name)`` of each device activity of a stopped
    ``torch.profiler.profile``, in the recorder's clock (ns), sorted."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    start = (res.trace_start_ns() if hasattr(res, "trace_start_ns")
             else res.trace_start_us() * 1000)
    base = start - epoch_offset_ns()
    return sorted((base + int(e.time_range.start * 1e3), base + int(e.time_range.end * 1e3),
                   e.name) for e in prof.events() if e.device_type == DeviceType.CUDA)


def _innermost(kept) -> list:
    """Host time cut into ``(start, end, layer)`` pieces, each labelled with
    its innermost open span's layer, in order."""
    out, stack, cur = [], [], None
    for layer, t0, t1, *_ in sorted(kept, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][0] <= t0:
            end, lab = stack.pop()
            if end > cur:
                out.append((cur, end, lab))
                cur = end
        if stack and t0 > cur:
            out.append((cur, t0, stack[-1][1]))
        stack.append((t1, layer))
        cur = t0
    while stack:
        end, lab = stack.pop()
        if end > cur:
            out.append((cur, end, lab))
            cur = end
    return out


def idle_by_span(device_intervals, kept=None) -> dict:
    """Seconds of device idle time by the host layer open during it.

    ``device_intervals``: ``(start, end, ...)`` in the recorder's clock (ns).
    Each gap between the merged intervals is split over the host spans open
    at that time, each piece going to the innermost one; time under no span,
    or under ``dispatch`` or ``loop`` alone, goes to ``loop``.  ``kept``:
    the spans (default: those kept by the recorder)."""
    merged = []
    for s, e, *_ in sorted(device_intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    pieces = _innermost([s for s in (spans() if kept is None else kept) if s is not None])
    loop = {NAMES[k] for k in LOOP_LAYERS}
    starts = [p[0] for p in pieces]
    idle = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        covered = 0
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(pieces[k][0], a), min(pieces[k][1], b)
            if hi > lo:
                lab = pieces[k][2]
                idle["loop" if lab in loop else lab] += hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            idle["loop"] += b - a - covered
    return {k: v * 1e-9 for k, v in idle.most_common()}


class ProfiledStretch:
    """A device-only ``torch.profiler`` over iterations ``[START, START +
    ITERS)`` of the first dispatch that reaches ``START`` (or to its end),
    the harness's stretch.  It records no host operators: that slowed the
    loop about threefold.  ``arm`` starts and stops the profiler once first
    (its first start loads CUPTI, seconds) and hooks the recorder's
    iterations."""

    START, ITERS = 20, 200

    def __init__(self):
        self.prof = None
        self.rec = None
        self.done = False

    def arm(self) -> None:
        warm = self._profiler()
        warm.start()
        torch.cuda.synchronize()
        warm.stop()
        set_hook(self._on_iteration)

    @staticmethod
    def _profiler():
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def _on_iteration(self, it: int) -> None:
        if self.prof is None:
            if it == self.START:
                torch.cuda.synchronize()
                self.rec = current_record()
                self.prof = self._profiler()
                self.prof.start()
        elif not self.done and (it >= self.START + self.ITERS
                                or current_record() is not self.rec):
            self.stop()

    def stop(self) -> None:
        """End the stretch (also where the render ended inside it) and unhook."""
        if self.prof is not None and not self.done:
            torch.cuda.synchronize()
            self.prof.stop()
            self.done = True
        if _hook == self._on_iteration:
            set_hook(None)

    def intervals(self) -> list:
        """The stretch's device intervals (``device_intervals``); [] if none ran."""
        return device_intervals(self.prof) if self.done else []


def export(path: str, device=()) -> None:
    """Write the kept spans, and ``device`` intervals ``(start, end, name)``
    in the recorder's clock, as one Chrome trace (JSON; Perfetto and
    chrome://tracing load it), stamped in Unix-epoch microseconds, the clock
    of ``torch.profiler``'s events."""
    off = epoch_offset_ns()
    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "host spans"}},
              {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "device"}}]
    for layer, t0, t1, parent, disp, it in (s for s in spans() if s is not None):
        events.append({"ph": "X", "name": layer, "pid": 1, "tid": 1,
                       "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": {"dispatch": disp, "iteration": it, "parent": parent}})
    for t0, t1, name in device:
        events.append({"ph": "X", "name": name, "pid": 2, "tid": 1,
                       "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns",
                   "otherData": {"dropped_spans": _keeper.dropped if _keeper else 0}}, fh)


# -- launches under a CUDA graph capture -------------------------------------------

# CUgraphNodeType: kernel, memcpy and memset nodes, one launch each
WORK_NODES = (0, 1, 2)


def _cu():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuStreamGetCaptureInfo_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return cu


def graph_work_nodes(cu, graph) -> int:
    """Kernel, memcpy and memset nodes of the CUDA graph ``graph``."""
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, work = ctypes.c_int(-1), 0
    for node in nodes[:n.value]:
        if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        work += kind.value in WORK_NODES
    return work


def _stream_nodes(stream: int):
    """A counter of the work nodes in the graph that ``stream`` is capturing;
    it returns None once the stream is not capturing."""
    cu = _cu()

    def nodes():
        status, graph = ctypes.c_int(0), ctypes.c_void_p()
        if cu.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream), ctypes.byref(status), None,
                                        ctypes.byref(graph), None, None) != 0 \
                or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            return None
        return graph_work_nodes(cu, graph)

    return nodes


class Capture:
    """Counts the work nodes that the spans add to a graph being captured,
    as self times are kept: at each span boundary the nodes added since the
    last one go to the innermost open layer (those under no stage span, to
    ``loop``).  ``open`` puts it among what sees each boundary; ``close``
    takes it off and leaves the counts to ``last_capture``.  ``nodes`` returns the graph's work nodes, or None once the capture is
    over (it raised): the counting then stops."""

    def __init__(self, nodes):
        self.nodes = nodes
        self.counts = collections.Counter()
        self.last = 0

    def charge(self) -> bool:
        n = self.nodes()
        if n is None:
            self.close(complete=False)
            return False
        self.counts[_layer] += n - self.last
        self.last = n
        return True

    def begin(self, k: int, t: int) -> None:
        self.charge()

    def end(self, t: int) -> None:
        self.charge()

    def open(self) -> Capture:
        global _capture
        n = self.nodes()
        if n is not None:
            self.last, _capture = n, self
            _rewatch()
        return self

    def close(self, complete: bool = True) -> None:
        global _capture, _captured
        if _capture is not self:
            return
        if complete and self.charge():
            counts = collections.Counter()
            for k, n in self.counts.items():
                counts["loop" if k in LOOP_LAYERS else NAMES[k]] += n
            _captured = {k: n for k, n in counts.items() if n}
        _capture = None
        _rewatch()


def capturing(t: torch.Tensor) -> Capture | None:
    """At the start of an iteration on ``t``'s device: an open ``Capture``
    where the current stream is being captured into a CUDA graph (the
    caller closes it at the iteration's end), else None: the capture itself
    goes on whether or not its nodes can be counted."""
    if not t.is_cuda:
        return None
    if _capture is not None:  # left open by an exception
        _capture.close(complete=False)
    if not torch.cuda.is_current_stream_capturing():
        return None
    try:
        nodes = _stream_nodes(torch.cuda.current_stream(t.device).cuda_stream)
    except (OSError, AttributeError):  # libcuda lacks the entry point to read the graph
        return None
    return Capture(nodes).open()


def last_capture() -> dict | None:
    """{layer: kernel, memcpy and memset nodes} of the last captured step."""
    return dict(_captured) if _captured is not None else None


if os.environ.get("ART_TPU_TRACE"):
    enable(os.environ["ART_TPU_TRACE"])
