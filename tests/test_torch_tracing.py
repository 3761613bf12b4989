"""The program's recorder (``art_tpu_torch/utils/tracing.py``): spans nest
and their self times add up, a dispatch's record holds what
``render_wavefront`` returns, every stage span appears on each path, off
keeps sums alone and they equal an on run's spans, the Chrome export
parses, ``idle_by_span`` files gaps under the open layer, and
``render_scene`` reports the layers.  Plain twins on the CPU; the two tests
marked ``card`` (the capture's node counts, the spans' clock against the
profiler's) skip without an NVIDIA card and run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m card -s

This file imports no JAX."""

import collections
import ctypes
import json
import time

import pytest
import torch

from art_tpu_torch import cli
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops import _build, routes
from art_tpu_torch.render import integrator
from art_tpu_torch.render.renderer import RenderConfig, render_scene
from art_tpu_torch.utils import tracing

NX, NY, SPP = 16, 8, 2
STAGES = {"dispatch", "loop", "sync", "refill", "intersect", "media", "shade"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run this file with -m card on one)")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _dispatch(scene, tile_pixels=NX * NY, spp=SPP, **kw):
    return integrator.render_wavefront(
        scene.tables, scene.camera, 0, spp, scene.background, tile_pixels=tile_pixels,
        total_pixels=NX * NY, nx=NX, ny=NY, max_depth=50, gradient_bg=scene.gradient_bg,
        n_slots=256, tile=3, chunk=1, seed=5, **kw)


def _children(kept):
    kids = collections.defaultdict(list)
    for s in kept:
        if s[3] >= 0:
            kids[s[3]].append(s)
    return kids


def test_spans_nest_and_self_times_add_up():
    tracing.enable()
    _dispatch(build_scene("three_spheres", NX, NY))
    kept = tracing.spans()
    assert kept and None not in kept
    kids = _children(kept)
    for k, (_, t0, t1, parent, _, _) in enumerate(kept):
        for c in kids[k]:  # children lie inside their parent, one after another
            assert t0 <= c[1] <= c[2] <= t1
        assert all(a[2] <= b[1] for a, b in zip(kids[k], kids[k][1:]))
        if parent >= 0:
            assert kept[parent][1] <= t0
    # a layer's self time is its spans less their children: the record's sums
    mine = collections.Counter()
    for k, s in enumerate(kept):
        if s[4] == (3, 1):
            mine[s[0]] += s[2] - s[1] - sum(c[2] - c[1] for c in kids[k])
    assert tracing.last_record().self_times() == dict(mine)
    rec = tracing.last_record()
    assert set(rec.self_times()) == STAGES
    loops = [s for s in kept if s[0] == "loop"]
    assert [s[5] for s in loops] == list(range(len(loops)))
    assert all(kept[s[3]][0] == "loop" for s in kept if s[0] == "refill")
    assert kept[loops[0][3]][0] == "dispatch"


def test_dispatch_record_holds_what_render_wavefront_returns():
    scene = build_scene("three_spheres", NX, NY)
    fb, rays, iters = _dispatch(scene)
    rec = tracing.last_record()
    assert rec.dispatch == (3, 1)
    assert (rec.iterations, rec.segments) == (iters, rays)
    assert rays > 0 and iters > 0
    assert rec.syncs >= 3  # the exit checks, hist.cpu() and int(lost)
    assert tracing.current_record() is not rec  # closed
    assert tracing.records()[-1] is rec


@pytest.mark.parametrize("name, kw, route, layers", [
    ("three_spheres", {"short_path": False}, {}, STAGES),
    ("perlin", {"short_path": False}, {}, STAGES | {"textures"}),
    ("three_spheres", {}, {"seam_flush": True}, STAGES),
    ("quads", {}, {}, {"dispatch", "loop", "sync", "short_path"}),
])
def test_every_stage_span_appears_on_each_path(name, kw, route, layers):
    scene = build_scene(name, NX, NY)
    with routes.using(**route):
        _, rays, iters = _dispatch(scene, **kw)
    rec = tracing.last_record()
    assert set(rec.self_times()) == layers
    assert (rec.iterations, rec.segments) == (iters, rays)


def test_off_keeps_sums_alone_and_they_equal_an_on_run():
    scene = build_scene("perlin", NX, NY)
    _dispatch(scene, short_path=False)
    off = tracing.last_record()
    assert tracing.spans() == [] and tracing._keeper is None and tracing._watch == ()
    tracing.enable()
    _dispatch(scene, short_path=False)
    on = tracing.last_record()
    assert (on.iterations, on.segments, on.syncs) == (off.iterations, off.segments, off.syncs)
    assert on.launches == off.launches
    assert set(on.self_times()) == set(off.self_times())
    kept = tracing.spans()
    kids = _children(kept)
    sums = collections.Counter()
    for k, s in enumerate(kept):
        if s[4] == (3, 1):
            sums[s[0]] += s[2] - s[1] - sum(c[2] - c[1] for c in kids[k])
    assert on.self_times() == dict(sums)
    assert sum(1 for s in kept if s[0] == "sync") == on.syncs


def test_chrome_export_parses(tmp_path):
    tracing.enable()
    _dispatch(build_scene("three_spheres", NX, NY))
    n = len(tracing.spans())
    t0 = tracing.spans()[0][1]
    path = tmp_path / "trace.json"
    tracing.export(str(path), [(t0, t0 + 5000, "kernel_a"), (t0 + 9000, t0 + 9500, "kernel_b")])
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    host = [e for e in events if e["ph"] == "X" and e["pid"] == 1]
    dev = [e for e in events if e["ph"] == "X" and e["pid"] == 2]
    assert len(host) == n and [e["name"] for e in dev] == ["kernel_a", "kernel_b"]
    assert {"dispatch", "loop", "refill"} <= {e["name"] for e in host}
    assert all(e["dur"] >= 0 for e in host + dev)
    first = min(host, key=lambda e: e["ts"])
    assert first["ts"] == pytest.approx(dev[0]["ts"], abs=1.0)  # one clock, in us
    assert abs(first["ts"] * 1e-6 - time.time()) < 3600  # epoch seconds


def test_idle_by_span_on_synthetic_intervals():
    kept = [("dispatch", 0, 1000, -1, (0, 0), -1),
            ("loop", 0, 500, 0, (0, 0), 0),
            ("media", 100, 300, 1, (0, 0), 0),
            ("intersect", 300, 400, 1, (0, 0), 0),
            ("loop", 500, 1000, 0, (0, 0), 1),
            ("shade", 600, 900, 4, (0, 0), 1)]
    device = [(0, 100), (150, 160), (350, 600), (650, 700), (950, 1000), (1100, 1200)]
    idle = tracing.idle_by_span(device, kept)
    want = {"media": 190, "intersect": 50, "shade": 250, "loop": 50 + 100}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    # overlapping device intervals merge; no gap, no idle time
    assert tracing.idle_by_span([(0, 500), (100, 1000)], kept) == {}


def test_render_scene_reports_layers(capsys):
    scene = build_scene("three_spheres", NX, NY)
    _, stats = render_scene(scene, RenderConfig(nx=NX, ny=NY, spp=SPP), verbose=True,
                            device="cpu")
    layers = stats["layers"]
    assert layers["iterations"] == stats["iterations"]
    assert STAGES <= set(layers["self_ms"])
    assert layers["host_reads"] >= 3 and layers["host_read_ms"] >= 0
    assert layers["launches"] == {}  # the CPU takes the twins: no kernel launch
    assert "layers (ms an iteration" in capsys.readouterr().err


def test_launch_counter_files_under_the_open_layer():
    assert _build.launches is tracing.KERNELS
    k = tracing.layer("refill")
    with tracing.dispatch(0, 0) as rec:
        tracing.begin(k)
        _build.launch("probe")
        tracing.end()
        _build.launch("probe")
    assert _build.launches["probe"] == 2
    assert rec.launches_by_layer() == {"refill": {"probe": 1}, "dispatch": {"probe": 1}}


def test_switch_closes_a_span_and_opens_the_next():
    tracing.enable()
    refill, shade = tracing.layer("refill"), tracing.layer("shade")
    nodes = _Nodes()
    with tracing.dispatch(0, 0) as rec:
        tracing.begin_iteration(0)
        cap = tracing.Capture(nodes).open()
        tracing.begin(refill)
        nodes.n += 1
        tracing.switch(shade)
        nodes.n += 4
        tracing.end()
        cap.close()
        tracing.end_iteration()
    kept = tracing.spans()
    assert [s[0] for s in kept] == ["dispatch", "loop", "refill", "shade"]
    _, (_, _, l1, *_), (_, r0, r1, rp, *_), (_, s0, s1, sp, *_) = kept
    assert rp == sp == 1 and r1 == s0 and s1 <= l1  # they abut, under one loop span
    assert rec.self_ns[refill] == r1 - r0 and rec.self_ns[shade] == s1 - s0
    assert tracing.last_capture() == {"refill": 1, "shade": 4}
    assert tracing._open == [] and tracing._watch == (tracing._keeper,)


def test_dispatches_run_under_the_profiler_are_marked():
    scene = build_scene("three_spheres", NX, NY)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    n = [0]

    def hook(it):  # on from the second dispatch's iteration 1 to the third's start
        if n[0] == 1 and it == 1:
            prof.start()
        elif n[0] == 2 and it == 0:
            prof.stop()

    tracing.set_hook(hook)
    for n[0] in range(4):
        _dispatch(scene)
    assert [r.profiled for r in tracing.records()] == [False, True, True, False]


def test_set_up_spans():
    scene = build_scene("three_spheres", NX, NY)
    scene.tables.to("cpu")
    got = tracing.setup_seconds()
    assert got["scene"] > 0 and got["tables"] > 0


def test_dispatch_closes_spans_an_exception_left_open():
    with pytest.raises(RuntimeError):
        with tracing.dispatch(0, 0):
            tracing.begin(tracing.layer("refill"))
            raise RuntimeError("inside a span")
    assert tracing._open == [] and tracing.current_record() is tracing._outside


class _Nodes:
    """A stand-in for a capturing stream's node count."""

    def __init__(self):
        self.n, self.live = 7, True

    def __call__(self):
        return self.n if self.live else None


def test_capture_counts_nodes_by_layer():
    nodes = _Nodes()
    refill, shade, tex = map(tracing.layer, ("refill", "shade", "textures"))
    with tracing.dispatch(0, 0):
        tracing.begin_iteration(0)
        cap = tracing.Capture(nodes).open()
        assert tracing._watch == (cap,)
        tracing.begin(refill)
        nodes.n += 1
        tracing.end()
        nodes.n += 2  # glue between the stages
        tracing.begin(shade)
        nodes.n += 4
        tracing.begin(tex)
        nodes.n += 8
        tracing.end()
        nodes.n += 16
        tracing.end()
        cap.close()
        tracing.end_iteration()
    assert tracing.last_capture() == {"refill": 1, "loop": 2, "shade": 20, "textures": 8}
    assert sum(tracing.last_capture().values()) == nodes.n - 7
    assert tracing._capture is None and tracing._watch == ()
    # a capture that ends early (it raised) stops counting and reports nothing
    nodes = _Nodes()
    tracing.Capture(nodes).open()
    tracing.begin(refill)
    nodes.live = False
    tracing.end()
    assert tracing._capture is None and tracing._watch == ()
    assert tracing.last_capture() == {"refill": 1, "loop": 2, "shade": 20, "textures": 8}


def test_cli_trace_writes_a_chrome_trace(tmp_path, capsys):
    path = tmp_path / "t.json"
    out = tmp_path / "o.ppm"
    assert cli.main(["--scene", "three_spheres", "--nx", "8", "--ny", "4", "--spp", "1",
                     "--device", "cpu", "--out", str(out), "--trace", str(path)]) == 0
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"scene", "tables", "dispatch", "loop", "refill", "shade"} <= names
    assert "spans and 0 device events" in capsys.readouterr().err
    assert cli.main(["--sharded", "--trace", str(path), "--device", "cpu"]) == 2


# -- on the card --------------------------------------------------------------------


def _graph_work_nodes(graph) -> int:
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    work = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        work += kind.value in (0, 1, 2)  # kernel, memcpy, memset
    return work


@pytest.mark.card
@pytest.mark.parametrize("name, layers", [
    ("bouncing_spheres", {"refill", "intersect", "shade"}),  # no media, plane-fed
    ("final_scene", {"refill", "intersect", "media", "textures", "shade"}),
])
def test_capture_counts_add_up_to_the_graph(card, name, layers):
    from art_tpu_torch.ops import refill_kernel as rk

    scene = build_scene(name, 64, 32)
    tables = scene.tables.to(card)
    scal = rk.RefillScal(4, 2048, 0, 2048, 64, 32)
    pool = rk.new_pool(2048, card)
    q = torch.zeros(2, dtype=torch.int64, device=card)
    hist = torch.zeros(64, dtype=torch.int64, device=card)
    fb = torch.zeros((2048, 3), dtype=torch.float32, device=card)
    lost = torch.zeros(1, dtype=torch.int32, device=card)
    kw = dict(key=(5, 0, 0), ncols=integrator.n_uniform_cols(tables), max_depth=50,
              gradient=scene.gradient_bg)
    for it in range(4):
        integrator.staged_step(pool, scene.camera, q, it % 2, hist, it, scal, tables,
                               scene.background, fb, lost, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        integrator.staged_step(pool, scene.camera, q, 0, hist, 4, scal, tables,
                               scene.background, fb, lost, **kw)
    counts = tracing.last_capture()
    total = _graph_work_nodes(graph)
    graph.reset()
    print(f"{name}: {total} nodes, by layer {counts}")
    assert sum(counts.values()) == total
    assert layers <= set(counts) <= layers | {"loop"}
    assert tracing._capture is None and tracing._watch == ()


@pytest.mark.card
def test_spans_and_profiler_share_one_clock(card):
    x = torch.zeros(1 << 20, device=card)
    probe = tracing.layer("probe")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()  # the first start loads CUPTI
    torch.cuda.synchronize()
    prof.stop()
    tracing.enable()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    for _ in range(100):
        tracing.begin(probe)
        torch.cuda.synchronize()
        x.add_(1.0)
        torch.cuda.synchronize()
        tracing.end()
    prof.stop()
    kept = [s for s in tracing.spans() if s[0] == "probe"]
    dev = tracing.device_intervals(prof)
    assert len(kept) == 100 and len(dev) == 100, (len(kept), len(dev))
    widen = 20_000
    worst = -float("inf")
    for (_, t0, t1, *_), (d0, d1, _) in zip(kept, dev):
        worst = max(worst, t0 - d0, d1 - t1)
        assert t0 - widen <= d0 and d1 <= t1 + widen, (t0 - d0, d1 - t1)
    print(f"largest offset of a kernel past its span's ends: {worst / 1e3:.3f} us "
          f"(negative: every kernel inside its span by that much)")
