"""The metrics that read the program's recorder (``portbench/recorder.py``)
on a traced host dry run of each cell: each reads a value where the host
has one to read, over the dispatches that ran with no profiler, and on the
card every one of them does, the launches by layer adding up to
``launches_per_iter``."""

import types

import pytest
from pb_tiny import TINY, tiny_cell

from portbench import drivers, recorder, run

RECORDER = {"self_ms.refill", "self_ms.intersect", "self_ms.shade", "self_ms.loop",
            "self_ms.media", "self_ms.textures", "sync_ms", "launches.intersect",
            "launches.shade", "launches.media", "scene_build_s", "library_load_s"}
CARD_ONLY = {"launches.intersect", "launches.shade", "launches.media", "library_load_s"}


def _traced_line(cell_name, device, shrink, monkeypatch):
    from art_tpu_torch.utils import tracing

    c = tiny_cell(cell_name)
    c.traffic = dict(c.traffic, profile={"start": 1, "iters": 4})
    names = {m["name"] for m in c.per_layer} & RECORDER
    # the tiny job's one tile in two chunks, both in the window: the stretch
    # lies in the first dispatch
    plan = drivers.plan

    def two_chunks(*args):
        rc, (tile_pixels, spp_chunk, n_slots) = plan(*args)
        return rc, (tile_pixels, -(-spp_chunk // 2), n_slots)

    monkeypatch.setattr(drivers, "plan", two_chunks)
    monkeypatch.setattr(drivers, "close_after", lambda elapsed, passes, seconds: passes >= 2)
    line = run.measure(c, 2**31 + 99, 0.01, True, device, shrink=shrink)
    return names, line, tracing.records()[-line["attempted"]:]


@pytest.mark.parametrize("cell", ["final_scene.job", "bouncing_spheres.job"])
def test_recorder_metrics_read_on_the_host(cell, monkeypatch):
    names, line, recs = _traced_line(cell, "cpu", TINY, monkeypatch)
    got = line["metrics"]
    assert [r.profiled for r in recs] == [True, False]
    assert names - CARD_ONLY <= set(got)
    assert not (CARD_ONLY & set(got))  # no capture and no library on the host
    for name in names - CARD_ONLY:
        assert got[name]["value"] >= 0
    assert got["scene_build_s"]["value"] > 0
    # the self times are the unprofiled dispatch's alone
    kept = recs[1]
    assert got["self_ms.intersect"]["value"] == pytest.approx(
        1e-6 * kept.self_times()["intersect"] / kept.iterations)


def test_self_ms_leaves_out_profiled_dispatches():
    from art_tpu_torch.utils import tracing

    def rec(iters, refill_ns, profiled):
        r = tracing.Record((0, 0))
        r.iterations, r.profiled = iters, profiled
        r.self_ns[tracing.layer("refill")] = refill_ns
        return r

    recs = [rec(100, 9_000_000, True), rec(300, 600_000, False), rec(100, 400_000, False)]
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(attempted=3, iterations=500))
    tracing.reset()
    tracing._records.extend(recs)
    try:
        assert recorder.self_ms(ctx, "refill") == pytest.approx(1e-6 * 1_000_000 / 400)
        assert recorder.self_ms(ctx, "media") is None
        recs[1].profiled = recs[2].profiled = True
        assert recorder.self_ms(ctx, "refill") is None  # every dispatch was profiled
        ctx.window.iterations = 499  # the records do not hold the window
        assert recorder.window_records(ctx) is None
    finally:
        tracing.reset()


@pytest.mark.card
@pytest.mark.parametrize("cell", ["final_scene.job", "bouncing_spheres.job"])
def test_recorder_metrics_read_on_the_card(card, cell, monkeypatch):
    from art_tpu_torch.utils import tracing

    names, line, _ = _traced_line(cell, "cuda", dict(TINY, nx=64, ny=32), monkeypatch)
    got = line["metrics"]
    assert names <= set(got)
    counts = tracing.last_capture()
    layers = {n.split(".", 1)[1] for n in names if n.startswith("launches.")}
    for layer in layers:
        assert got[f"launches.{layer}"]["value"] == counts.get(layer, 0)
    rest = sum(n for k, n in counts.items() if k not in layers)
    assert sum(got[f"launches.{k}"]["value"] for k in layers) + rest \
        == got["launches_per_iter"]["value"]
