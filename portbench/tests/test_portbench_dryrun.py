"""Every cell's run on the host at a tiny size through the harness's own
code (the plain twins of the kernels): the result line has exactly the
contract's keys, and the window runs whole passes of the job."""

import json

import pytest
from pb_tiny import TINY, tiny_cell

from portbench import cells, run

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_dry_run_line(cell):
    c = tiny_cell(cell)
    line = run.measure(c, 2**31 + 12345, 0.01, False, "cpu", shrink=TINY)
    assert list(line) == KEYS
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(c.settings["limits"])
    json.dumps(line)


def test_traced_dry_run_line():
    c = tiny_cell("bouncing_spheres.job")
    c.traffic = dict(c.traffic, profile={"start": 1, "iters": 4})
    line = run.measure(c, 7, 0.01, True, "cpu", shrink=TINY)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    names = {m["name"] for m in c.per_layer}
    assert set(line["metrics"]) <= names
    assert {"occupancy", "iter_ms", "host_ms.intersect"} <= set(line["metrics"])



@pytest.mark.parametrize("elapsed, passes, seconds, closes", [
    (0.5, 1, 0.01, True),  # at least one pass, however short the window
    (36.0, 1, 40.0, True),  # the next end, near 72 s, is farther from 40
    (20.0, 1, 40.0, False),  # the next end, near 40 s, is nearer
    (38.0, 4, 40.0, True),
    (30.0, 4, 40.0, False),
])
def test_window_closes_at_the_nearest_pass_end(elapsed, passes, seconds, closes):
    from portbench import drivers

    assert drivers.close_after(elapsed, passes, seconds) is closes


def test_window_runs_whole_passes():
    import torch

    from portbench import drivers

    c = tiny_cell("bouncing_spheres.job")
    shrink = dict(TINY, spp=1024)  # a job of many chunks a tile
    w = drivers.run_job(c, 3, 0.01, torch.device("cpu"), shrink=shrink)
    assert w.passes >= 1 and w.attempted % (w.attempted // w.passes) == 0
    assert (w.counts == w.counts[0]).all() and w.counts[0] > 0
