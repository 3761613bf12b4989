"""A cell added as files and an entry is found, and runs, without an edit
to any file the benchmark has."""

import json
import shutil

from pb_tiny import TINY, TINY_JUDGE

from portbench import cells, run


def test_new_cell_from_files(tmp_path):
    pb = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(cells.ROOT / "portbench" / sub, pb / sub)
    # the image the configurations read
    img = "art_tpu_torch/assets/textures/earthmap.jpg.npz"
    (tmp_path / img).parent.mkdir(parents=True)
    shutil.copy(cells.ROOT / img, tmp_path / img)
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bouncing_spheres.profiled", "config": "bouncing_spheres",
                               "traffic": "job_profiled", "chips": 1, "why": "a test cell"})
    for m in bench["per_layer"]:
        m["workloads"].append("bouncing_spheres.profiled")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((pb / "traffic" / "job.json").read_text())
    traffic["profile"] = {"start": 2, "iters": 50}
    (pb / "traffic" / "job_profiled.json").write_text(json.dumps(traffic))
    settings = json.loads((pb / "workloads" / "bouncing_spheres.job.json").read_text())
    settings["judge"] = TINY_JUDGE
    (pb / "workloads" / "bouncing_spheres.profiled.json").write_text(json.dumps(settings))

    cell = cells.load_cell("bouncing_spheres.profiled", tmp_path)
    assert cell.traffic["profile"]["iters"] == 50 and cell.config["scene"] == "bouncing_spheres"
    assert {m["name"] for m in cell.per_layer} >= {"occupancy", "idle_share"}
    line = run.measure(cell, 99, 0.01, False, "cpu", shrink=TINY)
    assert line["attempted"] >= 1 and set(line["metrics"]) == {"msamples_per_s", "setup_s"}


def test_unknown_cell_names_the_known():
    try:
        cells.load_cell("no_such.cell")
    except KeyError as exc:
        assert "final_scene.job" in str(exc)
    else:
        raise AssertionError("an unknown cell was found")
