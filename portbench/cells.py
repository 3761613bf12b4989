"""Finding a cell's files by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything that
belongs to it sits in files of its own, found by the names in that entry:

* ``portbench/configs/<config>.json``: the deployment as it is run (scene,
  resolution, samples a pixel, depth, pool) with the published description
  that ``portbench/configs/<config>.py`` builds the plain reference scene from;
* ``portbench/traffic/<traffic>.json``: the traffic mix, parameters that the
  one generator (``portbench/drivers.py``) reads;
* ``portbench/workloads/<cell>.json``: the cell's own settings: route
  switches (``env``), the reference's sample sizes and the limits of the
  comparison that decides ``correct``;
* ``portbench/metrics/<metric>.py``: one reader a per-layer metric.

A later cell, traffic mix or metric is added as files and entries; no file
here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list
    root: Path

    def config_module(self):
        return load_module(self.root / "portbench" / "configs" / f"{self.config_name}.py")

    def metric_module(self, name: str):
        return load_module(self.root / "portbench" / "metrics" / f"{name}.py")


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module of the benchmark's data (a configuration's reference scene, a
    metric's reader) loaded from its file; names may hold dots."""
    spec = importlib.util.spec_from_file_location("portbench_file_" + path.stem.replace(".", "_")
                                                  + "_" + path.parent.name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    entry = [w for w in bench["workloads"] if w["name"] == name]
    if not entry:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = entry[0]
    pb = root / "portbench"
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=_read(pb / "configs" / f"{w['config']}.json"),
                traffic=_read(pb / "traffic" / f"{w['traffic']}.json"),
                settings=_read(pb / "workloads" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)], root=root)
