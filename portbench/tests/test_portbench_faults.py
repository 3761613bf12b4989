"""The comparison that decides ``correct`` catches each fault a cell can
have, planted under the timed path (``portbench/faults.py``), on the host at
a tiny size, the look for a card skipped; the same run unbroken passes."""

import pytest
from pb_tiny import tiny_cell

from portbench import run

# sizes at which each pixel's mean is near normal, as at the cells' own
SHRINK = {"bouncing_spheres.job": {"nx": 8, "ny": 8, "spp": 512},
          "final_scene.job": {"nx": 24, "ny": 24, "spp": 256}}
JUDGE = {"bouncing_spheres.job": {"pixels": 256, "ref_spp": 1024},
         "final_scene.job": {"pixels": 256, "ref_spp": 1024}}


def _line(cell_name, fault, seed=4242):
    cell = tiny_cell(cell_name)
    cell.settings["judge"] = dict(JUDGE[cell_name])
    return run.measure(cell, seed, 0.01, False, "cpu", shrink=SHRINK[cell_name], fault=fault)


@pytest.mark.parametrize("cell", ["bouncing_spheres.job", "final_scene.job"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_fault_fails_the_comparison(cell, fault):
    line = _line(cell, fault)
    assert line["correct"] is (fault is None), line["checks"]

