"""The control, the reference in bfloat16 in the program's place, comes out
not correct (on the card, at a size a test run holds)."""

import pytest

from portbench import control, drivers, judge
from portbench.cells import load_cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["final_scene.job", "bouncing_spheres.job"])
def test_control_is_not_correct(card, cell):
    c = load_cell(cell)
    c.settings["judge"] = {"pixels": 128, "ref_spp": 2048}
    shrink = {"nx": 200, "ny": 200}
    w = drivers.KINDS[c.traffic["kind"]](c, 31337, 1.0, card, None, shrink)
    readings = control.control_readings(c, drivers.scene_size(c, shrink), w, 31337, card)
    assert not judge.verdict(readings, c.settings["limits"]), readings
