"""A cell cut to a tiny size for a rehearsal on the host."""

from __future__ import annotations

import copy

from portbench import cells

TINY = {"nx": 16, "ny": 8, "spp": 4}
TINY_JUDGE = {"pixels": 64, "ref_spp": 256}


def tiny_cell(name: str, root=cells.ROOT):
    cell = cells.load_cell(name, root)
    cell.settings = copy.deepcopy(cell.settings)
    cell.settings["judge"] = dict(TINY_JUDGE)
    return cell

