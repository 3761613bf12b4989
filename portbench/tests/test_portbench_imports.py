"""Nothing a run imports has the top-level name ``jax``, ``jaxlib``, ``flax``
or ``art_tpu``, compared whole, so ``art_tpu_torch`` passes."""

import os
import subprocess
import sys

from portbench import cells, run

PROGRAM = """
import sys
from pb_tiny import TINY, tiny_cell
from portbench import run
run.measure(tiny_cell("final_scene.job"), 11, 0.01, False, "cpu", shrink=TINY)
assert "art_tpu_torch" in sys.modules
print("FOUND", run.forbidden_modules())
"""


def test_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules["art_tpu_torch_fake.x"] = sys
        assert "art_tpu" not in run.forbidden_modules()
        sys.modules["art_tpu.render"] = sys
        assert "art_tpu" in run.forbidden_modules()
        sys.modules["jaxlib"] = sys
        assert "jaxlib" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    here = cells.ROOT / "portbench" / "tests"
    out = subprocess.run([sys.executable, "-c", PROGRAM], capture_output=True, text=True,
                         cwd=cells.ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=f"{here}:{cells.ROOT}"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
