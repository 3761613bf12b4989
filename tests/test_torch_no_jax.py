"""art_tpu_torch must import without JAX: the machine with the card has none.

A subprocess blocks ``jax`` (``sys.modules['jax'] = None`` makes any import
of it raise) and imports every module of the package."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import art_tpu_torch
names = [m.name for m in pkgutil.walk_packages(art_tpu_torch.__path__, "art_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "art_tpu" not in sys.modules
print(" ".join(names))
"""
# the modules the latest slices added (slice 3: noise, turbulence, the short
# path; slice 4: images, the flush and table-gather kernels, the compacted
# fetch; slice 5: the split sphere pass; slice 6: the sphere routes and the
# culling tables; slice 7: the BVH; multi-device rendering)
NEW_MODULES = ("art_tpu_torch.ops.perlin", "art_tpu_torch.ops.perlin_kernel",
               "art_tpu_torch.ops.sp_kernel", "art_tpu_torch.utils.images",
               "art_tpu_torch.ops.flush_kernel", "art_tpu_torch.ops.compact_fetch",
               "art_tpu_torch.ops.compact_sphere", "art_tpu_torch.ops.routes",
               "art_tpu_torch.scene.cull", "art_tpu_torch.ops.bvh",
               "art_tpu_torch.parallel", "art_tpu_torch.parallel.sharding")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 27 and set(NEW_MODULES) <= set(names)
