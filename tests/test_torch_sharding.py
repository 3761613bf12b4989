"""Multi-device rendering of the port (``art_tpu_torch.parallel``) on the CPU.

Every rank is a child process on gloo (``spawn_ranks``: a ``file://`` store
in a temporary directory, no TCP port but the launcher test's free one),
one intra-op thread each; every world is joined with a timeout of at most
120 s and killed on failure.  The children run ``tests/torch_sharding_ranks.py``,
which imports no JAX: the parent computes ``art_tpu``'s threefry blocks.

* (a) The mesh: coordinates ``divmod(rank, n_spp)``, the default
  ``(world, 1)``, the ``ValueError`` of ``art_tpu``'s ``(16, 2)`` case, the
  error of a missing card and of no initialized group, a mesh smaller than
  the world (the other ranks render nothing).
* (b) 2x1 and 1x2 meshes on cornell_smoke and earth (the scenes of
  ``__graft_entry__.dryrun_multichip``) at 32x16 @ 8, depth 10 (as
  ``tests/test_sharding.py``), each shard fed ``art_tpu``'s threefry chain
  ``fold(fold(fold(master, tile, chunk), ip, isp), it)`` through the
  ``divmod`` of its ``(tile', chunk')``, held to ``art_tpu``'s
  ``render_scene_sharded`` on the same mesh shape over the virtual
  8-device CPU mesh at ``tests/test_torch_render.py``'s bars: >= 98% of
  the pixels within 1e-3, rays within 1e-3, ``spp`` and ``mesh`` equal.
* (c) A world of one with the plain twins and Philox is ``render_scene``
  bit for bit, image and rays.
* (d) No two shards draw one stream: every (tile', chunk') of a 2x2 render
  over 2 tiles and 2 chunks is distinct, and a 1x2 render's two ``spp``
  partial sums differ.
* (e) Checkpoint: a 1x2 render interrupted after k of n dispatches and
  resumed is the uninterrupted one bit for bit, running n - k dispatches;
  its ``sig`` is ``art_tpu``'s for the same scene, config and mesh shape; a
  single-device file is not taken by a sharded render, nor the reverse.
* (f) The CLI: ``--sharded --device cpu`` in a world of one, and two ranks
  under a launcher's environment, write the PPM that
  ``render_scene_sharded`` gives; a rank whose partner never joins exits
  nonzero within its timeout."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_sharding_ranks as ranks
from art_tpu.core import rng as artrng
from art_tpu.models import build_scene as jax_build_scene
from art_tpu.parallel import make_mesh as jax_make_mesh
from art_tpu.parallel import render_scene_sharded as jax_render_scene_sharded
from art_tpu.render.renderer import RenderConfig as JaxConfig
from art_tpu_torch import cli
from art_tpu_torch.models import build_scene
from art_tpu_torch.parallel import make_mesh, spawn_ranks
from art_tpu_torch.render.integrator import n_uniform_cols
from art_tpu_torch.render.renderer import RenderConfig, plan_batches, render_scene
from art_tpu_torch.utils.ppm import format_ppm

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JOIN_S = 120  # the most a world of this file may take
NX, NY = 32, 16
CFG = dict(nx=NX, ny=NY, spp=8, max_depth=10)


def _spawn(fn, world, *args):
    return spawn_ranks(fn, world, args, backend="gloo", timeout=JOIN_S)


def test_mesh_layouts():
    out = _spawn(ranks.mesh_layouts, 4)
    for rank, o in enumerate(out):
        assert o["default"] == ({"px": 4, "spp": 1}, (rank, 0))
        assert o[(2, 2)] == divmod(rank, 2)
        assert o[(1, 4)] == (0, rank) and o[(4, 1)] == (rank, 0)
        assert o["oversized"] == "mesh (16, 2) needs 32 devices, have 4"
        assert "cuda" in o["no card"]
    assert [o["small"] for o in out] == [0, 1, None, None]
    assert all("outside the 1x2 mesh" in o["small render"] for o in out[2:])
    np.testing.assert_array_equal(out[0]["small render"], out[1]["small render"])
    assert np.isfinite(out[0]["small render"]).all()


def test_no_group_raises():
    with pytest.raises(RuntimeError, match="no initialized torch.distributed"):
        make_mesh()


def test_failing_and_hanging_ranks_raise():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed"):
        _spawn(ranks.mesh_layouts, 3)  # (2, 2) needs 4 ranks: every rank raises
    with pytest.raises(TimeoutError):
        spawn_ranks(ranks.sleep, 1, (600,), timeout=8)
    assert time.monotonic() - t0 < JOIN_S


def _threefry_blocks(path, name, shape, seed=1984):
    """``art_tpu``'s per-shard blocks for every (tile, chunk, ip, isp, it)
    a render of CFG on ``shape`` may draw, saved to ``path``."""
    n_px, n_spp = shape
    tables = build_scene(name, NX, NY).tables
    cfg = RenderConfig(**CFG)
    n_pixels = NX * NY
    tile_pixels, spp_chunk, R = plan_batches(
        -(-n_pixels // n_px), -(-cfg.spp // n_spp),
        max(tables.n_spheres, tables.n_quads, tables.n_boxes, 1), cfg, "cpu")
    n_tiles = -(-n_pixels // (tile_pixels * n_px))
    n_chunks = max(1, -(-cfg.spp // (spp_chunk * n_spp)))
    n_iters = (tile_pixels * spp_chunk * cfg.max_depth) // R + cfg.max_depth + 2
    master = jax.random.PRNGKey(seed)
    blocks = {}
    for tile in range(n_tiles):
        for chunk in range(n_chunks):
            for ip in range(n_px):
                for isp in range(n_spp):
                    key = artrng.fold(master, tile, chunk, ip, isp)
                    for it in range(n_iters):
                        blocks[ranks.block_key(tile, chunk, ip, isp, it)] = np.asarray(
                            artrng.uniform(artrng.fold(key, it),
                                           (n_uniform_cols(tables), R)))
    np.savez(path, **blocks)


@pytest.mark.parametrize("name", ["cornell_smoke", "earth"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_render_matches_art_tpu(tmp_path, name, shape):
    jfb, jst = jax_render_scene_sharded(jax_build_scene(name, NX, NY), JaxConfig(**CFG),
                                        jax_make_mesh(shape))
    path = str(tmp_path / "blocks.npz")
    _threefry_blocks(path, name, shape)
    out = _spawn(ranks.render, 2, name, NX, NY, CFG, shape, path)
    (fb, st), (fb1, st1) = out
    np.testing.assert_array_equal(fb, fb1)
    assert st["rays"] == st1["rays"]
    assert st["spp"] == jst["spp"] and st["mesh"] == dict(jst["mesh"])
    assert set(jst) <= set(st)
    assert abs(st["rays"] - jst["rays"]) <= 1e-3 * jst["rays"], (st["rays"], jst["rays"])
    close = np.abs(fb - jfb).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.98, close.mean()


@pytest.mark.parametrize("name", ["three_spheres", "cornell_smoke"])
def test_world_of_one_is_render_scene(name):
    [(fb, st)] = _spawn(ranks.render, 1, name, NX, NY, CFG, (1, 1), None, True)
    want, wst = render_scene(build_scene(name, NX, NY), RenderConfig(**CFG), device="cpu",
                             plain=True)
    np.testing.assert_array_equal(fb, want)
    assert st["rays"] == wst["rays"] and st["spp"] == wst["spp"]
    assert st["mesh"] == {"px": 1, "spp": 1} and st["world"] == 1


def test_shards_draw_their_own_streams():
    # 2 tiles of 256 pixels (per device 128) and 2 chunks of 2 x 2 samples
    cfg = dict(nx=NX, ny=NY, spp=8, max_depth=4, max_tile_pixels=128, queue_budget=256)
    out = _spawn(ranks.streams, 4, "three_spheres", NX, NY, cfg)
    pairs = [p for o in out for p in o["pairs"]]
    assert len(pairs) == 16 and len(set(pairs)) == 16
    for o in out:
        ip, isp = o["coords"]
        assert sorted(o["pairs"]) == [(t * 2 + ip, c * 2 + isp) for t in (0, 1)
                                      for c in (0, 1)]
    a, b = out[0]["partial"], out[1]["partial"]
    assert len(a) == len(b) == 8 and out[0]["spp"] == 8  # 4 tiles x 2 chunks
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.abs(x - y).max() > 0.1
    np.testing.assert_array_equal(out[0]["fb"], out[1]["fb"])


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_checkpoint_resume(tmp_path, k):
    # 576 pixels, one tile; 3 chunks of 1 x 2 samples
    cfg = dict(nx=32, ny=18, spp=6, max_depth=6, queue_budget=1024)
    out = _spawn(ranks.checkpoint, 2, "three_spheres", 32, 18, cfg, str(tmp_path), k)
    for o in out:
        assert o["stopped"] and o["first"] == k and o["second"] == 3 - k
        (fb, st), (want, wst) = o["resumed"], o["full"]
        np.testing.assert_array_equal(fb, want)
        assert st["rays"] == wst["rays"] and st["spp"] == 6
        assert o["from_single_calls"] == 3
        np.testing.assert_array_equal(o["from_single"], want)
    assert out[0]["single_calls"] == 6  # render_scene: 6 chunks of 1 sample
    np.testing.assert_array_equal(
        out[0]["single_fb"],
        render_scene(build_scene("three_spheres", 32, 18), RenderConfig(**cfg),
                     device="cpu")[0])


def test_sharded_sig_is_art_tpus(tmp_path):
    cfg = dict(nx=16, ny=8, spp=4, max_depth=3, queue_budget=128)
    jax_render_scene_sharded(jax_build_scene("three_spheres", 16, 8), JaxConfig(**cfg),
                             jax_make_mesh((1, 2)), checkpoint_path=str(tmp_path / "jax"))
    _spawn(ranks.checkpoint, 2, "three_spheres", 16, 8, cfg, str(tmp_path), 1)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "sharded.npz")
    np.testing.assert_array_equal(got["sig"], want["sig"])
    assert len(got["sig"]) == 10 and int(got["done"]) == int(want["done"])
    assert str(want["scene"]).split(":")[0] == str(got["scene"]).split(":")[0]
    assert str(want["scene"]) != str(got["scene"])  # each package's own digest


ARGS = ["--scene", "three_spheres", "--nx", "32", "--ny", "16", "--spp", "4",
        "--max-depth", "10", "--device", "cpu"]


def test_cli_sharded_world_of_one(tmp_path):
    assert cli.main(ARGS + ["--sharded", "--out", str(tmp_path / "s.ppm")]) == 0
    assert cli.main(ARGS + ["--out", str(tmp_path / "p.ppm")]) == 0
    text = (tmp_path / "s.ppm").read_text()
    assert text.startswith("P3\n32 16\n") and text == (tmp_path / "p.ppm").read_text()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(n_started, world, out_dir, timeout_s=None):
    """``n_started`` of a ``world``-rank launcher's processes of the CLI, with
    ``sharding.TIMEOUT_S`` set to ``timeout_s`` seconds where given."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port), WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    cli_main = ["-m", "art_tpu_torch.cli"] if timeout_s is None else [
        "-c", "import sys; from art_tpu_torch import cli; from art_tpu_torch.parallel "
        f"import sharding; sharding.TIMEOUT_S = {timeout_s}; "
        "raise SystemExit(cli.main(sys.argv[1:]))"]
    procs = [subprocess.Popen(
        [sys.executable, *cli_main, *ARGS, "--sharded",
         "--out", str(out_dir / f"rank{r}.ppm")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=out_dir,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_started)]
    try:
        return [(p.wait(timeout=JOIN_S), p.stderr.read()) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_cli_sharded_two_launched_ranks(tmp_path):
    codes = _launch(2, 2, tmp_path)
    assert [c for c, _ in codes] == [0, 0], codes
    assert (tmp_path / "rank0.ppm").exists() and not (tmp_path / "rank1.ppm").exists()
    cfg = dict(nx=32, ny=16, spp=4, max_depth=10)
    (fb, st), _ = _spawn(ranks.render, 2, "three_spheres", 32, 16, cfg, (2, 1))
    assert st["mesh"] == {"px": 2, "spp": 1}
    assert (tmp_path / "rank0.ppm").read_text() == format_ppm(fb)


def test_cli_rank_that_never_meets_its_partner_fails(tmp_path):
    t0 = time.monotonic()
    [(code, err)] = _launch(1, 2, tmp_path, timeout_s=5)
    assert code != 0 and time.monotonic() - t0 < JOIN_S
    assert not (tmp_path / "rank0.ppm").exists()
    assert "Error" in err, err[-2000:]
