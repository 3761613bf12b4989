"""Checkpoint and resume of ``art_tpu_torch.render.renderer.render_scene``
(``checkpoint_path``, the CLI's ``--checkpoint``), on the CPU with the plain
twins.

* (a) A render interrupted after k of its n (tile, chunk) dispatches (a
  patched ``render_wavefront`` raises) and resumed gives the uninterrupted
  image and ray count bit for bit, the resumed run calling
  ``render_wavefront`` n - k times.
* (b) A completed checkpoint resumes as a no-op with the same image.
* (c) The file is ignored (a fresh render, n calls) for another spp,
  another scene, the same scene with its camera moved, a truncated zip, and
  a file with ``art_tpu``'s keys but a foreign scene string.
* (d) A path without an extension round-trips as ``<path>.npz``; no
  ``.tmp`` file is left.
* (e) ``scene_digest`` is the same for the scene's tables on any device
  copy and changes with the camera.
* (f) The saved ``sig`` equals the one ``art_tpu``'s ``render_scene`` saves
  for the same scene and config.
* (g) ``--checkpoint`` through the CLI twice gives the same PPM."""

import dataclasses

import numpy as np
import pytest
import torch

from art_tpu_torch import cli
from art_tpu_torch.models import build_scene
from art_tpu_torch.render import renderer
from art_tpu_torch.render.renderer import RenderConfig, render_scene, scene_digest

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

NX, NY = 32, 18
# 576 pixels, one tile; a queue budget of 1024 makes one sample a chunk
CFG = RenderConfig(nx=NX, ny=NY, spp=6, max_depth=6, queue_budget=1024)
N_DISPATCHES = 6


class Stop(Exception):
    pass


@pytest.fixture(scope="module")
def scene():
    return build_scene("three_spheres", NX, NY)


@pytest.fixture(scope="module")
def full(scene):
    return render_scene(scene, CFG, device="cpu")


@pytest.fixture
def calls(monkeypatch):
    """The dispatches render_wavefront runs; ``calls.stop_after = k`` makes
    the (k + 1)-th raise."""
    wrapped = renderer.render_wavefront

    class Calls:
        n = 0
        stop_after = None

    def counting(*a, **kw):
        if Calls.stop_after is not None and Calls.n >= Calls.stop_after:
            raise Stop()
        Calls.n += 1
        return wrapped(*a, **kw)

    monkeypatch.setattr(renderer, "render_wavefront", counting)
    return Calls


@pytest.mark.parametrize("k", [1, 3, 5])
def test_resume_is_the_uninterrupted_render(scene, full, calls, tmp_path, k):
    ckpt = str(tmp_path / "ck.npz")
    calls.stop_after = k
    with pytest.raises(Stop):
        render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    assert calls.n == k and int(np.load(ckpt)["done"]) == k - 1
    calls.n, calls.stop_after = 0, None
    fb, st = render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    assert calls.n == N_DISPATCHES - k
    np.testing.assert_array_equal(fb, full[0])
    assert st["rays"] == full[1]["rays"] and st["spp"] == CFG.spp


def test_completed_checkpoint_is_a_no_op(scene, full, calls, tmp_path, capsys):
    ckpt = str(tmp_path / "done.npz")
    fb, _ = render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    assert calls.n == N_DISPATCHES
    np.testing.assert_array_equal(fb, full[0])
    calls.n = 0
    fb, st = render_scene(scene, CFG, verbose=True, checkpoint_path=ckpt, device="cpu")
    assert calls.n == 0 and st["iterations"] == 0 and st["rays"] == full[1]["rays"]
    np.testing.assert_array_equal(fb, full[0])
    assert f"resuming from checkpoint: {N_DISPATCHES} dispatches done" in capsys.readouterr().err


def _moved_camera(scene):
    cam = scene.camera
    return dataclasses.replace(scene, camera=dataclasses.replace(
        cam, origin=cam.origin + np.float32(0.25)))


def _truncated(scene, path):
    with open(path, "wb") as fh:
        fh.write(b"PK\x03\x04 not a whole zip")


def _foreign(scene, path):
    """art_tpu's keys with a matching sig but another scene string."""
    ck = np.load(path)
    np.savez(path, sig=ck["sig"], scene=f"{scene.name}:0123456789abcdef", fb=ck["fb"] * 7,
             done=ck["done"], rays=ck["rays"])


CASES = {
    "another spp": (dict(spp=4), None),
    "another scene": ({}, lambda s: build_scene("quads", NX, NY)),
    "the camera moved": ({}, _moved_camera),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mismatched_checkpoint_is_ignored(scene, calls, tmp_path, case):
    ckpt = str(tmp_path / "ck.npz")
    render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    change, other = CASES[case]
    cfg = dataclasses.replace(CFG, **change)
    target = other(scene) if other else scene
    want, _ = render_scene(target, cfg, device="cpu")
    calls.n = 0
    got, _ = render_scene(target, cfg, checkpoint_path=ckpt, device="cpu")
    assert calls.n > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spoil", [_truncated, _foreign])
def test_spoiled_checkpoint_is_ignored(scene, full, calls, tmp_path, spoil):
    ckpt = str(tmp_path / "ck.npz")
    render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    spoil(scene, ckpt)
    calls.n = 0
    got, st = render_scene(scene, CFG, checkpoint_path=ckpt, device="cpu")
    assert calls.n == N_DISPATCHES
    np.testing.assert_array_equal(got, full[0])
    assert st["rays"] == full[1]["rays"]


def test_extensionless_path_round_trips(scene, full, calls, tmp_path):
    ckpt = tmp_path / "ck"
    render_scene(scene, CFG, checkpoint_path=str(ckpt), device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    calls.n = 0
    fb, _ = render_scene(scene, CFG, checkpoint_path=str(ckpt), device="cpu")
    assert calls.n == 0
    np.testing.assert_array_equal(fb, full[0])
    ck = np.load(tmp_path / "ck.npz")
    assert sorted(ck.files) == ["done", "fb", "rays", "scene", "sig"]
    assert str(ck["scene"]) == f"three_spheres:{scene_digest(scene)}"


def test_digest_is_the_scene_on_any_copy(scene):
    copy = dataclasses.replace(scene, tables=scene.tables.to("cpu"))
    cloned = dataclasses.replace(scene, tables=dataclasses.replace(scene.tables, **{
        f.name: getattr(scene.tables, f.name).clone()
        for f in dataclasses.fields(scene.tables)
        if isinstance(getattr(scene.tables, f.name), torch.Tensor)}))
    digest = scene_digest(scene)
    assert len(digest) == 16 and scene_digest(copy) == digest == scene_digest(cloned)
    assert scene_digest(_moved_camera(scene)) != digest
    assert scene_digest(dataclasses.replace(scene, gradient_bg=not scene.gradient_bg)) != digest


def test_sig_is_art_tpus(tmp_path):
    """One tiny render through each package's render_scene on the CPU."""
    from art_tpu.models import build_scene as jax_build_scene
    from art_tpu.render.renderer import RenderConfig as JaxConfig
    from art_tpu.render.renderer import render_scene as jax_render_scene

    cfg = dict(nx=16, ny=8, spp=2, max_depth=3, queue_budget=128)
    jax_render_scene(jax_build_scene("three_spheres", 16, 8), JaxConfig(**cfg),
                     checkpoint_path=str(tmp_path / "jax.npz"))
    render_scene(build_scene("three_spheres", 16, 8), RenderConfig(**cfg),
                 checkpoint_path=str(tmp_path / "torch.npz"), device="cpu")
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    np.testing.assert_array_equal(got["sig"], want["sig"])
    assert int(got["done"]) == int(want["done"]) >= 1
    assert str(want["scene"]).split(":")[0] == str(got["scene"]).split(":")[0]
    assert str(want["scene"]) != str(got["scene"])  # each package's own digest


def test_cli_checkpoint_twice_gives_the_same_ppm(tmp_path):
    args = ["--scene", "three_spheres", "--nx", "16", "--ny", "8", "--spp", "2",
            "--max-depth", "4", "--device", "cpu", "--checkpoint", str(tmp_path / "cli")]
    assert cli.main(args + ["--out", str(tmp_path / "a.ppm")]) == 0
    assert (tmp_path / "cli.npz").exists()
    assert cli.main(args + ["--out", str(tmp_path / "b.ppm")]) == 0
    a, b = (tmp_path / "a.ppm").read_text(), (tmp_path / "b.ppm").read_text()
    assert a == b and a.startswith("P3")
    assert int(np.load(tmp_path / "cli.npz")["done"]) == 0
