"""Image textures and the rest of M10 against art_tpu, on the CPU.

* The decoded copies under ``art_tpu_torch/assets/textures/`` equal
  art_tpu's PIL decode of each scene asset (``scripts/decode_textures.py``
  writes them); any other file raises.
* ``ImageAtlas.pack`` equals art_tpu's fields (texels as int32), and
  ``sample`` is bit-equal to art_tpu's on random, edge (0 and 1) and
  out-of-range (u, v) — by the dense gather, and by the compacted fetch
  (K4 and K8's twins) on the needy lanes, 0 on the others.
* The builder dedups images by asset name and by array identity, as
  art_tpu does.
* A sphere's (u, v) (``sphere_uv``, computed from the K2 twin's normal)
  matches art_tpu's ``closest_surface_p`` within 4 ulp of 0.5 (2^-24, the
  last bit of u in [0.5, 1)), absolute: ``acos`` and ``atan2`` in XLA's CPU
  build and in ATen differ in the last ulp (measured on these rays: the
  normals equal; of 6387 hits, u differs on 436 and v on 970, by at most
  2^-23; no texel index differs).  Absolute, not
  relative: ``u = (atan2 + pi) / 2 pi`` near 0 keeps the absolute error of
  a last-ulp ``atan2`` of about pi, 81 ulp of a u of 0.0047.  So the
  nearest texel is equal except on lanes whose u or v lies within 1e-5 of a
  texel edge; those are counted and bounded at 0.1% of the hits.
* ``eval_texture_p`` and ``eval_special_p`` on a scene with image,
  uv_offset, felt, noodle, noise, checker and solid textures: image leaves
  exact (both sides get the same (u, v) here, so the texel index is equal),
  felt and noodle within 1e-5 (turbulence and noise sum octaves of
  transcendental-free float32 math, equal in practice), at R = 4096 from a
  numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from art_tpu.ops.intersect import closest_surface_p as jax_closest
from art_tpu.ops.texture_eval import eval_special_p as jax_special
from art_tpu.ops.texture_eval import eval_texture_p as jax_texture
from art_tpu.scene import builder as jax_builder
from art_tpu.scene import materials as JM
from art_tpu.scene import objects as JO
from art_tpu.scene import textures as JX
from art_tpu.utils import images as jimages
from art_tpu.models import build_scene as jax_build_scene
from art_tpu_torch.core.vecmath import T_MIN
from art_tpu_torch.models import build_scene
from art_tpu_torch.ops.intersect import closest_surface_p
from art_tpu_torch.ops.texture_eval import eval_special_p, eval_texture_p
from art_tpu_torch.scene import builder as port_builder
from art_tpu_torch.scene import materials as PM
from art_tpu_torch.scene import objects as PO
from art_tpu_torch.scene import textures as PX
from art_tpu_torch.utils import images

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

ASSETS = ("earthmap.jpg", "poolball.jpg", "8ball.jpg")
ULP_HALF = 2.0 ** -24  # one ulp of float32 values in [0.5, 1)


def _atlas_fields(atlas):
    return (np.asarray(atlas.data).astype(np.int64), np.asarray(atlas.heights),
            np.asarray(atlas.widths), atlas.hmax, atlas.wmax)


def _assert_atlas_equal(port, jax_atlas):
    got, want = _atlas_fields(port), _atlas_fields(jax_atlas)
    assert port.data.dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ASSETS)
def test_decoded_copy_equals_art_tpu_decode(name):
    got = images.load_image_rgb(images.asset_path(name))
    want = jimages.load_image_rgb(jimages.asset_path(name))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_load_image_rgb_reads_only_decoded_copies(tmp_path):
    with pytest.raises(FileNotFoundError, match="decode_textures.py"):
        images.load_image_rgb(jimages.asset_path("earthmap.jpg"))
    bad = tmp_path / "bad.npz"
    np.savez(bad, rgb=np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        images.load_image_rgb(bad)


def _random_images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((7, 13), (16, 5), (1, 1), (9, 9))]


def test_pack_matches_art_tpu():
    ims = _random_images(0) + [images.load_image_rgb(images.asset_path("poolball.jpg"))]
    _assert_atlas_equal(images.ImageAtlas.pack(ims), jimages.ImageAtlas.pack(ims))
    _assert_atlas_equal(images.ImageAtlas.pack([]), jimages.ImageAtlas.empty())


def test_pack_keeps_the_int32_index_limit():
    class Big:  # only the shape is read before the limit check
        shape = (1 << 16, 1 << 15, 3)

    with pytest.raises(ValueError, match="int32"):
        images.ImageAtlas.pack([Big()])
    with pytest.raises(ValueError, match="2\\^24"):
        images.ImageAtlas.from_numpy(np.array([1 << 24]), [1], [1], 1, 1)


def _uv_cases(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    edges = np.array([0.0, 1.0, 0.5, np.nextafter(np.float32(1), np.float32(0))],
                     np.float32)
    u[:16], v[:16] = np.repeat(edges, 4), np.tile(edges, 4)
    u[16:32] = rng.uniform(-3, 4, 16)  # out of range: clamped
    v[32:48] = rng.uniform(-3, 4, 16)
    return u, v


def test_sample_bit_equal_to_art_tpu():
    ims = _random_images(1)
    port, jat = images.ImageAtlas.pack(ims), jimages.ImageAtlas.pack(ims)
    n = 4096
    u, v = _uv_cases(n, 2)
    rng = np.random.default_rng(3)
    img = rng.integers(-2, len(ims) + 2, n).astype(np.int32)  # out-of-range ids clamp
    want = np.asarray(jat.sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    ti, tu, tv = map(torch.from_numpy, (img, u, v))
    dense = port.sample(ti, tu, tv).numpy()
    np.testing.assert_array_equal(dense, want)
    needy = rng.random(n) < 0.4
    compact = port.sample(ti, tu, tv, torch.from_numpy(needy)).numpy()
    np.testing.assert_array_equal(compact[needy], want[needy])
    assert not compact[~needy].any()


def _dedup_scene(b_mod, O, M, X, arr, twin):
    b = b_mod.SceneBuilder().add(
        O.Sphere((0, 0, 0), 1.0, M.Lambertian(X.ImageTexture("poolball.jpg"))),
        O.Sphere((2, 0, 0), 1.0, M.Lambertian(X.ImageTexture("poolball.jpg"))),
        O.Sphere((4, 0, 0), 1.0, M.Lambertian(X.ImageTexture(arr))),
        O.Sphere((6, 0, 0), 1.0, M.DiffuseLight(X.ImageTexture(arr))),
        O.Sphere((8, 0, 0), 1.0, M.Lambertian(X.ImageTexture(twin))),
    )
    b.set_camera(lookfrom=(0, 0, 9), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=1.0)
    return b.compile()


def test_images_dedup_by_name_and_identity():
    """One atlas entry per asset name and per array object: an equal array
    that is another object gets its own entry."""
    arr = _random_images(4)[0]
    twin = arr.copy()
    port = _dedup_scene(port_builder, PO, PM, PX, arr, twin).tables
    jax = _dedup_scene(jax_builder, JO, JM, JX, arr, twin).tables
    assert port.atlas.heights.shape == (3,)
    _assert_atlas_equal(port.atlas, jax.atlas)
    np.testing.assert_array_equal(port.tex_img.numpy(), np.asarray(jax.tex_img))


def _sphere_rays(n, seed, radius=2.0):
    """Rays from a shell around the earth sphere towards points near it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o = o / np.linalg.norm(o, axis=0) * rng.uniform(4.0, 12.0, n)
    target = rng.uniform(-radius, radius, (3, n))
    return o.astype(np.float32), (target - o).astype(np.float32)


def test_sphere_uv_matches_art_tpu():
    n = 8192
    o, d = _sphere_rays(n, 5)
    tm = np.zeros(n, np.float32)
    jt, pt = jax_build_scene("earth", 64, 32).tables, build_scene("earth", 64, 32).tables
    want = jax_closest(jt, tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
                       jnp.asarray(tm), T_MIN)
    got = closest_surface_p(pt, tuple(map(torch.from_numpy, o)),
                            tuple(map(torch.from_numpy, d)), torch.from_numpy(tm), T_MIN)
    hit = got.hit.numpy() & np.asarray(want.hit)
    assert (got.hit.numpy() != np.asarray(want.hit)).sum() <= 2  # knife-edge grazes
    assert hit.mean() > 0.3
    for a, b in ((got.u, want.u), (got.v, want.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=0,
                                   atol=4 * ULP_HALF)
    # the nearest texel: equal but within 1e-5 of a texel edge
    atlas = pt.atlas
    w, h = int(atlas.widths[0]), int(atlas.heights[0])
    zero = torch.zeros(n, dtype=torch.int32)
    flat = atlas.texel_index(zero, got.u, got.v).numpy()[hit]
    jflat = atlas.texel_index(zero, torch.from_numpy(np.array(want.u)),
                              torch.from_numpy(np.array(want.v))).numpy()[hit]
    u, v = np.asarray(want.u, np.float64)[hit], np.asarray(want.v, np.float64)[hit]
    edge = (np.abs(u * w - np.round(u * w)) / w < 1e-5) | (
        np.abs(v * h - np.round(v * h)) / h < 1e-5)
    differ = flat != jflat
    assert not (differ & ~edge).any()
    assert differ.sum() <= 1e-3 * hit.sum(), (int(differ.sum()), int(hit.sum()))


def _texture_scene(b_mod, O, M, X, arr):
    """Every texture kind, each behind its own material: 7 materials, so
    the scene bakes with image, felt, noodle and noise special leaves."""
    b = b_mod.SceneBuilder().add(
        O.Sphere((0, -1000, 0), 1000.0, M.Lambertian(X.FeltTexture())),
        O.Sphere((0, 1, 0), 1.0, M.Lambertian(X.ImageTexture(arr))),
        O.Sphere((2, 1, 0), 1.0, M.Lambertian(X.UVOffset(X.ImageTexture("poolball.jpg"),
                                                         60.0 / 360.0, 0.1))),
        O.Sphere((4, 1, 0), 1.0, M.Lambertian(X.NoodleTexture(0.2, octaves=5))),
        O.Sphere((6, 1, 0), 1.0, M.Lambertian(X.NoiseTexture(4.0))),
        O.Sphere((8, 1, 0), 1.0, M.Lambertian(X.Checker(
            0.5, X.SolidColor((0.2, 0.3, 0.1)), X.SolidColor((0.9, 0.9, 0.9))))),
        O.Sphere((10, 1, 0), 1.0, M.DiffuseLight((4, 4, 4))),
    )
    b.set_camera(lookfrom=(0, 3, 20), lookat=(4, 1, 0), vup=(0, 1, 0),
                 vfov_degrees=40.0, aspect=2.0)
    return b.compile()


def texture_scenes():
    """The every-texture scene in both packages."""
    arr = _random_images(6)[1]
    return (_texture_scene(jax_builder, JO, JM, JX, arr),
            _texture_scene(port_builder, PO, PM, PX, arr))


def _texture_inputs(n, seed):
    rng = np.random.default_rng(seed)
    u, v = _uv_cases(n, seed)
    p = (rng.uniform(-12, 12, (3, n))).astype(np.float32)
    return u, v, p, rng


def _compare_leaves(got, want, exact):
    for c in range(3):
        g, w = got[c].numpy(), np.asarray(want[c])
        np.testing.assert_array_equal(g[exact], w[exact])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_eval_texture_matches_art_tpu():
    jscene, scene = texture_scenes()
    jt, pt = jscene.tables, scene.tables
    assert set(pt.tex_types_present) == set(range(7))
    n = 4096
    u, v, p, rng = _texture_inputs(n, 7)
    tex_id = rng.integers(0, pt.tex_type.shape[0], n).astype(np.int32)
    want = jax_texture(jt, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v),
                       tuple(map(jnp.asarray, p)))
    got = eval_texture_p(pt, torch.from_numpy(tex_id), torch.from_numpy(u),
                         torch.from_numpy(v), tuple(map(torch.from_numpy, p)))
    leaf = pt.tex_type.numpy()[tex_id]
    kinds = {int(k) for k in leaf}
    assert {2, 5, 6, 3, 4} <= kinds  # image, uv_offset, felt, noise, noodle
    exact = np.isin(leaf, (0, 1, 2, 6))  # solid, checker, image, uv_offset -> image
    _compare_leaves(got, want, exact)
    # a valid mask: image lanes outside it read 0, every other lane is as before
    valid = rng.random(n) < 0.5
    gated = eval_texture_p(pt, torch.from_numpy(tex_id), torch.from_numpy(u),
                           torch.from_numpy(v), tuple(map(torch.from_numpy, p)),
                           valid=torch.from_numpy(valid))
    img = np.isin(leaf, (2, 6))
    for c in range(3):
        g = gated[c].numpy()
        np.testing.assert_array_equal(g[~img | valid], got[c].numpy()[~img | valid])
        assert not g[img & ~valid].any()


def test_eval_special_matches_art_tpu():
    jscene, scene = texture_scenes()
    jt, pt = jscene.tables, scene.tables
    specials = pt.shade_consts[1]
    assert specials == jt.shade_consts[1]
    assert [s[1] for s in specials] == ["felt", "image", "image", "noodle", "noise"]
    n = 4096
    u, v, p, rng = _texture_inputs(n, 8)
    mat = rng.integers(0, len(pt.shade_consts[0]), n).astype(np.int32)
    valid = rng.random(n) < 0.8
    want = jax_special(jt, jt.shade_consts[1], jnp.asarray(mat), jnp.asarray(u),
                       jnp.asarray(v), tuple(map(jnp.asarray, p)), valid=jnp.asarray(valid))
    got = eval_special_p(pt, specials, torch.from_numpy(mat), torch.from_numpy(u),
                         torch.from_numpy(v), tuple(map(torch.from_numpy, p)),
                         valid=torch.from_numpy(valid))
    image_mats = [s[0] for s in specials if s[1] == "image"]
    exact = ~np.isin(mat, [s[0] for s in specials]) | np.isin(mat, image_mats)
    _compare_leaves(got, want, exact)
    for c in range(3):
        assert got[c].numpy()[np.isin(mat, image_mats) & valid].any()
