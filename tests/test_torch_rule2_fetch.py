"""K8's fetch form (``ops/flush_kernel.py atlas_fetch``, ``csrc/table_gather.cu
art_atlas_fetch``: the image texel fetch — texel index, texel and unpack — in
one launch) held on the CPU on numpy-seeded inputs, bit for bit.

* (a) Its twin ``atlas_fetch_plain`` equals the compacted pipeline that
  ``ImageAtlas.sample(..., needy)`` ran before it — ``texel_index``,
  ``compact_gather(..., plain=True)`` (K4's and K8's twins), the unpack — on
  every lane, in float32 bits: 0, 1, 30% and every lane needy, an odd R, image
  ids out of range, u and v outside [0, 1], exactly on texel edges, and NaN.
* (b) It equals art_tpu's ``ImageAtlas.sample`` on the needy lanes — its dense
  form, and with ``needy=`` in interpret mode at needy counts that take its
  compact and its wide tier — and is +0.0 on the other lanes.
* (c) ``eval_special_p`` (an image behind a folded uv offset among felt,
  noodle and noise) and ``eval_texture_p`` equal art_tpu's on the lanes they
  did before; ``eval_special_p``'s image leaf, now the fetch's planes as they
  are, equals ``p_where(needy, planes, 0)`` in bits; ``sample`` with a needy
  mask makes one ``atlas_fetch`` call and no ``compact_gather`` call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import art_tpu.ops.compact_fetch as jcf
from art_tpu.ops.texture_eval import eval_special_p as jax_special
from art_tpu.ops.texture_eval import eval_texture_p as jax_texture
from art_tpu.utils import images as jimages
from art_tpu_torch.core.vecmath import p_where
from art_tpu_torch.ops import compact_fetch as cf
from art_tpu_torch.ops import flush_kernel as fk
from art_tpu_torch.ops.texture_eval import eval_special_p, eval_texture_p
from art_tpu_torch.utils import images
from test_torch_images import _compare_leaves, _random_images, _texture_inputs, texture_scenes

# the test workers share the cores: one intra-op thread per worker
torch.set_num_threads(1)

R_ODD = 4099
R_TIERS = 8192  # one TPU flush block, as tests/test_torch_compact_fetch.py


def _atlases():
    ims = _random_images(11) + [images.load_image_rgb(images.asset_path("poolball.jpg"))]
    return images.ImageAtlas.pack(ims), jimages.ImageAtlas.pack(ims)


_ATLASES = _atlases()  # (port, art_tpu): four random images and the pool ball


def _inputs(atlas, n, seed, nan=False):
    """(img, u, v) of n lanes: random (u, v), texel edges of each lane's own
    image (u = i / w, v = j / h exactly, 0 and 1 among them), values outside
    [0, 1] and ids outside [0, n_images); with ``nan`` also NaN and inf."""
    rng = np.random.default_rng(seed)
    n_img = atlas.heights.shape[0]
    img = rng.integers(0, n_img, n).astype(np.int32)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    w = atlas.widths.numpy()[img].astype(np.float32)
    h = atlas.heights.numpy()[img].astype(np.float32)
    edge = slice(0, n // 4)
    u[edge] = np.floor(rng.random(n // 4) * (w[edge] + 1)).astype(np.float32) / w[edge]
    v[edge] = np.floor(rng.random(n // 4) * (h[edge] + 1)).astype(np.float32) / h[edge]
    k = n // 4
    u[k:k + 64] = rng.uniform(-3, 4, 64)
    v[k + 64:k + 128] = rng.uniform(-3, 4, 64)
    u[k + 128:k + 136] = (0.0, -0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)),
                          np.nextafter(np.float32(0), np.float32(1)), -1e-30, 1e30, -1e30)
    img[k + 136:k + 200] = rng.integers(-(1 << 20), 1 << 20, 64)  # mostly out of range
    if nan:
        u[k + 200:k + 216] = np.nan
        v[k + 216:k + 232] = np.nan
        u[k + 232:k + 236] = (np.inf, -np.inf, np.inf, -np.inf)
        v[k + 232:k + 236] = (np.inf, np.inf, -np.inf, -np.inf)
    return img, u, v


def _needy(rng, n, share):
    if share == "one":
        needy = np.zeros(n, bool)
        needy[rng.integers(n)] = True
        return needy
    return rng.random(n) < share


def _parent_sample(atlas, img, u, v, needy):
    """``ImageAtlas.sample(..., needy, plain=True)`` before the fetch form:
    the texel index, the compacted fetch's twins, the unpack, (R, 3)."""
    flat = atlas.texel_index(img, u, v)
    px = cf.compact_gather(atlas.data, flat, needy, plain=True)
    return torch.stack([((px >> s) & 0xFF).to(torch.float32) * fk.UNPACK_SCALE
                        for s in (0, 8, 16)], dim=-1)


def _fields(atlas):
    """The fetch's atlas arguments: data, widths, heights, hmax, wmax."""
    return atlas.data, atlas.widths, atlas.heights, atlas.hmax, atlas.wmax


def _bits(x):
    return x.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("share", [0.0, "one", 0.3, 1.0])
def test_twin_bit_equal_to_the_compacted_pipeline(share):
    atlas = _ATLASES[0]
    img, u, v = map(torch.from_numpy, _inputs(atlas, R_ODD, 1, nan=True))
    needy = torch.from_numpy(_needy(np.random.default_rng(2), R_ODD, share))
    got = fk.atlas_fetch_plain(*_fields(atlas), img, u, v, needy)
    assert got.shape == (3, R_ODD) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got.T), _bits(_parent_sample(atlas, img, u, v, needy)))
    assert not _bits(got)[:, ~needy.numpy()].any()  # +0.0 off the needy lanes
    # the wrapper on CPU tensors is the twin; sample returns its transpose
    np.testing.assert_array_equal(_bits(fk.atlas_fetch(*_fields(atlas), img, u, v, needy)),
                                  _bits(got))
    np.testing.assert_array_equal(_bits(atlas.sample(img, u, v, needy)), _bits(got.T))


def test_twin_matches_art_tpu_dense_sample():
    atlas, jat = _ATLASES
    n = 4096
    img, u, v = _inputs(atlas, n, 3)
    needy = np.random.default_rng(4).random(n) < 0.4
    want = np.asarray(jat.sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    lanes = map(torch.from_numpy, (img, u, v, needy))
    got = fk.atlas_fetch_plain(*_fields(atlas), *lanes).T.numpy()
    np.testing.assert_array_equal(got[needy], want[needy])
    assert not got[~needy].any() and want[needy].any()
    # the dense form of the port's sample is art_tpu's on every lane
    dense = atlas.sample(*map(torch.from_numpy, (img, u, v))).numpy()
    np.testing.assert_array_equal(dense, want)


@functools.lru_cache(maxsize=None)
def _jax_needy_sample():
    """art_tpu's ``sample(..., needy=)`` on ``_ATLASES``' atlas with its
    Pallas kernels in interpret mode, traced once (FETCH_K and WFETCH_K
    patched by the first caller)."""
    jat = _ATLASES[1]
    return jax.jit(lambda img, u, v, needy: jat.sample(img, u, v, needy=needy,
                                                       interpret=True))


@pytest.mark.parametrize("count", [700, 1800])  # art_tpu's compact tier, its wide tier
def test_twin_matches_art_tpu_needy_sample(monkeypatch, count):
    monkeypatch.setattr(jcf, "FETCH_K", 1024)
    monkeypatch.setattr(jcf, "WFETCH_K", 2048)
    atlas = _ATLASES[0]
    img, u, v = _inputs(atlas, R_TIERS, 5 + count)
    needy = np.zeros(R_TIERS, bool)
    needy[np.random.default_rng(count).choice(R_TIERS, count, replace=False)] = True
    want = np.asarray(_jax_needy_sample()(*map(jnp.asarray, (img, u, v, needy))))
    lanes = map(torch.from_numpy, (img, u, v, needy))
    got = fk.atlas_fetch_plain(*_fields(atlas), *lanes).T.numpy()
    np.testing.assert_array_equal(got[needy], want[needy])
    assert not got[~needy].any() and not want[~needy].any()


def _count_calls(monkeypatch):
    calls = []
    fetch = fk.atlas_fetch

    def counted(*args):
        calls.append(args[0])
        return fetch(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("compact_gather is no render route's fetch")

    monkeypatch.setattr(fk, "atlas_fetch", counted)
    monkeypatch.setattr(cf, "compact_gather", refuse)
    return calls


def test_eval_special_matches_art_tpu_with_one_fetch(monkeypatch):
    jscene, scene = texture_scenes()
    jt, pt = jscene.tables, scene.tables
    specials = pt.shade_consts[1]
    assert [s[1] for s in specials] == ["felt", "image", "image", "noodle", "noise"]
    assert any(s[1] == "image" and (s[3] or s[4]) for s in specials)  # a folded uv offset
    n = 4096
    u, v, p, rng = _texture_inputs(n, 12)
    mat = rng.integers(0, len(pt.shade_consts[0]), n).astype(np.int32)
    valid = rng.random(n) < 0.8
    want = jax_special(jt, jt.shade_consts[1], jnp.asarray(mat), jnp.asarray(u),
                       jnp.asarray(v), tuple(map(jnp.asarray, p)), valid=jnp.asarray(valid))
    calls = _count_calls(monkeypatch)
    args = (torch.from_numpy(mat), torch.from_numpy(u), torch.from_numpy(v),
            tuple(map(torch.from_numpy, p)))
    got = eval_special_p(pt, specials, *args, valid=torch.from_numpy(valid))
    assert len(calls) == 1 and calls[0] is pt.atlas.data
    image_mats = [s[0] for s in specials if s[1] == "image"]
    exact = ~np.isin(mat, [s[0] for s in specials]) | np.isin(mat, image_mats)
    _compare_leaves(got, want, exact)
    assert all(c.is_contiguous() for c in got)
    # the image leaf alone: the fetch's planes equal p_where(needy, planes, 0)
    imgs = tuple(s for s in specials if s[1] == "image")
    leaf = eval_special_p(pt, imgs, *args, valid=torch.from_numpy(valid))
    needy = torch.from_numpy(np.isin(mat, image_mats) & valid)
    zero = torch.zeros(n)
    masked = p_where(needy, leaf, (zero, zero, zero))
    for a, b in zip(leaf, masked):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert any(bool(c[needy].any()) for c in leaf)


def test_eval_texture_matches_art_tpu_with_one_fetch(monkeypatch):
    jscene, scene = texture_scenes()
    jt, pt = jscene.tables, scene.tables
    n = 4096
    u, v, p, rng = _texture_inputs(n, 13)
    tex_id = rng.integers(0, pt.tex_type.shape[0], n).astype(np.int32)
    valid = rng.random(n) < 0.7
    want = jax_texture(jt, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v),
                       tuple(map(jnp.asarray, p)))
    calls = _count_calls(monkeypatch)
    args = (pt, torch.from_numpy(tex_id), torch.from_numpy(u), torch.from_numpy(v),
            tuple(map(torch.from_numpy, p)))
    got = eval_texture_p(*args)
    gated = eval_texture_p(*args, valid=torch.from_numpy(valid))
    assert len(calls) == 2
    leaf = pt.tex_type.numpy()[tex_id]
    exact = np.isin(leaf, (0, 1, 2, 6))  # solid, checker, image, uv_offset -> image
    _compare_leaves(got, want, exact)
    img = np.isin(leaf, (2, 6))
    keep = ~img | valid
    for c in range(3):
        np.testing.assert_array_equal(gated[c].numpy()[keep], got[c].numpy()[keep])
        assert not gated[c].numpy()[img & ~valid].any()


def test_sample_makes_one_fetch_call(monkeypatch):
    atlas = _ATLASES[0]
    img, u, v = map(torch.from_numpy, _inputs(atlas, 1000, 14))
    needy = torch.from_numpy(np.random.default_rng(15).random(1000) < 0.5)
    calls = _count_calls(monkeypatch)
    out = atlas.sample(img, u, v, needy)
    assert len(calls) == 1 and out.shape == (1000, 3)
    planes = out.unbind(1)
    assert all(c.is_contiguous() for c in planes)  # what K3's check_planes asks
    atlas.sample(img, u, v, needy, plain=True)  # the twin, not the wrapper
    assert len(calls) == 1
