"""The compacted per-ray texel fetch (``art_tpu/ops/compact_fetch.py``).

``compact_gather(data, flat, needy)`` is ``data[flat]`` on the needy lanes
and 0 elsewhere, computed as ``art_tpu``'s wide tier computes it:

1. ``rank = cumsum(needy) - needy`` (exclusive);
2. ``compact_ray_ids``: K4 (``flush_accumulate``) scatters each needy
   lane's ray id into slot ``rank``;
3. ``texel_k = data[flat[ray_k]]`` on the slots below the needy count, 0
   above it (the count stays on the device);
4. K8 (``table_gather_u24``) routes the texels back: ``out = texel_k[rank]``;
5. ``where(needy, out, 0)``.

``art_tpu`` picks one of three tiers with ``lax.cond`` on the needy count
(a compact tier of 8192 slots, this wide tier of 49152, and a dense
gather), all exact on needy lanes.  PyTorch has no device-side cond, and
reading the count on the host would add a sync to every iteration, so the
port keeps one pipeline at a capacity of ``ceil(R / 128) * 128`` slots:
no needy count overflows it, and a ray-id payload (exact in float32 below
2^24, one add per slot) leaves the atlas size unbounded.  ``art_tpu``'s
``compact_apply`` (opt-in there) is not ported.

On CUDA tensors K4 and K8 launch; on CPU tensors, or with ``plain=True``,
their plain twins run.

``art_tpu`` compacts only on the TPU: its texture evaluation
(``art_tpu/ops/texture_eval.py:145-153``, ``:297-306``) takes
``compact_gather`` when ``tpu_paths()`` is true (and
``ART_TPU_NO_COMPACT_FETCH`` is unset), and the dense ``data[flat]``
elsewhere.  On the TPU a gather is a one-hot MXU product, so fetching only
the needy slots pays; on the H100 a masked lane loads nothing.  So no
render of the port calls ``compact_gather``: ``ImageAtlas.sample`` takes
K8's fetch form (``ops/flush_kernel.py atlas_fetch``), one launch.
``compact_gather`` stays as the port of ``art_tpu``'s function, and
``compact_ray_ids`` serves the split sphere pass (``ops/compact_sphere.py``).
"""

from __future__ import annotations

import torch

from art_tpu_torch.ops import flush_kernel as fk

MAX_RAYS = 1 << 24  # ray ids ride K4 as float32 channel values


def _rank(needy: torch.Tensor) -> torch.Tensor:
    """(R,) int32 exclusive prefix count of ``needy``."""
    needy_i = needy.to(torch.int32)
    return torch.cumsum(needy_i, 0, dtype=torch.int32) - needy_i


def _slots(R: int) -> int:
    return -(-R // fk.LANES) * fk.LANES


def _ray_ids(needy, rank, *, plain: bool) -> torch.Tensor:
    R = needy.shape[0]
    if R > MAX_RAYS:
        raise ValueError(f"compacted fetch: {R} lanes; ray ids must stay below 2^24")
    flush = fk.flush_accumulate_plain if plain else fk.flush_accumulate
    ray_id = torch.arange(R, dtype=torch.float32, device=needy.device)
    slots = torch.zeros((_slots(R) // fk.LANES, fk.LANES), dtype=torch.float32,
                        device=needy.device)
    return flush(rank, needy, (ray_id,), slots).view(-1).to(torch.int32)


def compact_ray_ids(needy: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """(ceil(R / 128) * 128,) int32: slot j holds the ray id of the j-th
    needy lane (queue order); slots at or beyond the needy count hold 0."""
    return _ray_ids(needy, _rank(needy), plain=plain)


def compact_gather(data: torch.Tensor, flat: torch.Tensor, needy: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
    """(R,) int32 ``data[flat]`` on needy lanes, 0 elsewhere.

    ``data`` (T,) int32, ``flat`` (R,) int32 (in range on needy lanes; any
    value elsewhere), ``needy`` (R,) bool."""
    T = data.shape[0]
    rank = _rank(needy)
    cnt = rank[-1:] + needy[-1:].to(torch.int32)  # (1,): the needy count, on the device
    ray_k = _ray_ids(needy, rank, plain=plain)
    flat_k = flat.index_select(0, ray_k)  # slots past the count read lane 0
    slot = torch.arange(ray_k.shape[0], dtype=torch.int32, device=flat.device)
    texel_k = torch.where(slot < cnt, data.index_select(0, flat_k.clamp(0, T - 1)), 0)
    gather = fk.table_gather_u24_plain if plain else fk.table_gather_u24
    return torch.where(needy, gather(texel_k, rank), 0)
