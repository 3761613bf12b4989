"""The compaction of needy lanes, K4's compaction form, and the compacted
per-ray texel fetch (``art_tpu/ops/compact_fetch.py``).

``compact(needy, planes)`` is one launch of ``csrc/compact.cu``
(``art_compact``), K4's compaction form: for the (R,) bool ``needy`` it
returns the (S,) int32 ids (S = ``ceil(R / 128) * 128``; slot j holds the
j-th needy lane's index in lane order, slots at or past the count 0), the
(1,) int32 needy count (on the device), up to six (R,) float32 ``planes``
gathered at those ids (read only below the count: the kernel leaves the
slots past it unspecified) and, with ``want_rank``, the (R,) int32
exclusive needy rank.  It replaces ``art_tpu``'s K4 (``flush_accumulate``)
as ``compact_ray_ids`` calls it, with the jnp around that call: the rank,
the count and the gather of the ray planes (``art_tpu/ops/
compact_sphere.py``).  Its plain twin is the pipeline it replaced:

1. ``rank = cumsum(needy) - needy`` (exclusive);
2. K4's flush form (``flush_accumulate``) scatters each needy lane's ray id
   into slot ``rank``;
3. ``needy.sum``;
4. ``stack(planes).index_select(1, ids)``.

``compact_gather(data, flat, needy)`` is ``data[flat]`` on the needy lanes
and 0 elsewhere, computed as ``art_tpu``'s wide tier computes it:
``compact`` (ids, count and rank), ``texel_k = data[flat[ids]]`` on the
slots below the count and 0 above it, K8 (``table_gather_u24``) routing the
texels back (``out = texel_k[rank]``), ``where(needy, out, 0)``.

``art_tpu`` picks one of three tiers with ``lax.cond`` on the needy count
(a compact tier of 8192 slots, this wide tier of 49152, and a dense
gather), all exact on needy lanes.  PyTorch has no device-side cond, and
reading the count on the host would add a sync to every iteration, so the
port keeps one pipeline at a capacity of ``ceil(R / 128) * 128`` slots:
no needy count overflows it.  ``art_tpu``'s ``compact_apply`` (opt-in
there) is not ported.

On CUDA tensors the kernels launch; on CPU tensors, or with ``plain=True``,
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
``compact`` serves the split sphere pass (``ops/compact_sphere.py``).
"""

from __future__ import annotations

import itertools

import torch

from art_tpu_torch.ops import _build
from art_tpu_torch.ops import flush_kernel as fk

COMPACT = "compact"  # K4's compaction form
MAX_RAYS = 1 << 24  # the twin's ray ids ride K4's flush form as float32 values
MAX_PLANES = 6


def _rank(needy: torch.Tensor) -> torch.Tensor:
    """(R,) int32 exclusive prefix count of ``needy``."""
    needy_i = needy.to(torch.int32)
    return torch.cumsum(needy_i, 0, dtype=torch.int32) - needy_i


def _slots(R: int) -> int:
    return -(-R // fk.LANES) * fk.LANES


def _ray_ids(needy, rank) -> torch.Tensor:
    """The twin's ids: K4's flush form (plain) scatters ray id r to slot rank[r]."""
    R = needy.shape[0]
    ray_id = torch.arange(R, dtype=torch.float32, device=needy.device)
    slots = torch.zeros((_slots(R) // fk.LANES, fk.LANES), dtype=torch.float32,
                        device=needy.device)
    return fk.flush_accumulate_plain(rank, needy, (ray_id,), slots).view(-1).to(torch.int32)


_SCRATCH: dict = {}  # (device, blocks) -> the look-back scratch
_EPOCHS = itertools.count()


def scan_scratch(device, R: int) -> tuple[torch.Tensor, int]:
    """The look-back scratch of ``art_compact`` for R lanes on ``device``
    (``ceil(R / 256) + 1`` int64 words: a word a block, then the ticket
    counter; zeroed once, kept per (device, number of blocks)) and a fresh
    epoch for one call (``refill_kernel.scan_scratch``'s scheme)."""
    key = (device, -(-R // _build.BLOCK))
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = torch.zeros(key[1] + 1, dtype=torch.int64, device=device)
    return scratch, next(_EPOCHS) % 0xFFFFFFFF + 1


def _launch(needy, planes, ids, cnt, out, rank) -> None:
    """One launch of K4's compaction form into the given tensors: ``ids``
    (S,) and ``cnt`` (1,) int32, ``out`` a (S,) float32 tensor a plane,
    ``rank`` (R,) int32 or None."""
    dev = needy.device
    R = needy.shape[0]
    S = _slots(R)
    _build.check_planes(("needy",), (needy,), R, torch.bool, dev)
    _build.check_planes([f"planes[{c}]" for c in range(len(planes))], planes, R,
                        torch.float32, dev)
    _build.check_planes([f"out[{c}]" for c in range(len(out))], out, S, torch.float32, dev)
    _build.check_planes(("ids",), (ids,), S, torch.int32, dev)
    _build.check_planes(("cnt",), (cnt,), 1, torch.int32, dev)
    if rank is not None:
        _build.check_planes(("rank",), (rank,), R, torch.int32, dev)
    scratch, epoch = scan_scratch(dev, R)
    rc = _build.library().art_compact(
        needy.data_ptr(), R, _build.pointers(planes), _build.pointers(out), len(planes),
        ids.data_ptr(), cnt.data_ptr(), None if rank is None else rank.data_ptr(),
        scratch.data_ptr(), epoch, _build.stream_handle(dev))
    _build.check(rc, COMPACT)
    _build.launches[COMPACT] += 1


def compact(needy: torch.Tensor, planes=(), *, want_rank: bool = False,
            plain: bool = False):
    """K4's compaction form -> ``(ids, cnt, planes_k, rank)`` (module
    docstring): ``ids`` (S,) int32, ``cnt`` (1,) int32, ``planes_k`` a (S,)
    float32 tensor for each of ``planes`` (valid below the count), ``rank``
    (R,) int32 with ``want_rank``, else None.  The CUDA kernel for CUDA
    tensors, the plain twin (the pipeline it replaced) for CPU tensors or
    with ``plain``; on the first ``cnt`` slots the two are bit-equal."""
    R = needy.shape[0]
    if R > MAX_RAYS:
        raise ValueError(f"compaction: {R} lanes; ray ids must stay below 2^24")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"compaction takes at most {MAX_PLANES} planes, got {len(planes)}")
    if plain or needy.device.type == "cpu":
        rank = _rank(needy)
        ids = _ray_ids(needy, rank)
        cnt = needy.sum(dtype=torch.int32).reshape(1)
        planes_k = tuple(torch.stack(planes).index_select(1, ids)) if planes else ()
        return ids, cnt, planes_k, rank if want_rank else None
    dev = needy.device
    S = _slots(R)
    ids = torch.empty(S, dtype=torch.int32, device=dev)
    cnt = torch.zeros(1, dtype=torch.int32, device=dev) if R == 0 else torch.empty(
        1, dtype=torch.int32, device=dev)
    out = torch.empty((len(planes), S), dtype=torch.float32, device=dev)
    rank = torch.empty(R, dtype=torch.int32, device=dev) if want_rank else None
    if R:
        _launch(needy, planes, ids, cnt, tuple(out), rank)
    return ids, cnt, tuple(out), rank


def compact_ray_ids(needy: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """(ceil(R / 128) * 128,) int32: slot j holds the ray id of the j-th
    needy lane (queue order); slots at or beyond the needy count hold 0."""
    return compact(needy, plain=plain)[0]


def compact_gather(data: torch.Tensor, flat: torch.Tensor, needy: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
    """(R,) int32 ``data[flat]`` on needy lanes, 0 elsewhere.

    ``data`` (T,) int32, ``flat`` (R,) int32 (in range on needy lanes; any
    value elsewhere), ``needy`` (R,) bool."""
    T = data.shape[0]
    ray_k, cnt, _, rank = compact(needy, want_rank=True, plain=plain)
    flat_k = flat.index_select(0, ray_k)  # slots past the count read lane 0
    slot = torch.arange(ray_k.shape[0], dtype=torch.int32, device=flat.device)
    texel_k = torch.where(slot < cnt, data.index_select(0, flat_k.clamp(0, T - 1)), 0)
    gather = fk.table_gather_u24_plain if plain else fk.table_gather_u24
    return torch.where(needy, gather(texel_k, rank), 0)
