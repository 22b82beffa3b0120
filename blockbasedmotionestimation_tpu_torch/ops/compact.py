"""Compact slot lists: the deltas a ``cv_compact`` level's rounds can ask for.

Port of ``blockbasedmotionestimation_tpu/ops/compact.py`` (XLA code in the
reference, plain torch here on every device), with the batch dim written
out.  The rounds never invent motion vectors: every candidate is a search
winner propagated by adoption, so the deltas a parent's volume is asked for
are {winner_q - base_p} over nearby parents q.  Per chunk of 128 consecutive
parents of one frame's row-major parent list (the last chunk ragged; its
missing parents set nothing), the slot list is the first K distinct
in-window deltas, in ascending key order, over each parent's
(2 ring + 1)^2 neighbourhood (edge-padded), each rebased on the evaluating
parent's window centre.  A candidate whose delta is not in its chunk's list
is excluded, which is exact whenever no chunk has more than K distinct
deltas (``overflow_fraction`` == 0) and no value travels further than
``ring`` parents in the rounds.

The reference packs presence into 32-bit words for the TPU's vector units;
here presence is a scatter into a (B, nch, side^2) map, which gives the same
slot lists.
"""

from __future__ import annotations

import functools

import torch

CHUNK = 128


def _presence(
    winners: torch.Tensor,  # (B, npy, npx, 2) int32 search winners (x, y)
    base: torch.Tensor,     # (B, npy, npx, 2) int32 window centres
    r: int,
    ring: int,
) -> torch.Tensor:
    """(B, nch, side^2) bool: the deltas that appear in each chunk."""
    b, npy, npx, _ = winners.shape
    n_p = npy * npx
    nch = -(-n_p // CHUNK)
    side = 2 * r + 1
    dev = winners.device
    # each parent's (2 ring + 1)^2 neighbourhood, edge-padded, in one gather
    offs = torch.arange(-ring, ring + 1, device=dev)
    iy = (torch.arange(npy, device=dev)[:, None] + offs).clamp(0, npy - 1)
    ix = (torch.arange(npx, device=dev)[:, None] + offs).clamp(0, npx - 1)
    nb = winners[:, iy[:, None, :, None], ix[None, :, None, :]]  # (B, npy, npx, R, R, 2)
    d = nb - base[:, :, :, None, None]  # rebased on the evaluating parent's centre
    ky, kx = d[..., 1] + r, d[..., 0] + r
    ok = (ky >= 0) & (ky < side) & (kx >= 0) & (kx < side)
    key = torch.where(ok, ky * side + kx, side * side).reshape(b, n_p, -1)  # side^2: none
    ch = torch.arange(n_p, device=dev) // CHUNK
    flat = (ch[None, :, None] * (side * side + 1) + key).reshape(b, -1)
    pres = torch.zeros((b, nch * (side * side + 1)), dtype=torch.bool, device=dev)
    pres.scatter_(1, flat.long(), True)
    return pres.reshape(b, nch, side * side + 1)[..., : side * side]


def chunk_delta_slots(
    winners: torch.Tensor,
    base: torch.Tensor,
    r: int,
    k_slots: int,
    ring: int = 3,
) -> torch.Tensor:
    """(B, nch, K, 2) int32 slot deltas as volume indices (dy + r, dx + r),
    each in [0, 2r]; unused slots hold -1 (they match no candidate)."""
    side = 2 * r + 1
    pres = _presence(winners, base, r, ring)
    b, nch, _ = pres.shape
    rank = pres.to(torch.int32).cumsum(dim=-1) - 1
    pos = torch.where(pres & (rank < k_slots), rank, k_slots).long()  # K: not taken
    keys = torch.arange(side * side, dtype=torch.int32, device=pres.device).expand(b, nch, -1)
    out = torch.full((b, nch, k_slots + 1), -1, dtype=torch.int32, device=pres.device)
    out.scatter_(2, pos, keys)  # each taken key has its own slot; K collects the rest
    key = out[..., :k_slots]
    return torch.stack(
        [torch.where(key >= 0, key // side, -1), torch.where(key >= 0, key % side, -1)], dim=-1
    ).contiguous()


NO_SLOT = 0xFFFF  # slot_map's entry for a delta key no slot holds


@functools.lru_cache(maxsize=None)
def _slot_index(k_slots: int, device: torch.device) -> torch.Tensor:
    return torch.arange(k_slots, dtype=torch.int32, device=device)


def slot_map(slots: torch.Tensor, r: int) -> torch.Tensor:
    """(B, nch, side^2) uint16: for each chunk and delta key (dy + r) * side
    + (dx + r), the index of the slot of ``slots`` ((B, nch, K, 2), as
    ``chunk_delta_slots`` returns) that holds it, or NO_SLOT.  A chunk's
    slots are distinct, so the map is well defined; uint16 holds K up to
    side^2 (1089 at S = 16).  Kernel 10 looks its candidates up here instead
    of comparing them with every slot.  Built once a level, in few ops (the
    path is host-bound): an unused slot's (-1, -1) gives the key -side - 1,
    which the modulus sends to a spare entry past the map's end."""
    b, nch, k_slots, _ = slots.shape
    side = 2 * r + 1
    if k_slots >= NO_SLOT:
        raise ValueError(f"K={k_slots} slots do not fit a uint16 map")
    key = torch.add(slots[..., 1], slots[..., 0], alpha=side).long()
    key.remainder_(side * side + side + 1)  # in [0, side^2]: side^2 is the spare
    out = torch.full((b, nch, side * side + 1), NO_SLOT, dtype=torch.int32, device=slots.device)
    out.scatter_(2, key, _slot_index(k_slots, slots.device).expand(b, nch, -1))
    return out[..., : side * side].to(torch.uint16)


def overflow_fraction(
    winners: torch.Tensor,
    base: torch.Tensor,
    r: int,
    k_slots: int,
    ring: int = 3,
) -> torch.Tensor:
    """(B,) float32 per frame: the fraction of chunks with more than K
    distinct deltas (nonzero: the tables exclude deltas the dense volumes
    hold, and the flow may differ from the dense path's)."""
    pres = _presence(winners, base, r, ring)
    return (pres.sum(dim=-1) > k_slots).to(torch.float32).mean(dim=-1)
