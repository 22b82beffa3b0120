"""Work of the spiral search (``kernels/sad_search.py``: kernel 7), run by
the configurations that search before they regularize.

A call reads its level image, the (bs + 2S)^2 window of each block, the
centres and the visit ranks once and writes each block's winner; its
operations are packed instructions, one VABSDIFF4 for four pixel-deltas
(and a dp4a more for ssd), for each in-frame (block, offset) pair.  Which
offsets lie in the frame depends on each block's centre; the count takes
the centres at the block origins, which differs from the data's only in
the ring of blocks at the frame's edge.
"""

from __future__ import annotations

from benchmark.work.levels import levels
from benchmark.work.peaks import INSTR_PER_S, bound_ms


def _in_frame(n: int, bs: int, s: int, size: int) -> int:
    """Sum over the n block origins along one axis of the offsets in
    [-s, s] whose block stays inside [0, size)."""
    return sum(min(o + s, size - bs) - max(o - s, 0) + 1 for o in range(0, n * bs, bs))


def search_call(b: int, h: int, w: int, bs: int, s: int, cost: str):
    npy, npx = h // bs, w // bs
    nblk = npy * npx
    pairs = b * _in_frame(npy, bs, s, h) * _in_frame(npx, bs, s, w)
    nbytes = (b * h * w + b * nblk * (bs + 2 * s) ** 2 + 4 * (2 * s + 1) ** 2
              + 4 * 4 * b * nblk)
    return nbytes, pairs * bs * bs // 4 * (2 if cost == "ssd" else 1)


def batch_calls(fields: dict, height: int, width: int, batch: int) -> list[tuple[int, int]]:
    lv_all = levels(fields, height, width)
    if all(lv["fused"] for lv in lv_all):
        return []
    return [search_call(batch, lv["h"], lv["w"], lv["bs"], lv["ext"], fields["cost"])
            for lv in lv_all]


def batch_bound_ms(fields: dict, height: int, width: int, batch: int) -> float:
    return sum(bound_ms(*c, rate=INSTR_PER_S) for c in batch_calls(fields, height, width, batch))
