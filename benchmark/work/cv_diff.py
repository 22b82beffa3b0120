"""Work of the volume stage (``kernels/cv_diff.py``: kernels B and C): the
pooled cost volumes of each level's main and rival windows.

A call reads its level image and its windows once and writes each stored
volume once; its operations are a difference, an absolute value (or a
square) and an add for each pixel of each delta of each parent.  Pooling
the sizes from one another adds less than a third more; it is not counted.
"""

from __future__ import annotations

from benchmark.work.levels import levels
from benchmark.work.peaks import bound_ms


def entry_bytes(cur: int, cost: str) -> int:
    """Bytes of one stored cost at sub-block size cur (u16 while the worst
    cost fits, else i32)."""
    peak = (255 * 255 if cost == "ssd" else 255) * cur * cur
    return 2 if peak < (1 << 16) else 4


def volume_call(b: int, h: int, w: int, bs: int, r: int, cost: str, curs, store_r=None):
    """(bytes, ops) of one volume call: B frames of h x w, windows of radius
    r around each bs-parent, volumes stored at the sizes ``curs`` (the
    cur = 2 one only for |dx| <= store_r when store_r is given)."""
    n_p = (h // bs) * (w // bs)
    side = 2 * r + 1
    nbytes = b * h * w + b * n_p * (bs + 2 * r) ** 2
    for cur in curs:
        deltas = side * (2 * store_r + 1) if cur == 2 and store_r is not None else side * side
        nbytes += b * deltas * (h // cur) * (w // cur) * entry_bytes(cur, cost)
    return nbytes, 3 * b * n_p * side * side * bs * bs


def batch_calls(fields: dict, height: int, width: int, batch: int) -> list[tuple[int, int]]:
    """(bytes, ops) of every volume call of one batch."""
    cost = fields["cost"]
    calls = []
    for lv in levels(fields, height, width):
        bs, h, w = lv["bs"], lv["h"], lv["w"]
        curs = [1 << k for k in range(1, bs.bit_length())]
        calls.append(volume_call(batch, h, w, bs, lv["r"], cost, curs, lv["store_r"]))
        if lv["rival"]:
            rcurs = [c for c in curs if c > lv["fuse_max"] or c == bs] if lv["hybrid"] else curs
            calls.append(volume_call(batch, h, w, bs, lv["r2"], cost, rcurs))
    return calls


def batch_bound_ms(fields: dict, height: int, width: int, batch: int) -> float:
    """Least device time of one batch's volume calls, each at its own bound."""
    return sum(bound_ms(*c) for c in batch_calls(fields, height, width, batch))
