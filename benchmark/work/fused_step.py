"""Work of the rounds (``kernels/rounds.py``: D, D', E, F, one round
kernel): every regularization round of every level.

A round of ``sweeps`` sweeps of the four colour steps reads its grid once
and writes it once, reads the parents' window centres (and the rival
centres), and for each cell of each step reads at least one stored cost
(the candidate that wins); its operations are the smoothness terms, 3 for
each of a cell's 9 candidates against its 9 neighbours.  Cost entries of
further candidates and recomputed costs depend on the data and are left
out, so the count is a floor of what the round needs.
"""

from __future__ import annotations

from benchmark.work.cv_diff import entry_bytes
from benchmark.work.levels import levels
from benchmark.work.peaks import bound_ms


def round_call(b: int, nby: int, nbx: int, npy: int, npx: int, sweeps: int, rival: bool,
               entry: int):
    """(bytes, ops) of one round on a (B, nby, nbx) grid of cells under
    (B, npy, npx) parents; ``entry``: bytes of the smallest cost entry."""
    cells = 0
    for ci, cj in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cells += b * ((nby - ci + 1) // 2) * ((nbx - cj + 1) // 2)
    cells *= sweeps
    grid = b * nby * nbx * 8
    centres = b * npy * npx * 8 * (2 if rival else 1)
    return 2 * grid + centres + cells * entry, cells * 9 * 9 * 3


def batch_calls(fields: dict, height: int, width: int, batch: int) -> list[tuple[int, int]]:
    """(bytes, ops) of every round of one batch."""
    calls = []
    for lv in levels(fields, height, width):
        cur = lv["bs"]
        while cur > 1:
            f = lv["bs"] // cur
            calls.append(round_call(batch, lv["npy"] * f, lv["npx"] * f, lv["npy"], lv["npx"],
                                    fields["sweeps_per_round"], lv["rival"],
                                    entry_bytes(cur, fields["cost"])))
            cur >>= 1
    return calls


def batch_bound_ms(fields: dict, height: int, width: int, batch: int) -> float:
    return sum(bound_ms(*c) for c in batch_calls(fields, height, width, batch))
