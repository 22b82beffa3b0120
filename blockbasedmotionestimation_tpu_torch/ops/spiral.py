"""Spiral visit-order ranks of the reference program's block search.

The spiral search walks a square spiral from the predicted centre - right
m, down m, left m+1, up m+1 for m = 1, 3, 5, ... < shift, plus a final
(m-1)-step run right - keeping the first strictly-smaller cost, i.e. the
minimum cost with ties broken by earliest visit.  The port evaluates the
whole (2S+1)^2 cost volume and takes a lexicographic argmin over (cost,
first-visit rank); these tables give the ranks.
"""

from __future__ import annotations

import functools

import numpy as np


def spiral_visits(shift: int) -> list[tuple[int, int]]:
    """The raw (dy, dx) visit sequence, revisits included."""
    visits: list[tuple[int, int]] = [(0, 0)]
    x = y = 0
    m = 1
    while m < shift:
        for dx, dy, n in ((1, 0, m), (0, 1, m), (-1, 0, m + 1), (0, -1, m + 1)):
            for _ in range(n):
                x += dx
                y += dy
                visits.append((y, x))
        m += 2
    for _ in range(max(0, m - 1)):  # the final top-row run
        x += 1
        visits.append((y, x))
    return visits


@functools.lru_cache(maxsize=None)
def _tables(shift: int) -> tuple[bytes, int]:
    """(first-visit rank array bytes, extent S); ranks are (2S+1, 2S+1) int32
    indexed by (dy + S, dx + S), the centre 0."""
    visits = spiral_visits(shift)
    ext = max(max(abs(y), abs(x)) for y, x in visits)
    side = 2 * ext + 1
    rank = np.full((side, side), np.iinfo(np.int32).max, dtype=np.int32)
    for idx, (vy, vx) in enumerate(visits):
        if rank[vy + ext, vx + ext] == np.iinfo(np.int32).max:
            rank[vy + ext, vx + ext] = idx
    assert (rank < np.iinfo(np.int32).max).all(), "spiral did not tile its square"
    return rank.tobytes(), ext


def spiral_extent(shift: int) -> int:
    """Half-width S of the square the spiral covers: offsets in [-S, S]^2."""
    return _tables(shift)[1]


def spiral_rank(shift: int) -> np.ndarray:
    """(2S+1, 2S+1) int32 first-visit ranks, centre (S, S) = 0."""
    data, ext = _tables(shift)
    side = 2 * ext + 1
    return np.frombuffer(data, dtype=np.int32).reshape(side, side).copy()


@functools.lru_cache(maxsize=None)
def spiral_offsets(shift: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Every (dy, dx) of the [-S, S]^2 square once, in first-visit order,
    plus S: scanning them with a strict-< argmin update reproduces the
    walk's tie-breaks."""
    seen: set[tuple[int, int]] = set()
    dys, dxs = [], []
    for dy, dx in spiral_visits(shift):
        if (dy, dx) not in seen:
            seen.add((dy, dx))
            dys.append(dy)
            dxs.append(dx)
    ext = spiral_extent(shift)
    assert len(dys) == (2 * ext + 1) ** 2, "spiral must tile its square"
    return np.asarray(dys, dtype=np.int32), np.asarray(dxs, dtype=np.int32), ext
