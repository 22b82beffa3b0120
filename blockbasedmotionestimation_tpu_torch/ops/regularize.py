"""Candidate tables and tie-breaks of the 8-connected regularizer.

Copied from ``blockbasedmotionestimation_tpu/ops/regularize.py`` (that module
imports jax); ``tests/test_torch_ops.py`` asserts the tables equal the
reference's.  Each border case of the reference's if-chain
(``motion_framework.cpp:439-522``) has its own candidate ordering; the winner
is the lexicographic (energy, rank) minimum, identical to the reference's
"first strict minimum" over the ordered list.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG_RANK = 127

# Canonical candidate slots (dy, dx), in the INTERIOR ordering: own MV first,
# then the 8 neighbors in the reference's gather order.
SLOTS: tuple[tuple[int, int], ...] = (
    (0, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (-1, 1), (-1, 0), (1, 0), (1, -1),
)
_SLOT_INDEX = {s: k for k, s in enumerate(SLOTS)}

_CASE_ORDERINGS: tuple[tuple[tuple[int, int], ...], ...] = (
    SLOTS,  # 0 interior
    ((0, 0), (0, -1), (0, 1), (1, 1), (1, 0), (1, -1)),     # 1 top row
    ((0, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (-1, 0)),  # 2 bottom row
    ((0, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (1, 0)),     # 3 left col
    ((0, 0), (0, -1), (-1, -1), (-1, 0), (1, 0), (1, -1)),  # 4 right col
    ((0, 0), (0, 1), (1, 1), (1, 0)),                        # 5 top-left
    ((0, 0), (0, -1), (1, 0), (1, -1)),                      # 6 top-right
    ((0, 0), (0, 1), (-1, 1), (-1, 0)),                      # 7 bottom-left
    ((0, 0), (0, -1), (-1, -1), (-1, 0)),                    # 8 bottom-right
)


def _rank_table() -> np.ndarray:
    """(9 cases, 9 slots) int32 visit rank; _BIG_RANK where a slot is absent."""
    table = np.full((9, 9), _BIG_RANK, dtype=np.int32)
    for case, ordering in enumerate(_CASE_ORDERINGS):
        for rank, slot in enumerate(ordering):
            table[case, _SLOT_INDEX[slot]] = rank
    return table


_RANK_TABLE = _rank_table()


def border_case(i: torch.Tensor, j: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    """Reference if-chain in block units; i, j broadcastable integer tensors."""
    interior = (i > 0) & (i < nby - 1) & (j > 0) & (j < nbx - 1)
    top = (i == 0) & (j > 0) & (j < nbx - 1)
    bottom = (i == nby - 1) & (j > 0) & (j < nbx - 1)
    left = (j == 0) & (i > 0) & (i < nby - 1)
    right = (j == nbx - 1) & (i > 0) & (i < nby - 1)
    tl = (i == 0) & (j == 0)
    tr = i == 0
    bl = j == 0
    shape = torch.broadcast_shapes(i.shape, j.shape)
    case = torch.full(shape, 8, dtype=torch.int64, device=i.device)
    # later assignments take precedence, as in the reference's chain
    for mask, value in (
        (bl, 7), (tr, 6), (tl, 5), (right, 4), (left, 3), (bottom, 2),
        (top, 1), (interior, 0),
    ):
        case = torch.where(mask, value, case)
    return case


def select_lexicographic(energy: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """argmin of (energy, rank) over the last dim (first index on full ties)."""
    e_min = energy.amin(dim=-1, keepdim=True)
    rank_sel = torch.where(energy == e_min, rank, _BIG_RANK)
    return rank_sel.argmin(dim=-1)
