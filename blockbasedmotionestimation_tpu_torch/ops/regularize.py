"""The 8-connected MV regularizer (``blockbasedmotionestimation_tpu/ops/regularize.py``).

Per block, the candidate list is the block's own MV and up to 8 neighbours'
MVs, in an order that depends on the block's border case (the reference's
if-chain, ``motion_framework.cpp:439-522``); each candidate scores
Energy = cost(block, block at origin + candidate) + lambda * sum of the L1
distances to the present candidates, in f32, and the winner is the
lexicographic (energy, rank) minimum, identical to the reference's "first
strict minimum" over the ordered list.  The tables are copied from the
reference (that module imports jax); ``tests/test_torch_ops.py`` asserts
they equal it.

The schedules of a level (``run_schedule``), all plain torch on every
device, as the reference computes them in XLA:
  * ``fourcolor``: the cells of colour (row % 2, col % 2) update together,
    the four colours in turn;
  * ``jacobi``: every cell updates from the previous iterate at once;
  * ``exact``: bit-exact with the reference program's in-place raster
    sweep, computed in wavefronts of blocks with equal 2 * row + column
    (2 nby + nbx - 2 steps a sweep).
``step_candidates`` and ``step_commit`` are shared with the windowed
colour steps (``kernels.reg_step``, ``kernels.fused_step``).

Tiles (``parallel.tiled``): a batch entry may be a row strip of its frame,
or a 2-D tile of it, described at each colour step by ``Strips`` (its first
row in the frame, the frame's height and the frame's rows just above and
below it; on 2-D tiles also its first column, the frame's width and the
frame's columns just left and right of it, corners included), which the
tiling's exchange (``ops.search.Tiling``) refreshes before every step.  Border cases, presence and the in-frame test then use the
frame's rows and columns, and a colour (ci, cj) of the frame sits at the
tile's local rows (ci + first row) % 2, ... and columns (cj + first
column) % 2, ... (``on_strips``).  ``exact`` does not decompose into tiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from blockbasedmotionestimation_tpu_torch.kernels.sad_search import block_cost, extract_blocks
from blockbasedmotionestimation_tpu_torch.ops.search import Tiling
from blockbasedmotionestimation_tpu_torch.utils import profiling

_BIG_RANK = 127
_F32_MAX = float(np.finfo(np.float32).max)
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))

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


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rank table and the slots' dy and dx on a device, copied once."""
    return (profiling.upload(_RANK_TABLE, device, "tables"),
            profiling.upload([s[0] for s in SLOTS], device, "tables"),
            profiling.upload([s[1] for s in SLOTS], device, "tables"))


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


def energy(
    costs: torch.Tensor,    # (..., 9) integer candidate costs
    cands: torch.Tensor,    # (..., 9, 2) integer-valued candidate MVs
    present: torch.Tensor,  # (..., 9) bool, broadcastable: the candidate list
    usable: torch.Tensor,   # (..., 9) bool: candidates that may win
    lam_mult,               # lambda * multiplier, rounded to f32
) -> torch.Tensor:
    """(..., 9) f32 energies: cost + lam_mult * smoothness, f32 max where a
    candidate is not usable.  The multiply and the add round separately,
    as the reference's do."""
    cf = cands.to(torch.float32)
    du = (cf[..., :, None, 0] - cf[..., None, :, 0]).abs()
    dv = (cf[..., :, None, 1] - cf[..., None, :, 1]).abs()
    smooth = ((du + dv) * present.to(torch.float32)[..., None, :]).sum(dim=-1)
    # a CPU scalar: no copy to the device, the same f32 multiply
    lam = torch.tensor(lam_mult, dtype=torch.float32)
    return torch.where(usable, costs.to(torch.float32) + lam * smooth, _F32_MAX)


def subdivide(grid: torch.Tensor) -> torch.Tensor:
    """Each block's MV to its 2x2 children: (B, n, m, 2) -> (B, 2n, 2m, 2)."""
    return grid.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Strips(NamedTuple):
    """A batch of tiles at one colour step: entry b holds the rows
    row0_b[b] .. of its frame (in cells of the step's size), whose height
    is full_h pixels, and ghost[b] the frame's rows just above and below
    the tile (zeros past the frame's edge).  Row strips span the frame's
    columns and leave the last three fields None; a 2-D tile holds the
    columns col0_b[b] .. of a frame full_w pixels wide, and ghost_cols[b]
    the frame's columns just left and right of it over the tile's rows -1
    .. nby (the corners: the diagonal neighbours' cells)."""

    row0_b: torch.Tensor  # (B,) int32
    full_h: int
    ghost: torch.Tensor   # (B, 2, nbx, 2) int32
    col0_b: torch.Tensor | None = None      # (B,) int32
    full_w: int | None = None
    ghost_cols: torch.Tensor | None = None  # (B, 2, nby + 2, 2) int32

    def take(self, idx: torch.Tensor) -> "Strips":
        """The entries ``idx`` of the batch."""
        return Strips(*(f[idx] if isinstance(f, torch.Tensor) else f for f in self))


def strips_at(grid: torch.Tensor, tiling: Tiling, cur: int) -> Strips:
    """The ``Strips`` of ``grid`` (B, nby, nbx, 2) at one step: its first
    and last rows (and on 2-D tiles its first and last columns) sent to
    the neighbouring tiles, theirs received as the ghost rows (columns)."""
    north, south, west, east = tiling.exchange(grid)
    ghost = torch.stack([north, south], dim=1).contiguous()
    if west is None:
        return Strips(tiling.row0 // cur, tiling.full_h, ghost)
    return Strips(tiling.row0 // cur, tiling.full_h, ghost, tiling.col0 // cur, tiling.full_w,
                  torch.stack([west, east], dim=1).contiguous())


def on_strips(step, grid: torch.Tensor, *args, ci: int, cj: int, strips: Strips | None,
              **kw) -> None:
    """Run the plain colour step ``step`` (in place on ``grid``, colour
    (ci, cj) in the grid's own rows and columns) for the frame's colour
    (ci, cj): a tile whose first row is odd takes local colour row 1 - ci,
    one whose first column is odd local colour column 1 - cj.  Entries of
    one local colour run together; the others (and their batch-first
    tensor arguments) are taken apart and written back."""
    if strips is None:
        step(grid, *args, ci=ci, cj=cj, **kw)
        return
    b = grid.shape[0]
    lci = (ci + strips.row0_b) % 2
    lcj = cj if strips.col0_b is None else (cj + strips.col0_b) % 2
    for p, q in COLORS:
        sel = profiling.host_read((lci == p) & (lcj == q), "strips")
        if bool(sel.all()):
            step(grid, *args, ci=p, cj=q, strips=strips, **kw)
            return
        if not bool(sel.any()):
            continue
        idx = profiling.upload(sel.nonzero()[:, 0], grid.device, "strips")

        def take(t):
            if not isinstance(t, torch.Tensor) or t.shape[:1] != (b,):
                return t
            if t.dtype == torch.uint16:  # CUDA indexing does not take uint16
                return t.view(torch.int16)[idx].view(torch.uint16)
            return t[idx]

        sub = grid[idx]
        step(sub, *map(take, args), ci=p, cj=q, strips=strips.take(idx),
             **{k: take(v) for k, v in kw.items()})
        grid[idx] = sub


def step_candidates(
    grid: torch.Tensor, cur: int, h: int, w: int, ci: int, cj: int, stride: int = 2,
    strips: Strips | None = None,
):
    """The 9 candidates of the cells of colour (ci, cj) and their masks.

    Returns cands (B, m, n, 9, 2) int32 (the reference's slot order, 0 off
    the grid), rank (m, n, 9) tie-break ranks, present (m, n, 9) and in_img
    (B, m, n, 9): the candidate's target block lies in the h x w frame.
    The cells are rows ci::stride, cols cj::stride (stride 1: every cell).
    With ``strips`` the grid is a batch of tiles: rows -1 and nby read the
    ghost rows (on 2-D tiles columns -1 and nbx the ghost columns, corners
    included), the frame's rows and height (``strips.full_h``; columns and
    width ``strips.full_w``) decide, and rank and present gain the batch
    dim.
    """
    _, nby, nbx, _ = grid.shape
    dev = grid.device
    m, n = (nby - ci + stride - 1) // stride, (nbx - cj + stride - 1) // stride
    # zero ring = the reference's padded grid: off-grid slots read 0
    gp = F.pad(grid, (0, 0, 1, 1, 1, 1))
    gi = ci + stride * torch.arange(m, device=dev)[:, None]
    gj = cj + stride * torch.arange(n, device=dev)[None, :]
    if strips is not None:
        gp[:, 0, 1:-1] = strips.ghost[:, 0]
        gp[:, -1, 1:-1] = strips.ghost[:, 1]
        gi = strips.row0_b.long()[:, None, None] + gi  # (B, m, 1) the frame's rows
        h = strips.full_h
        if strips.col0_b is not None:
            gp[:, :, 0] = strips.ghost_cols[:, 0]
            gp[:, :, -1] = strips.ghost_cols[:, 1]
            gj = strips.col0_b.long()[:, None, None] + gj  # (B, 1, n) the frame's cols
            w = strips.full_w
    nby_t, nbx_t = h // cur, w // cur
    cands = torch.stack(
        [
            gp[:, 1 + ci + dy : 2 + ci + dy + stride * (m - 1) : stride,
               1 + cj + dx : 2 + cj + dx + stride * (n - 1) : stride]
            for dy, dx in SLOTS
        ],
        dim=3,
    )  # (B, m, n, 9, 2) int32

    case = border_case(gi, gj, nby_t, nbx_t)
    rank_table, slot_dy, slot_dx = _tables_on(dev)
    rank = rank_table[case]  # (m, n, 9)
    ty_, tx_ = gi[..., None] + slot_dy, gj[..., None] + slot_dx
    present = (
        (rank < _BIG_RANK)
        & (ty_ >= 0) & (ty_ < nby_t) & (tx_ >= 0) & (tx_ < nbx_t)
    )
    t_x = (gj * cur)[..., None] + cands[..., 0]
    t_y = (gi * cur)[..., None] + cands[..., 1]
    in_img = (t_x >= 0) & (t_x <= w - cur) & (t_y >= 0) & (t_y <= h - cur)
    return cands, rank, present, in_img


def step_commit(
    grid: torch.Tensor,
    ci: int,
    cj: int,
    cands: torch.Tensor,
    costs: torch.Tensor,
    evaluable: torch.Tensor,
    present: torch.Tensor,
    in_img: torch.Tensor,
    rank: torch.Tensor,
    lam_mult: float,
    stride: int = 2,
) -> None:
    """Energy cost + lam * smoothness in f32, the lexicographic (energy, rank)
    winner of each cell, written in place (reference ``_finish_step``)."""
    b, m, n = cands.shape[:3]
    e = energy(costs, cands, present, present & in_img & evaluable, lam_mult)
    winner = select_lexicographic(e, rank.expand_as(e))
    new_mv = torch.gather(
        cands, 3, winner[..., None, None].expand(b, m, n, 1, 2)
    )[:, :, :, 0]
    grid[:, ci::stride, cj::stride] = new_mv


def target_costs(
    blocks: torch.Tensor,  # (B, m, n, cur, cur) frame-1 blocks of the cells
    im2: torch.Tensor,     # (B, hb, wb) u8 frame 2 (a tile's buffer: from im2_row0, im2_col0)
    cands: torch.Tensor,   # (B, m, n, 9, 2) int32 candidate MVs
    gi: torch.Tensor,      # (m, 1) or (B, m, 1) block rows of the cells in the frame
    gj: torch.Tensor,      # (1, n) or (B, 1, n) block cols
    cur: int,
    cost: str,
    im2_row0=0,            # int or (B,): the frame's row of im2's row 0
    im2_col0=0,            # int or (B,): the frame's column of im2's column 0
) -> torch.Tensor:
    """(B, m, n, 9) int32 cost of each cell's block against the frame-2
    block at origin + candidate, its position clipped into the buffer (an
    out-of-frame candidate's cost is masked by the caller)."""
    b, h, w = im2.shape
    ar = torch.arange(cur, device=im2.device)
    if isinstance(im2_row0, torch.Tensor):
        im2_row0 = im2_row0.reshape(b, 1, 1, 1)
    if isinstance(im2_col0, torch.Tensor):
        im2_col0 = im2_col0.reshape(b, 1, 1, 1)
    by = ((gi * cur)[..., None] + cands[..., 1] - im2_row0).clamp(0, h - cur)
    bx = ((gj * cur)[..., None] + cands[..., 0] - im2_col0).clamp(0, w - cur)
    bidx = torch.arange(b, device=im2.device).reshape(b, 1, 1, 1, 1, 1)
    flat = (bidx * h + (by[..., None, None] + ar[:, None])) * w + (bx[..., None, None] + ar)
    tgt = im2.reshape(-1)[flat]  # (B, m, n, 9, cur, cur)
    return block_cost(blocks[:, :, :, None], tgt, (-2, -1), cost)


def update_color(
    grid: torch.Tensor,    # (B, nby, nbx, 2) int32, updated in place
    blocks: torch.Tensor,  # (B, nby, nbx, cur, cur) frame-1 blocks
    im2: torch.Tensor,
    *,
    cur: int,
    lam_mult: float,
    ci: int,
    cj: int,
    stride: int,
    cost: str,
    strips: Strips | None = None,
    im2_row0=0,
    im2_col0=0,
) -> None:
    """One step: the cells of rows ci::stride, cols cj::stride take their
    winning candidate (stride 2: a fourcolor colour; stride 1: a Jacobi
    pass).  Candidates are read before any cell is written.  With
    ``strips``, im2 is each tile's frame-2 buffer, whose row 0 is the
    frame's row ``im2_row0`` and column 0 the frame's column ``im2_col0``."""
    w = grid.shape[2] * cur
    h = grid.shape[1] * cur
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, stride, strips)
    m, n = cands.shape[1:3]
    if m == 0 or n == 0:
        return
    dev = grid.device
    gi = ci + stride * torch.arange(m, device=dev)[:, None]
    gj = cj + stride * torch.arange(n, device=dev)[None, :]
    if strips is not None:
        gi = strips.row0_b.long()[:, None, None] + gi
        if strips.col0_b is not None:
            gj = strips.col0_b.long()[:, None, None] + gj
    costs = target_costs(blocks[:, ci::stride, cj::stride], im2, cands, gi, gj, cur, cost,
                         im2_row0, im2_col0)
    # every candidate inside the frame is evaluable
    step_commit(grid, ci, cj, cands, costs, in_img, present, in_img, rank, lam_mult, stride)


def _edge_pad(grid: torch.Tensor) -> torch.Tensor:
    """(B, nby, nbx, 2) -> (B, nby+2, nbx+2, 2), edges replicated."""
    _, nby, nbx, _ = grid.shape
    ey = torch.arange(-1, nby + 1, device=grid.device).clamp(0, nby - 1)
    ex = torch.arange(-1, nbx + 1, device=grid.device).clamp(0, nbx - 1)
    return grid[:, ey][:, :, ex]


def regularize_exact(
    im1: torch.Tensor, im2: torch.Tensor, grid: torch.Tensor, bs: int, lam_mult
) -> torch.Tensor:
    """One sweep with the values of the reference's in-place raster sweep
    (Gauss-Seidel, ``:616``): each block reads its west and north
    neighbours already updated and its east and south ones not yet.  A
    block (i, j) thus depends only on blocks of smaller 2i + j, and no two
    blocks of one 2i + j are neighbours, so the blocks of each such
    wavefront update together: 2 nby + nbx - 2 steps a sweep, vectorised
    over the wavefront and the batch.  The cost is SAD whatever the level's
    search cost, as in the reference.  The carried grid is edge-padded
    once; the ring keeps the entry values (the reference never updates
    it).  Returns the (B, nby, nbx, 2) int32 grid."""
    b, nby, nbx, _ = grid.shape
    _, h, w = im1.shape
    dev = grid.device
    blocks = extract_blocks(im1, bs)
    gp = _edge_pad(grid).contiguous()
    rank_table, slot_dy, slot_dx = _tables_on(dev)
    case = border_case(
        torch.arange(nby, device=dev)[:, None], torch.arange(nbx, device=dev)[None, :], nby, nbx
    )
    ranks = rank_table[case].reshape(nby * nbx, 9)
    ar = torch.arange(bs, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None, None]
    wave = (2 * np.arange(nby)[:, None] + np.arange(nbx)[None, :]).ravel()
    order = profiling.upload(np.argsort(wave, kind="stable"), dev, "regularize")
    start = 0
    for end in np.cumsum(np.bincount(wave)).tolist():
        k = order[start:end]  # the wavefront's blocks (n,), row-major ids
        start = end
        i, j = k // nbx, k % nbx
        cands = gp[:, (i + 1)[:, None] + slot_dy, (j + 1)[:, None] + slot_dx]  # (B, n, 9, 2)
        rank = ranks[k]
        present = rank < _BIG_RANK
        tx = (j * bs)[:, None] + cands[..., 0]
        ty = (i * bs)[:, None] + cands[..., 1]
        in_img = (tx >= 0) & (tx <= w - bs) & (ty >= 0) & (ty <= h - bs)
        rows = ty.clamp(0, h - bs)[..., None] + ar  # (B, n, 9, bs)
        cols = tx.clamp(0, w - bs)[..., None] + ar
        tgt = im2[bidx, rows[..., :, None], cols[..., None, :]]
        sad = block_cost(blocks[:, k, None], tgt, (-2, -1), "sad")
        e = energy(sad, cands, present, present & in_img, lam_mult)
        winner = select_lexicographic(e, rank.expand_as(e))
        gp[:, i + 1, j + 1] = torch.take_along_dim(cands, winner[..., None, None], dim=2)[:, :, 0]
    return gp[:, 1:-1, 1:-1].contiguous()


def regularize_sweep(
    im1: torch.Tensor,
    im2: torch.Tensor,
    grid: torch.Tensor,
    bs: int,
    lam: float,
    mult: float,
    mode: str = "fourcolor",
) -> torch.Tensor:
    """One SAD sweep over a (B, nby, nbx, 2) int32 grid at block size bs,
    lambda * multiplier rounded as f32(lam) * f32(mult); returns the new
    grid (the input is not changed)."""
    lam_mult = np.float32(lam) * np.float32(mult)
    if mode == "exact":
        return regularize_exact(im1, im2, grid, bs, lam_mult)
    b, nby, nbx, _ = grid.shape
    blocks = extract_blocks(im1, bs).reshape(b, nby, nbx, bs, bs)
    grid = grid.clone()
    if mode == "jacobi":
        update_color(grid, blocks, im2, cur=bs, lam_mult=lam_mult, ci=0, cj=0, stride=1,
                     cost="sad")
    elif mode == "fourcolor":
        for ci, cj in COLORS:
            update_color(grid, blocks, im2, cur=bs, lam_mult=lam_mult, ci=ci, cj=cj, stride=2,
                         cost="sad")
    else:
        raise ValueError(f"unknown regularizer mode: {mode}")
    return grid


def run_schedule(
    im1: torch.Tensor,   # (B, h, w) u8
    im2: torch.Tensor,   # (B, h, w) u8
    grid: torch.Tensor,  # (B, nby, nbx, 2) int32 search winners at bs
    bs: int,
    lam0: float,
    sweeps_per_round: int,
    mode: str,
    *,
    cost: str = "sad",
    tiling: Tiling | None = None,
) -> torch.Tensor:
    """The level's regularization (``motion_framework.cpp:141-152``): while
    the block size is > 1, ``sweeps_per_round`` sweeps with lambda
    multiplier sweep + 1, then subdivide and double lambda.  Returns the
    stride-1 (B, h, w, 2) int32 grid.

    fourcolor and jacobi take f32(lam * (sweep + 1)) and the level's cost;
    exact takes f32(lam) * f32(sweep + 1) and SAD, as the reference does.
    Odd grids need no padding here: a colour's cells are sliced from the
    real grid, and the global bounds mask candidates beyond it.

    Tiles (the tiled engine, ``tiling``): ``im2`` is each tile's frame-2
    buffer, and the tiling's exchange gives the neighbouring tiles' edge
    rows (on 2-D tiles also their edge columns with the corners) before
    every step (the reference's ``make_gp`` / ``cell_exchange_2d``).
    ``exact`` refuses tiles.
    """
    b = grid.shape[0]
    if mode == "exact":
        if tiling is not None:
            raise ValueError("regularizer='exact' is a whole-frame raster sweep and cannot be "
                             "row-tiled")
        cur, lam = bs, lam0
        while cur > 1:
            with profiling.span("round", cur=cur):
                for sweep in range(sweeps_per_round):
                    grid = regularize_sweep(im1, im2, grid, cur, lam, sweep + 1, "exact")
            with profiling.span("subdivide"):
                grid = subdivide(grid)
            cur >>= 1
            lam *= 2.0
        return grid
    if mode == "jacobi":
        colors, stride = ((0, 0),), 1
    elif mode == "fourcolor":
        colors, stride = COLORS, 2
    else:
        raise ValueError(f"unknown regularizer mode: {mode}")
    grid = grid.clone()
    im2_row0, im2_col0 = (0, 0) if tiling is None else (tiling.im2_row0, tiling.im2_col0)
    cur, lam = bs, lam0
    while cur > 1:
        nby, nbx = grid.shape[1:3]
        with profiling.span("round", cur=cur):
            blocks = extract_blocks(im1, cur).reshape(b, nby, nbx, cur, cur)
            for sweep in range(sweeps_per_round):
                for ci, cj in colors:
                    strips = strips_at(grid, tiling, cur) if tiling is not None else None
                    step = dict(cur=cur, lam_mult=lam * (sweep + 1), stride=stride, cost=cost,
                                strips=strips, im2_row0=im2_row0, im2_col0=im2_col0)
                    if stride == 1:
                        update_color(grid, blocks, im2, ci=ci, cj=cj, **step)
                    else:
                        on_strips(update_color, grid, blocks, im2, ci=ci, cj=cj, **step)
        with profiling.span("subdivide"):
            grid = subdivide(grid)
        cur >>= 1
        lam *= 2.0
    return grid
