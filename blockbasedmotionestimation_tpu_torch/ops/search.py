"""Block search (``blockbasedmotionestimation_tpu/ops/search.py``).

The reference gathers one (bs + 2*ext)^2 window per parent from frame 2
zero-padded by ext, at a top-left clipped to the frame's block range
(``_gather_windows`` and its vmap rule).  Here the batch dim is explicit and
the gather is ``kernels.gather`` (kernel A).

``block_search_level`` is one level's search (the reference's
``calcLevelBM``): the spiral walk around the truncated prediction, whose
argmin is ``kernels.sad_search`` (kernel 7), or the exhaustive raster scan
(plain torch, as the reference runs it in XLA).  ``cost="zsad"`` runs the
spiral argmin's plain version on every device, with f32 costs, as the
reference runs zsad in XLA only.

On tiles (the tiled engine, ``tiling``: a ``Tiling``) ``im1`` is a batch
of tiles, ``im2`` their frame-2 buffers (each tile and its halo rows, and
on 2-D tiles its halo columns): block origins, centres and the in-frame
tests are the frame's, windows are cut from the buffer at centre -
(im2_row0, im2_col0) (reference ``block_search_level(full_h=, row0=,
im2_row0=, full_w=, col0=, im2_col0=)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.kernels.gather import gather_windows as _gather
from blockbasedmotionestimation_tpu_torch.kernels.sad_search import (
    block_cost,
    extract_blocks,
    sad_spiral_argmin_plain,
)
from blockbasedmotionestimation_tpu_torch.kernels.sad_search import (
    sad_spiral_argmin as _sad_argmin,
)
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent
from blockbasedmotionestimation_tpu_torch.utils import profiling

_I32_MAX = int(np.iinfo(np.int32).max)


class Tiling(NamedTuple):
    """A level's batch of tiles in its frame (``parallel.tiled``): each
    entry's first pixel row (B,) and its frame-2 buffer's, the frame's
    height, the same for columns (ints 0 and the tiles' width on row
    strips, which span the frame's columns), ``exchange(grid) -> (north,
    south, west, east)``, the ghost rows of a (B, nby, nbx, 2) grid and on
    2-D tiles its ghost columns over rows -1 .. nby (the corners; None on
    row strips), refreshed before every colour step, and
    ``rival_extend(vals)``, the search winners with a ring of one from the
    neighbouring tiles (``ops.windowed.pick_rival``)."""

    row0: torch.Tensor
    im2_row0: torch.Tensor
    full_h: int
    col0: torch.Tensor | int
    im2_col0: torch.Tensor | int
    full_w: int
    exchange: Callable
    rival_extend: Callable


def frame_of(tiling: Tiling | None, ht: int, wt: int):
    """(full_h, row0, im2_row0, full_w, col0, im2_col0) of a level's batch
    of ht x wt entries: the tiling's, or a whole frame's (ht, 0, 0, wt, 0,
    0)."""
    if tiling is None:
        return ht, 0, 0, wt, 0, 0
    return (tiling.full_h, tiling.row0, tiling.im2_row0, tiling.full_w, tiling.col0,
            tiling.im2_col0)


def gather_windows(
    im2: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, bs: int, ext: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windows around block origins (wy, wx) of (B, H, W) u8 frames.

    wy, wx: (B, npy, npx) integer block origins in frame coordinates.  They
    are clipped to [0, H - bs] x [0, W - bs]; returns (windows (B, npy*npx,
    win, win) u8, clipped wy, clipped wx) so callers can rebase on the
    window's actual centre.
    """
    _, h, w = im2.shape
    with profiling.span("gather"):
        by = wy.clamp(0, h - bs).to(torch.int32)
        bx = wx.clamp(0, w - bs).to(torch.int32)
        b = by.shape[0]
        wins = _gather(im2, by.reshape(b, -1).contiguous(), bx.reshape(b, -1).contiguous(), bs,
                       ext)
        return wins, by, bx


def block_origins(npy: int, npx: int, bs: int, dev, row0=0,
                  col0=0) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, npy, 1) and (1, 1, npx) int32 block origin rows and cols in the
    frame; rows (B, npy, 1) where ``row0`` is a (B,) tensor of tiles'
    first rows, cols (B, 1, npx) where ``col0`` is one of first cols."""
    oy = (torch.arange(npy, device=dev, dtype=torch.int32) * bs)[None, :, None]
    ox = (torch.arange(npx, device=dev, dtype=torch.int32) * bs)[None, None, :]
    return shifted(oy, row0), shifted(ox, col0)


def shifted(t: torch.Tensor, off) -> torch.Tensor:
    """t (B, npy, npx) + off: an int, or a (B,) tensor of tiles' row or
    column offsets; t itself for 0 (whole frames launch nothing more)."""
    if isinstance(off, torch.Tensor):
        return t + off.reshape(-1, 1, 1).to(torch.int32)
    return t + off if off else t


def frame_cols(cx: torch.Tensor, full_w: int, bs: int, im2_col0) -> torch.Tensor:
    """Window origin columns cx (frame columns) in a tile's frame-2 buffer:
    clipped to the frame's block range first, then moved to the buffer
    (reference ``clip(clip(cx, 0, w - bs) - im2_col0, ...)``; the gather
    clips into the buffer).  For whole frames and row strips the buffer's
    columns are the frame's, and cx itself is returned."""
    if isinstance(im2_col0, torch.Tensor) or im2_col0:
        return shifted(cx.clamp(0, full_w - bs), -im2_col0)
    return cx


def block_search_level(
    im1: torch.Tensor,   # (B, h, w) u8
    im2: torch.Tensor,   # (B, h, w) u8
    pred: torch.Tensor,  # (B, nby, nbx, 2) f32 predicted MVs (u, v) at block origins
    bs: int,
    ss: int,
    *,
    order: str = "spiral",
    cost: str = "sad",
    tiling: Tiling | None = None,
) -> torch.Tensor:
    """One level's search: (B, nby, nbx, 2) int32 winning MVs (u, v).

    Spiral: the centre is origin + the prediction truncated toward zero; a
    centre whose block leaves the frame gives a zero MV; otherwise the
    minimum cost over the centre's [-S, S]^2 offsets, ties to the earliest
    spiral visit, out-of-frame offsets skipped.  Tiles: see the module
    docstring.
    """
    if order == "raster":
        with profiling.span("search"):
            return _raster_search_level(im1, im2, pred, bs, ss, cost, tiling)
    if order != "spiral":
        raise ValueError(f"unknown search order: {order}")
    b, ht, wt = im1.shape
    h, row0, im2_row0, w, col0, im2_col0 = frame_of(tiling, ht, wt)
    nby, nbx = ht // bs, wt // bs
    ext = spiral_extent(ss - bs)
    oy, ox = block_origins(nby, nbx, bs, im1.device, row0, col0)
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy = torch.where(center_ok, cy, oy)
    cx = torch.where(center_ok, cx, ox)
    # these centres lie in the frame, and inside the buffer while the halo
    # covers the reach: the gather's clip leaves them be, so each window is
    # centred on its (cy, cx)
    windows = gather_windows(im2, shifted(cy, -im2_row0), shifted(cx, -im2_col0), bs, ext)[0]
    # zsad has no kernel (nor in the reference, which runs it in XLA): its
    # argmin is the plain version on every device
    argmin = sad_spiral_argmin_plain if cost == "zsad" else _sad_argmin
    with profiling.span("search"):
        best_dy, best_dx = argmin(im1, windows, cy.reshape(b, -1).contiguous(),
                                  cx.reshape(b, -1).contiguous(), bs, ss, cost, h, w)
    u = cx + best_dx.reshape(b, nby, nbx) - ext - ox
    v = cy + best_dy.reshape(b, nby, nbx) - ext - oy
    return torch.where(center_ok[..., None], torch.stack([u, v], dim=-1), 0).to(torch.int32)


def _raster_search_level(
    im1: torch.Tensor,
    im2: torch.Tensor,
    pred: torch.Tensor,
    bs: int,
    ss: int,
    cost: str,
    tiling: Tiling | None = None,
) -> torch.Tensor:
    """The reference's exhaustive raster search (``motion_framework.cpp:246-294``).

    Every position of the clipped window of half-width sp = (ss - bs) >> 1
    (not the spiral extent) around the unclamped predicted centre, in raster
    order: the smaller cost wins, equal costs go to the smaller L1 distance
    to the SOURCE block, and remaining ties keep the first visit.  No
    zero-MV early-out: a window clipped away entirely keeps the predicted
    position.  Plain torch on every device (the reference runs it in XLA).
    """
    b, ht, wt = im1.shape
    h, row0, im2_row0, w, col0, im2_col0 = frame_of(tiling, ht, wt)
    nby, nbx = ht // bs, wt // bs
    sp = (ss - bs) >> 1
    oy, ox = block_origins(nby, nbx, bs, im1.device, row0, col0)
    cy = (oy + pred[..., 1].to(torch.int32)).reshape(b, -1)  # unclamped centres
    cx = (ox + pred[..., 0].to(torch.int32)).reshape(b, -1)
    blocks = extract_blocks(im1, bs).to(torch.int32)
    # the reference clips the column twice: to the frame, then to the buffer
    wins, by, bx = gather_windows(
        im2, shifted(cy.reshape(b, nby, nbx), -im2_row0),
        shifted(cx.clamp(0, w - bs).reshape(b, nby, nbx), -im2_col0), bs, sp
    )
    wins = wins.to(torch.int32)
    cyc = shifted(by, im2_row0).reshape(b, -1)
    cxc = shifted(bx, im2_col0).reshape(b, -1)
    oy1 = oy.expand(oy.shape[0], nby, nbx).reshape(oy.shape[0], -1)
    ox1 = ox.expand(ox.shape[0], nby, nbx).reshape(ox.shape[0], -1)
    lo_y, hi_y = cy.sub(sp).clamp(min=0), cy.add(sp).clamp(max=h - bs)
    lo_x, hi_x = cx.sub(sp).clamp(min=0), cx.add(sp).clamp(max=w - bs)
    cdt = torch.float32 if cost == "zsad" else torch.int32  # zsad is f32-valued
    best = torch.full(cy.shape, _I32_MAX, dtype=cdt, device=im1.device)
    best_l1 = torch.full(cy.shape, _I32_MAX, dtype=torch.int32, device=im1.device)
    win_y, win_x = cy.clone(), cx.clone()
    side = 2 * sp + 1
    for dy in range(side):
        for dx in range(side):
            c = block_cost(blocks, wins[:, :, dy : dy + bs, dx : dx + bs], (2, 3), cost)
            py = cyc + (dy - sp)
            px = cxc + (dx - sp)
            ok = (py >= lo_y) & (py <= hi_y) & (px >= lo_x) & (px <= hi_x)
            c = torch.where(ok, c, _I32_MAX)
            l1 = torch.where(ok, (ox1 - px).abs() + (oy1 - py).abs(), _I32_MAX)
            better = (c < best) | ((c == best) & (l1 < best_l1))
            best = torch.where(better, c, best)
            best_l1 = torch.where(better, l1, best_l1)
            win_y = torch.where(better, py, win_y)
            win_x = torch.where(better, px, win_x)
    mv = torch.stack([win_x - ox1, win_y - oy1], dim=-1)
    return mv.reshape(b, nby, nbx, 2).to(torch.int32)
