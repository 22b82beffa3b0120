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
"""

from __future__ import annotations

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

_I32_MAX = int(np.iinfo(np.int32).max)


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
    by = wy.clamp(0, h - bs).to(torch.int32)
    bx = wx.clamp(0, w - bs).to(torch.int32)
    b = by.shape[0]
    wins = _gather(im2, by.reshape(b, -1).contiguous(), bx.reshape(b, -1).contiguous(), bs, ext)
    return wins, by, bx


def block_origins(npy: int, npx: int, bs: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(1, npy, 1) and (1, 1, npx) int32 block origin rows and cols."""
    oy = (torch.arange(npy, device=dev, dtype=torch.int32) * bs)[None, :, None]
    ox = (torch.arange(npx, device=dev, dtype=torch.int32) * bs)[None, None, :]
    return oy, ox


def block_search_level(
    im1: torch.Tensor,   # (B, h, w) u8
    im2: torch.Tensor,   # (B, h, w) u8
    pred: torch.Tensor,  # (B, nby, nbx, 2) f32 predicted MVs (u, v) at block origins
    bs: int,
    ss: int,
    *,
    order: str = "spiral",
    cost: str = "sad",
) -> torch.Tensor:
    """One level's search: (B, nby, nbx, 2) int32 winning MVs (u, v).

    Spiral: the centre is origin + the prediction truncated toward zero; a
    centre whose block leaves the frame gives a zero MV; otherwise the
    minimum cost over the centre's [-S, S]^2 offsets, ties to the earliest
    spiral visit, out-of-frame offsets skipped.
    """
    if order == "raster":
        return _raster_search_level(im1, im2, pred, bs, ss, cost)
    if order != "spiral":
        raise ValueError(f"unknown search order: {order}")
    b, h, w = im1.shape
    nby, nbx = h // bs, w // bs
    ext = spiral_extent(ss - bs)
    oy, ox = block_origins(nby, nbx, bs, im1.device)
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy = torch.where(center_ok, cy, oy)
    cx = torch.where(center_ok, cx, ox)
    # these centres lie in [0, h - bs] x [0, w - bs]: the gather's clip
    # leaves them be, so each window is centred on its (cy, cx)
    windows = gather_windows(im2, cy, cx, bs, ext)[0]
    # zsad has no kernel (nor in the reference, which runs it in XLA): its
    # argmin is the plain version on every device
    argmin = sad_spiral_argmin_plain if cost == "zsad" else _sad_argmin
    best_dy, best_dx = argmin(im1, windows, cy.reshape(b, -1), cx.reshape(b, -1), bs, ss, cost)
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
) -> torch.Tensor:
    """The reference's exhaustive raster search (``motion_framework.cpp:246-294``).

    Every position of the clipped window of half-width sp = (ss - bs) >> 1
    (not the spiral extent) around the unclamped predicted centre, in raster
    order: the smaller cost wins, equal costs go to the smaller L1 distance
    to the SOURCE block, and remaining ties keep the first visit.  No
    zero-MV early-out: a window clipped away entirely keeps the predicted
    position.  Plain torch on every device (the reference runs it in XLA).
    """
    b, h, w = im1.shape
    nby, nbx = h // bs, w // bs
    sp = (ss - bs) >> 1
    oy, ox = block_origins(nby, nbx, bs, im1.device)
    cy = (oy + pred[..., 1].to(torch.int32)).reshape(b, -1)  # unclamped centres
    cx = (ox + pred[..., 0].to(torch.int32)).reshape(b, -1)
    blocks = extract_blocks(im1, bs).to(torch.int32)
    # the reference clips the column twice (the tiled form's local buffer)
    wins, by, bx = gather_windows(
        im2, cy.reshape(b, nby, nbx), cx.clamp(0, w - bs).reshape(b, nby, nbx), bs, sp
    )
    wins = wins.to(torch.int32)
    cyc, cxc = by.reshape(b, -1), bx.reshape(b, -1)
    oy1 = oy.expand(1, nby, nbx).reshape(1, -1)
    ox1 = ox.expand(1, nby, nbx).reshape(1, -1)
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
