"""Frame-2 search windows (``blockbasedmotionestimation_tpu/ops/search.py``).

The reference gathers one (bs + 2*ext)^2 window per parent from frame 2
zero-padded by ext, at a top-left clipped to the frame's block range
(``_gather_windows`` and its vmap rule).  Here the batch dim is explicit and
the gather is ``kernels.gather`` (kernel A).
"""

from __future__ import annotations

import torch

from blockbasedmotionestimation_tpu_torch.kernels.gather import gather_windows as _gather


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
