"""The fused windowed level: search + regularization from one set of volumes.

Port of ``blockbasedmotionestimation_tpu/ops/windowed.py:windowed_level`` on
its untiled path, with the batch dim written out.  Per level:

  1. one frame-2 window per parent, centred on the truncated prediction
     (kernel A, ``kernels.gather``);
  2. the pooled cost volumes at every sub-block size (kernel B,
     ``kernels.cv_diff``);
  3. the spiral argmin over the cur = bs volume: min cost, then min spiral
     visit rank, out-of-image deltas masked (plain torch; XLA code in the
     reference too);
  4. with rival windows: each parent's rival centre (``pick_rival``), its
     window (kernel A) and volumes (kernel B);
  5. the rounds, cur = bs, bs/2, ..., 2: ``sweeps_per_round`` sweeps of the
     four colour steps (kernel D, ``kernels.reg_step``), then subdivide.

The reference's TPU default recomputes the rival (and far main) candidates of
the sub-block rounds from window slabs instead of storing their volumes; it
is bit-exact against the dense volumes used here (``cv_store_radius`` and the
hybrid rival path therefore change nothing in this port).
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu.ops.spiral import spiral_offsets
from blockbasedmotionestimation_tpu_torch.kernels.cv_diff import pooled_cvs
from blockbasedmotionestimation_tpu_torch.kernels.reg_step import color_step
from blockbasedmotionestimation_tpu_torch.ops.search import gather_windows

_I32_MAX = int(np.iinfo(np.int32).max)
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _edge_index(n: int, device) -> torch.Tensor:
    """Indices of 0..n-1 extended by one edge-replicated entry each side."""
    return torch.arange(-1, n + 1, device=device).clamp(0, n - 1)


def pick_rival(vals: torch.Tensor, base: torch.Tensor, r: int) -> torch.Tensor:
    """Each parent's rival window centre (reference ``_pick_rival``).

    vals: (B, npy, npx, 2) int32 search winners; base: the same shape, the
    main window centres.  Picks the neighbour winner covering the most
    neighbours the main window excludes (excluded: Linf(val_k - base) > r;
    covered: Linf(val_k - val_j) <= r); ties go to the first neighbour in
    raster order; parents with no excluded neighbour keep base.
    """
    _, npy, npx, _ = vals.shape
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    vp = vals[:, _edge_index(npy, vals.device)][:, :, _edge_index(npx, vals.device)]
    neigh = torch.stack(
        [vp[:, 1 + dy : 1 + dy + npy, 1 + dx : 1 + dx + npx] for dy, dx in offs]
    )  # (8, B, npy, npx, 2)
    excl = (neigh - base[None]).abs().amax(dim=-1) > r  # (8, B, npy, npx)
    d = (neigh[:, None] - neigh[None, :]).abs().amax(dim=-1)  # (k, j, B, npy, npx)
    score = ((d <= r) & excl[:, None]).sum(dim=0)  # (j, B, npy, npx)
    j = score.argmax(dim=0)
    rival = torch.take_along_dim(neigh, j[None, ..., None], dim=0)[0]
    return torch.where((score.amax(dim=0) > 0)[..., None], rival, base)


def spiral_argmin(
    sad: torch.Tensor,  # (B, side^2, npy, npx) cur = bs volume
    cy: torch.Tensor,   # (B, npy, npx) window centre rows (block origins)
    cx: torch.Tensor,
    shift: int,
    bs: int,
    h: int,
    w: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Winning (dy, dx) per parent: min cost, then earliest spiral visit."""
    dys_np, dxs_np, ext = spiral_offsets(shift)
    side = 2 * ext + 1
    dev = sad.device
    didx = torch.arange(side * side, device=dev)
    dy_of = (didx // side - ext)[None, :, None, None]
    dx_of = (didx % side - ext)[None, :, None, None]
    ty = cy[:, None] + dy_of
    tx = cx[:, None] + dx_of
    ok = (ty >= 0) & (ty <= h - bs) & (tx >= 0) & (tx <= w - bs)
    sad_m = torch.where(ok, sad.to(torch.int32), _I32_MAX)
    order = np.full((side, side), _I32_MAX, dtype=np.int32)
    order[dys_np + ext, dxs_np + ext] = np.arange(side * side, dtype=np.int32)
    order_t = torch.as_tensor(order.reshape(-1), device=dev)[None, :, None, None]
    best = sad_m.amin(dim=1, keepdim=True)
    oi = torch.where(sad_m == best, order_t, _I32_MAX).amin(dim=1).long()
    return (
        torch.as_tensor(dys_np, device=dev)[oi],
        torch.as_tensor(dxs_np, device=dev)[oi],
    )


def subdivide(grid: torch.Tensor) -> torch.Tensor:
    """Each block's MV to its 2x2 children: (B, n, m, 2) -> (B, 2n, 2m, 2)."""
    return grid.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def rounds_loop(
    grid: torch.Tensor,
    cvs: dict[int, torch.Tensor],
    pm: torch.Tensor,
    bs: int,
    r: int,
    h: int,
    w: int,
    lam0: float,
    sweeps_per_round: int,
    rcvs: dict[int, torch.Tensor] | None = None,
    rpm: torch.Tensor | None = None,
    r2: int = 0,
) -> torch.Tensor:
    """The subdivision rounds; consumes (pops) ``cvs``/``rcvs`` round by round.

    grid: (B, npy, npx, 2) int32 search winners; returns the stride-1
    (B, h, w, 2) int32 grid.  lambda is lam0 * (sweep + 1) in the first
    round and doubles every round; colours run (0,0), (0,1), (1,0), (1,1).
    """
    cur, lam = bs, lam0
    grid = grid.contiguous()
    while cur > 1:
        cv = cvs.pop(cur)
        rcv = rcvs.pop(cur) if rcvs is not None else None
        for sweep in range(sweeps_per_round):
            for ci, cj in COLORS:
                color_step(
                    grid, cv, pm, cur=cur, h=h, w=w, r=r, ci=ci, cj=cj,
                    lam_mult=lam * (sweep + 1), rcv=rcv, rpm=rpm, r2=r2,
                )
        del cv, rcv  # free the round's volumes before the next round
        grid = subdivide(grid).contiguous()
        cur >>= 1
        lam *= 2.0
    return grid


def windowed_level(
    im1: torch.Tensor,   # (B, h, w) u8
    im2: torch.Tensor,   # (B, h, w) u8
    pred: torch.Tensor,  # (B, npy, npx, 2) f32 predicted MVs at block origins
    bs: int,
    ss: int,
    lam0: float,
    sweeps_per_round: int,
    *,
    cost: str = "sad",
    rival: bool = False,
    rival_radius: int | None = None,
) -> torch.Tensor:
    """Fused block search + windowed regularization; (B, h, w, 2) int32 grid."""
    _, h, w = im1.shape
    shift = ss - bs
    ext = spiral_offsets(shift)[2]
    npy, npx = pred.shape[1:3]
    dev = im1.device
    oy = (torch.arange(npy, device=dev, dtype=torch.int32) * bs)[None, :, None]
    ox = (torch.arange(npx, device=dev, dtype=torch.int32) * bs)[None, None, :]

    # the spiral search's centre: origin + truncated prediction, with the
    # zero-MV early-out for centres outside the image
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy_safe = torch.where(center_ok, cy, oy)
    cx_safe = torch.where(center_ok, cx, ox)
    windows, by, bx = gather_windows(im2, cy_safe, cx_safe, bs, ext)
    base_mv = torch.stack([bx - ox, by - oy], dim=-1).contiguous()

    cvs = pooled_cvs(im1, windows, bs, ext, cost)
    del windows
    best_dy, best_dx = spiral_argmin(cvs[bs], cy_safe, cx_safe, shift, bs, h, w)
    u = torch.where(center_ok, cx_safe + best_dx - ox, 0)
    v = torch.where(center_ok, cy_safe + best_dy - oy, 0)
    grid0 = torch.stack([u, v], dim=-1).to(torch.int32)

    rcvs = rbase = None
    r2 = ext if rival_radius is None else min(rival_radius, ext)
    if rival:
        # rival centres from the search winners: at a discontinuity the
        # winner snaps to the local motion, so the most-covering neighbour
        # winner is the foreign motion mode
        rmv = pick_rival(grid0, base_mv, ext)
        rwindows, rvy, rvx = gather_windows(
            im2, oy + rmv[..., 1], ox + rmv[..., 0], bs, r2
        )
        rbase = torch.stack([rvx - ox, rvy - oy], dim=-1).contiguous()
        rcvs = pooled_cvs(im1, rwindows, bs, r2, cost)
        del rwindows

    return rounds_loop(
        grid0, cvs, base_mv, bs, ext, h, w, lam0, sweeps_per_round,
        rcvs=rcvs, rpm=rbase, r2=r2,
    )
