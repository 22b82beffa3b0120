"""The fused windowed level: search + regularization from one set of volumes.

Port of ``blockbasedmotionestimation_tpu/ops/windowed.py:windowed_level`` on
its untiled path, with the batch dim written out.  Per level:

  1. one frame-2 window per parent, centred on the truncated prediction
     (kernel A, ``kernels.gather``);
  2. the pooled cost volumes of the main window (kernel B,
     ``kernels.cv_diff.pooled_cvs``);
  3. the spiral argmin over the cur = bs volume: min cost, then min spiral
     visit rank, out-of-image deltas masked (plain torch; XLA code in the
     reference too);
  4. with rival windows: each parent's rival centre (``pick_rival``) and its
     window (kernel A);
  5. the rounds, cur = bs, bs/2, ..., 2: ``sweeps_per_round`` sweeps of the
     four colour steps, then subdivide.

The form follows the reference's accelerator path.  With rival windows and
bs % 8 == 0 it is the **hybrid** form: the rival window stores only the
volumes of cur > fuse_max = min(16, bs/2) and cur = bs (kernel C,
``cv_diff.deep_pooled_cvs``); rounds cur > fuse_max run the colour step D
(``kernels.reg_step``) on stored volumes, rounds cur <= fuse_max run E
(``kernels.fused_step``), which recomputes rival candidates from the rival
window's pixels.  With ``store_radius`` (0 <= store_radius < ext) the cur=2
main volume is stored only for |dx delta| <= store_radius and the cur = 2
round runs F, which also recomputes the main-window candidates beyond that
band.  Otherwise (no rival windows, or bs % 8 != 0) every size of both
windows is stored and every round runs D/D'.  All forms give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.kernels.cv_diff import deep_pooled_cvs, pooled_cvs
from blockbasedmotionestimation_tpu_torch.kernels.fused_step import (
    color_step_hybrid,
    color_step_hybrid_tail,
)
from blockbasedmotionestimation_tpu_torch.kernels.reg_step import color_step
from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS, subdivide
from blockbasedmotionestimation_tpu_torch.ops.search import block_origins, gather_windows
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent, spiral_offsets

_I32_MAX = int(np.iinfo(np.int32).max)


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


def hybrid_form(bs: int, rival: bool) -> bool:
    """Whether a level takes the hybrid rival form (reference
    ``windowed_level``: rival windows and bs % 8 == 0)."""
    return rival and bs % 8 == 0


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
    hybrid: dict | None = None,
) -> torch.Tensor:
    """The subdivision rounds; consumes (pops) ``cvs``/``rcvs`` round by round.

    grid: (B, npy, npx, 2) int32 search winners; returns the stride-1
    (B, h, w, 2) int32 grid.  lambda is lam0 * (sweep + 1) in the first
    round and doubles every round; colours run (0,0), (0,1), (1,0), (1,1).
    ``hybrid`` (the hybrid form's rounds cur <= fuse_max) holds fuse_max,
    im1, the rival windows rwin, the cost and, with the stored band,
    store_r and the main windows win; the cur = 2 round reads them last.
    """
    cur, lam = bs, lam0
    grid = grid.contiguous()
    while cur > 1:
        cv = cvs.pop(cur)
        step, kw = color_step, dict(r=r)
        if hybrid is not None and cur <= hybrid["fuse_max"]:
            kw.update(im1=hybrid["im1"], rwin=hybrid["rwin"], rpm=rpm, r2=r2,
                      cost=hybrid["cost"])
            step = color_step_hybrid
            if cur == 2 and "store_r" in hybrid:
                step = color_step_hybrid_tail
                kw.update(win=hybrid["win"], store_r=hybrid["store_r"])
        elif rcvs is not None:
            kw.update(rcv=rcvs.pop(cur), rpm=rpm, r2=r2)
        for sweep in range(sweeps_per_round):
            for ci, cj in COLORS:
                step(grid, cv, pm, cur=cur, h=h, w=w, ci=ci, cj=cj,
                     lam_mult=lam * (sweep + 1), **kw)
        del cv, kw  # free the round's volumes before the next round
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
    store_radius: int | None = None,
) -> torch.Tensor:
    """Fused block search + windowed regularization; (B, h, w, 2) int32 grid."""
    _, h, w = im1.shape
    shift = ss - bs
    ext = spiral_offsets(shift)[2]
    oy, ox = block_origins(*pred.shape[1:3], bs, im1.device)

    # the spiral search's centre: origin + truncated prediction, with the
    # zero-MV early-out for centres outside the image
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy_safe = torch.where(center_ok, cy, oy)
    cx_safe = torch.where(center_ok, cx, ox)
    windows, by, bx = gather_windows(im2, cy_safe, cx_safe, bs, ext)
    base_mv = torch.stack([bx - ox, by - oy], dim=-1).contiguous()

    hybrid = None
    if hybrid_form(bs, rival):
        hybrid = dict(fuse_max=min(16, bs // 2), im1=im1, cost=cost)
        if store_radius is not None and 0 <= store_radius < ext:
            hybrid.update(store_r=store_radius, win=windows)
    cvs = pooled_cvs(im1, windows, bs, ext, cost,
                     store_r=None if hybrid is None else hybrid.get("store_r"))
    del windows  # the band's tail keeps its own reference
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
        if hybrid is None:
            rcvs = pooled_cvs(im1, rwindows, bs, r2, cost)
        else:
            rcvs = deep_pooled_cvs(im1, rwindows, bs, r2, cost, hybrid["fuse_max"])
            hybrid["rwin"] = rwindows
        del rwindows

    return rounds_loop(
        grid0, cvs, base_mv, bs, ext, h, w, lam0, sweeps_per_round,
        rcvs=rcvs, rpm=rbase, r2=r2, hybrid=hybrid,
    )


def windowed_schedule(
    im1: torch.Tensor,    # (B, h, w) u8
    im2: torch.Tensor,    # (B, h, w) u8
    grid0: torch.Tensor,  # (B, npy, npx, 2) int32 the level's search winners
    bs: int,
    ss: int,
    lam0: float,
    sweeps_per_round: int,
    *,
    cost: str = "sad",
    reg_radius: int | None = None,
    rival: bool = False,
    rival_radius: int | None = None,
) -> torch.Tensor:
    """The windowed rounds around the search winners (reference
    ``windowed_schedule``, untiled); (B, h, w, 2) int32 grid.

    One window per parent centred on origin + its search winner (kernel A),
    its volumes at radius r = min(reg_radius, S) (kernel B), and with rival
    windows the rival centre ``pick_rival(winners, winners, r)`` and its
    window and volumes at r2 = min(rival_radius, r).  Every volume is
    stored (the reference's dense form: no hybrid here), so the rounds run
    D/D' (or 8/9 without rival).  The rounds rebase candidates on the
    winners themselves, not on the clipped window centres (they differ only
    where a raster search kept an out-of-frame prediction); the rival's
    deltas rebase on its clipped centre.
    """
    _, h, w = im1.shape
    ext = spiral_extent(ss - bs)
    r = ext if reg_radius is None else min(reg_radius, ext)
    oy, ox = block_origins(*grid0.shape[1:3], bs, im1.device)
    parent_mv = grid0.contiguous()
    # the reference gathers (bs + 2S)^2 windows and reads their centre
    # (bs + 2r)^2 crop; the gather at radius r from the same clipped corner
    # yields that crop directly
    windows, _, _ = gather_windows(im2, oy + parent_mv[..., 1], ox + parent_mv[..., 0], bs, r)
    cvs = pooled_cvs(im1, windows, bs, r, cost)
    del windows

    rcvs = rbase = None
    r2 = r if rival_radius is None else min(rival_radius, r)
    if rival:
        rmv = pick_rival(parent_mv, parent_mv, r)
        rwindows, rvy, rvx = gather_windows(im2, oy + rmv[..., 1], ox + rmv[..., 0], bs, r2)
        rbase = torch.stack([rvx - ox, rvy - oy], dim=-1).contiguous()
        rcvs = pooled_cvs(im1, rwindows, bs, r2, cost)
        del rwindows

    return rounds_loop(
        parent_mv.clone(), cvs, parent_mv, bs, r, h, w, lam0, sweeps_per_round,
        rcvs=rcvs, rpm=rbase, r2=r2,
    )
