"""The fused windowed level: search + regularization from one set of volumes.

Port of ``blockbasedmotionestimation_tpu/ops/windowed.py:windowed_level`` on
its untiled accelerator path, with the batch dim written out.  Per level:

  1. one frame-2 window per parent, centred on the truncated prediction
     (kernel A, ``kernels.gather``);
  2. the pooled cost volumes of the main window (``kernels.cv_diff``);
  3. the spiral argmin over the cur = bs volume: min cost, then min spiral
     visit rank, out-of-image deltas masked (plain torch; XLA code in the
     reference too);
  4. with rival windows: each parent's rival centre (``pick_rival``) and its
     window (kernel A);
  5. the rounds, cur = bs, bs/2, ..., 2: ``sweeps_per_round`` sweeps of the
     four colour steps, then subdivide.

The form follows the reference's dispatch, in its order:
  * ``compact`` = K (``cv_compact``), without rival windows and bs >= 8: the
    cur = bs volume alone (kernel 13, ``cv_diff.full_block_volume``), then
    per 128-parent chunk the K deltas the rounds can ask for
    (``ops.compact.chunk_delta_slots``) and K-slot tables of every cur < bs
    (kernel 14, ``cv_diff.compact_tables``); the f = 1 round runs D without
    rival on the volume, every other round kernel 10
    (``reg_step.color_round_compact``, each candidate's slot looked up in
    the level's ``ops.compact.slot_map``).  Candidates outside the slots are
    excluded: exact unless a chunk has more than K distinct deltas or a
    value travels further than ``compact_ring`` parents in the rounds.
  * ``fuse`` (``cv_fused``), bs % 8 == 0: with fuse_eff = min(fuse, bs/2),
    the main and rival windows store only cur > fuse_eff and cur = bs
    (kernel C); rounds cur > fuse_eff run D/D' on them, rounds
    cur <= fuse_eff run kernel 11 (``fused_step.color_round_fused``) or with
    rival windows kernel 12 (``color_round_fused_rival``), which recompute
    every candidate from the windows' pixels.  ``store_radius`` is ignored.
  * the **hybrid** form, rival windows and bs % 8 == 0 (the default): the
    rival window stores only cur > fuse_max = min(16, bs/2) and cur = bs
    (kernel C); rounds cur > fuse_max run D on stored volumes, rounds
    cur <= fuse_max run E (``fused_step.color_round_hybrid``), which
    recomputes rival candidates from the rival window's pixels.  With
    ``store_radius`` (0 <= store_radius < ext) the cur=2 main volume is
    stored only for |dx delta| <= store_radius and the cur = 2 round runs F,
    which also recomputes the main-window candidates beyond that band.
  * otherwise every size of both windows is stored (kernel B) and every
    round runs D/D'.  ``cost="zsad"`` always takes this dense-rival form,
    on the plain versions (``cv_diff.pooled_cvs_plain``,
    ``reg_step.color_round_stored_plain``, f32 volumes) on every device:
    no kernel computes zsad, and the reference runs it in XLA only.  Only
    the gathers (A) launch a kernel there.
Every round is one call of a round wrapper (``reg_step.color_round_stored``
for D, D', 8 and 9, ``reg_step.color_round_compact`` for 10,
``kernels.fused_step.color_round_*`` for E, F, 11 and 12).
All forms give the same bits (compact: while it excludes nothing).

Tiles (``parallel.tiled``, ``tiling``: an ``ops.search.Tiling``; reference
``windowed_level`` / ``windowed_schedule`` with ``full_h``, ``row0``,
``im2_row0``, ``rival_extend`` and ``cell_exchange``, and on 2-D tiles
``full_w``, ``col0``, ``im2_col0`` and ``cell_exchange_2d``): ``im1`` is a
batch of row strips or 2-D tiles, ``im2`` their frame-2 buffers.  Window
centres, origins and in-frame tests are the frame's (a window's column
clipped to the frame before it is moved into the buffer, as the reference
clips it); the rival pick reads the neighbouring tiles' winners through
the tiling's ``rival_extend``; its exchange refreshes each tile's ghost
rows (and ghost columns with their corners) before every colour step, so
a round runs as single steps (``rounds_loop``).  ``compact`` is ignored on tiles (the
reference's tiled levels pass none); the hybrid form, the band and
``fuse`` run there.
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.kernels.cv_diff import (
    compact_tables,
    deep_pooled_cvs,
    full_block_volume,
    pooled_cvs,
    pooled_cvs_plain,
)
from blockbasedmotionestimation_tpu_torch.kernels.fused_step import (
    color_round_fused,
    color_round_fused_rival,
    color_round_hybrid,
    color_round_hybrid_tail,
)
from blockbasedmotionestimation_tpu_torch.kernels.reg_step import (
    color_round_compact,
    color_round_stored,
    color_round_stored_plain,
)
from blockbasedmotionestimation_tpu_torch.ops.compact import chunk_delta_slots, slot_map
from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS, strips_at, subdivide
from blockbasedmotionestimation_tpu_torch.ops.search import (
    Tiling,
    block_origins,
    frame_cols,
    frame_of,
    gather_windows,
    shifted,
)
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent, spiral_offsets
from blockbasedmotionestimation_tpu_torch.utils import profiling

_I32_MAX = int(np.iinfo(np.int32).max)


def _edge_index(n: int, device) -> torch.Tensor:
    """Indices of 0..n-1 extended by one edge-replicated entry each side."""
    return torch.arange(-1, n + 1, device=device).clamp(0, n - 1)


def pick_rival(vals: torch.Tensor, base: torch.Tensor, r: int, extend=None) -> torch.Tensor:
    """Each parent's rival window centre (reference ``_pick_rival``).

    vals: (B, npy, npx, 2) int32 search winners; base: the same shape, the
    main window centres.  Picks the neighbour winner covering the most
    neighbours the main window excludes (excluded: Linf(val_k - base) > r;
    covered: Linf(val_k - val_j) <= r); ties go to the first neighbour in
    raster order; parents with no excluded neighbour keep base.  The
    neighbours of the edge parents replicate the edge; on tiles
    ``extend(vals)`` gives vals with a ring of one (B, npy + 2, npx + 2, 2):
    the neighbouring tiles' rows (on 2-D tiles, then their columns, which
    carry the corners), the edge replicated at the frame's edges
    (reference ``row_extend``).
    """
    _, npy, npx, _ = vals.shape
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    if extend is None:
        vp = vals[:, _edge_index(npy, vals.device)][:, :, _edge_index(npx, vals.device)]
    else:
        vp = extend(vals)
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
    # f32 (zsad) costs compare as f32, the others as int32; masked deltas
    # cost I32_MAX in either, as in the reference
    sad_m = torch.where(ok, sad if sad.dtype == torch.float32 else sad.to(torch.int32), _I32_MAX)
    order = np.full((side, side), _I32_MAX, dtype=np.int32)
    order[dys_np + ext, dxs_np + ext] = np.arange(side * side, dtype=np.int32)
    order_t = profiling.upload(order.reshape(-1), dev, "argmin")[None, :, None, None]
    best = sad_m.amin(dim=1, keepdim=True)
    oi = torch.where(sad_m == best, order_t, _I32_MAX).amin(dim=1).long()
    return (
        profiling.upload(dys_np, dev, "argmin")[oi],
        profiling.upload(dxs_np, dev, "argmin")[oi],
    )


def hybrid_form(bs: int, rival: bool) -> bool:
    """Whether a level takes the hybrid rival form (reference
    ``windowed_level``: rival windows and bs % 8 == 0)."""
    return rival and bs % 8 == 0


def rounds_loop(grid: torch.Tensor, bs: int, h: int, w: int, lam0: float,
                sweeps_per_round: int, round_of, tiling: Tiling | None = None) -> torch.Tensor:
    """The subdivision rounds, cur = bs, bs/2, ..., 2.

    grid: (B, npy, npx, 2) int32 search winners; returns the stride-1
    (B, h, w, 2) int32 grid.  ``round_of(cur)`` gives the round's wrapper,
    its positional arguments after the grid and its keywords (it may pop
    the round's volumes, so each is freed after its round).  The wrapper
    is a whole round, marked ``per_round`` (``reg_step.color_round_*``,
    ``kernels.fused_step.color_round_*``): it is called once with ``lam``
    and ``sweeps`` and runs sweep s at lam * (s + 1), colours (0,0),
    (0,1), (1,0), (1,1).  lambda is lam0 in the first round and doubles
    every round.

    On tiles (``tiling``, ``ops.search.Tiling``) each round runs its
    wrapper's single step (``.step``) colour by colour, at the same
    multipliers (Python's double lam * (s + 1), rounded to f32 on its way
    to the kernel), each step after the exchange refreshed the ghost rows
    and columns (``ops.regularize.strips_at``).
    """
    cur, lam = bs, lam0
    grid = grid.contiguous()
    while cur > 1:
        step, args, kw = round_of(cur)
        if not getattr(step, "per_round", False):
            raise TypeError(f"{step!r} is not a round wrapper (per_round)")
        with profiling.span("round", cur=cur):
            if tiling is None:
                step(grid, *args, cur=cur, h=h, w=w, lam=lam, sweeps=sweeps_per_round, **kw)
            else:
                for sweep in range(sweeps_per_round):
                    for ci, cj in COLORS:
                        step.step(grid, *args, cur=cur, h=h, w=w, ci=ci, cj=cj,
                                  lam_mult=lam * (sweep + 1),
                                  strips=strips_at(grid, tiling, cur), **kw)
        del args, kw  # free the round's volumes before the next round
        with profiling.span("subdivide"):
            grid = subdivide(grid).contiguous()
        cur >>= 1
        lam *= 2.0
    return grid


def _stored_round(cvs, pm, r, rcvs=None, rpm=None, r2=0, step=color_round_stored):
    """A round on stored volumes, D/D' (or 8/9 without ``rcvs``): one call
    of ``step`` a round (``color_round_stored``, or its plain version for
    zsad's f32 volumes)."""
    def round_of(cur):
        kw = dict(r=r)
        if rcvs is not None:
            kw.update(rcv=rcvs.pop(cur), rpm=rpm, r2=r2)
        return step, (cvs.pop(cur), pm), kw
    return round_of


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
    fuse: int | None = None,
    compact: int | None = None,
    compact_ring: int = 3,
    tiling: Tiling | None = None,
) -> torch.Tensor:
    """Fused block search + windowed regularization; (B, h, w, 2) int32 grid.

    ``fuse`` / ``compact`` / ``compact_ring`` are ``cv_fused`` /
    ``cv_compact`` / ``cv_compact_ring``; see the module docstring for the
    form each selects, and for the tiles.
    """
    _, ht, wt = im1.shape
    h, row0, im2_row0, w, col0, im2_col0 = frame_of(tiling, ht, wt)
    shift = ss - bs
    ext = spiral_offsets(shift)[2]
    oy, ox = block_origins(*pred.shape[1:3], bs, im1.device, row0, col0)
    tiled = tiling is not None
    rival_extend = tiling.rival_extend if tiled else None

    # the spiral search's centre: origin + truncated prediction, with the
    # zero-MV early-out for centres outside the image
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    center_ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    cy_safe = torch.where(center_ok, cy, oy)
    cx_safe = torch.where(center_ok, cx, ox)
    windows, by, bx = gather_windows(im2, shifted(cy_safe, -im2_row0),
                                     shifted(cx_safe, -im2_col0), bs, ext)
    base_mv = torch.stack([shifted(bx, im2_col0) - ox, shifted(by, im2_row0) - oy],
                          dim=-1).contiguous()

    # zsad has no kernel, nor in the reference, which runs it in XLA only:
    # the dense-rival form on the plain versions, whatever the capacity
    # options and the band say
    plain = cost == "zsad"
    volumes = pooled_cvs_plain if plain else pooled_cvs
    use_compact = not plain and not tiled and compact is not None and not rival and bs >= 8
    fuse_eff = (min(fuse, bs // 2) if not plain and fuse is not None and not use_compact
                and bs % 8 == 0 else 0)
    hybrid = not plain and not use_compact and not fuse_eff and hybrid_form(bs, rival)
    fuse_max = min(16, bs // 2)  # the hybrid form's finest stored size
    store_r = None
    if hybrid and store_radius is not None and 0 <= store_radius < ext:
        store_r = store_radius
    with profiling.span("volumes"):
        if use_compact:
            cvs = full_block_volume(im1, windows, bs, ext, cost)
        elif fuse_eff:
            cvs = deep_pooled_cvs(im1, windows, bs, ext, cost, fuse_eff)
        else:
            cvs = volumes(im1, windows, bs, ext, cost, store_r=store_r)
            if store_r is None:
                windows = None  # only the tables, the fused steps and F read them
    with profiling.span("argmin"):
        best_dy, best_dx = spiral_argmin(cvs[bs], cy_safe, cx_safe, shift, bs, h, w)
        u = torch.where(center_ok, cx_safe + best_dx - ox, 0)
        v = torch.where(center_ok, cy_safe + best_dy - oy, 0)
        grid0 = torch.stack([u, v], dim=-1).to(torch.int32)

    if use_compact:
        with profiling.span("volumes"):
            slots = chunk_delta_slots(grid0, base_mv, ext, compact, compact_ring)
            smap = slot_map(slots, ext)
            tables = compact_tables(im1, windows, slots, bs, ext, cost)
        windows = None
        dense = _stored_round(cvs, base_mv, ext)

        def round_of(cur):
            if cur == bs:
                return dense(cur)
            return (color_round_compact, (tables.pop(cur), base_mv, slots),
                    dict(r=ext, smap=smap))

        return rounds_loop(grid0, bs, ht, wt, lam0, sweeps_per_round, round_of)

    rcvs = rbase = rwindows = None
    r2 = ext if rival_radius is None else min(rival_radius, ext)
    if rival:
        # rival centres from the search winners: at a discontinuity the
        # winner snaps to the local motion, so the most-covering neighbour
        # winner is the foreign motion mode
        with profiling.span("rival"):
            rmv = pick_rival(grid0, base_mv, ext, rival_extend)
            rwindows, rvy, rvx = gather_windows(
                im2, shifted(oy + rmv[..., 1], -im2_row0),
                frame_cols(ox + rmv[..., 0], w, bs, im2_col0), bs, r2
            )
            rbase = torch.stack([shifted(rvx, im2_col0) - ox, shifted(rvy, im2_row0) - oy],
                                dim=-1).contiguous()
            if fuse_eff or hybrid:
                rcvs = deep_pooled_cvs(im1, rwindows, bs, r2, cost, fuse_eff or fuse_max)
            else:
                rcvs = volumes(im1, rwindows, bs, r2, cost)
                rwindows = None
    stored = _stored_round(cvs, base_mv, ext, rcvs, rbase, r2,
                           step=color_round_stored_plain if plain else color_round_stored)
    if fuse_eff:
        fkw = dict(im1=im1, win=windows, r=ext, cost=cost)
        if rival:
            fkw.update(rwin=rwindows, rpm=rbase, r2=r2)

        def round_of(cur):
            if cur > fuse_eff:
                return stored(cur)
            return (color_round_fused_rival if rival else color_round_fused), (base_mv,), fkw

        return rounds_loop(grid0, bs, ht, wt, lam0, sweeps_per_round, round_of, tiling)
    if not hybrid:
        return rounds_loop(grid0, bs, ht, wt, lam0, sweeps_per_round, stored, tiling)
    hkw = dict(im1=im1, rwin=rwindows, rpm=rbase, r=ext, r2=r2, cost=cost)

    def round_of(cur):
        if cur > fuse_max:
            return stored(cur)
        if cur == 2 and store_r is not None:
            return (color_round_hybrid_tail, (cvs.pop(cur), base_mv),
                    dict(hkw, win=windows, store_r=store_r))
        return color_round_hybrid, (cvs.pop(cur), base_mv), hkw

    return rounds_loop(grid0, bs, ht, wt, lam0, sweeps_per_round, round_of, tiling)


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
    tiling: Tiling | None = None,
) -> torch.Tensor:
    """The windowed rounds around the search winners (reference
    ``windowed_schedule``); (B, h, w, 2) int32 grid.  Tiles: see the
    module docstring.

    One window per parent centred on origin + its search winner (kernel A),
    its volumes at radius r = min(reg_radius, S) (kernel B), and with rival
    windows the rival centre ``pick_rival(winners, winners, r)`` and its
    window and volumes at r2 = min(rival_radius, r).  Every volume is
    stored (the reference's dense form: no hybrid here), so the rounds run
    D/D' (or 8/9 without rival); for zsad the volumes and rounds are the
    plain versions.  The rounds rebase candidates on the
    winners themselves, not on the clipped window centres (they differ only
    where a raster search kept an out-of-frame prediction); the rival's
    deltas rebase on its clipped centre.
    """
    _, ht, wt = im1.shape
    _, row0, im2_row0, w, col0, im2_col0 = frame_of(tiling, ht, wt)
    ext = spiral_extent(ss - bs)
    r = ext if reg_radius is None else min(reg_radius, ext)
    oy, ox = block_origins(*grid0.shape[1:3], bs, im1.device, row0, col0)
    parent_mv = grid0.contiguous()
    # the reference gathers (bs + 2S)^2 windows and reads their centre
    # (bs + 2r)^2 crop; the gather at radius r from the same clipped corner
    # yields that crop directly
    windows, _, _ = gather_windows(im2, shifted(oy + parent_mv[..., 1], -im2_row0),
                                   frame_cols(ox + parent_mv[..., 0], w, bs, im2_col0), bs, r)
    # zsad: the plain volumes and rounds (no kernel computes it)
    plain = cost == "zsad"
    volumes = pooled_cvs_plain if plain else pooled_cvs
    with profiling.span("volumes"):
        cvs = volumes(im1, windows, bs, r, cost)
    del windows

    rcvs = rbase = None
    r2 = r if rival_radius is None else min(rival_radius, r)
    if rival:
        with profiling.span("rival"):
            rmv = pick_rival(parent_mv, parent_mv, r,
                             None if tiling is None else tiling.rival_extend)
            rwindows, rvy, rvx = gather_windows(im2, shifted(oy + rmv[..., 1], -im2_row0),
                                                frame_cols(ox + rmv[..., 0], w, bs, im2_col0),
                                                bs, r2)
            rbase = torch.stack([shifted(rvx, im2_col0) - ox, shifted(rvy, im2_row0) - oy],
                                dim=-1).contiguous()
            rcvs = volumes(im1, rwindows, bs, r2, cost)
        del rwindows

    step = color_round_stored_plain if plain else color_round_stored
    return rounds_loop(parent_mv.clone(), bs, ht, wt, lam0, sweeps_per_round,
                       _stored_round(cvs, parent_mv, r, rcvs, rbase, r2, step=step), tiling)
