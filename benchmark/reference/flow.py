"""Plain PyTorch reference of the motion estimator, for the benchmark's check.

A frozen, self-contained restatement of the estimator's plain path (the
reference driver: OpenCV's bilinear upscale of both frames by
``interp_factor``, pad, a Gaussian pyramid, per level coarsest to finest
the windowed search and regularization, then every ``interp_factor``-th
pixel of the unpadded field divided by the factor), written with torch tensor
operations only.  It imports nothing of the code under test, so a change to
that code cannot change what it is held to.  It runs the simplest form of
each level, every cost volume stored, which gives the same bits as the
program's stored-band, hybrid and fused forms:

  * ``window_center="pred"`` (the fused windowed level): one frame-2 window
    per parent around the truncated prediction, its pooled SAD volumes at
    every sub-block size, the spiral argmin over the cur = bs volume, the
    rival window around the most-covering neighbour winner and its volumes,
    then the rounds cur = bs .. 2 on the stored volumes;
  * ``window_center="search"``: the spiral search over the full (bs + 2S)^2
    window per block first, then windows around the winners and the same
    rounds (the reference program's own order).

A round is ``sweeps_per_round`` sweeps of the four colour steps; a colour
step scores each cell's 9 candidates (own and 8 neighbours, the reference
program's border-case order) by cost + lambda * sum of L1 distances to the
present candidates and keeps the lexicographic (energy, visit rank) minimum.
The energy is float32, as the configuration states; ``energy_dtype`` lowers
it for the benchmark's control, which must fail the comparison.

Supported: costs ``sad`` and ``ssd``, ``regularizer="windowed"``, spiral
search, any ``interp_factor``, any block and search sizes, ``mv_cap``, rival
windows on or off.  Anything else raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_I32_MAX = int(np.iinfo(np.int32).max)
_BIG_RANK = 127
_PYR_KERNEL = (1, 4, 6, 4, 1)
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))
# candidate slots (dy, dx): own MV first, then the 8 neighbours in the
# reference program's gather order
SLOTS = ((0, 0), (0, -1), (0, 1), (1, 1), (-1, -1), (-1, 1), (-1, 0), (1, 0), (1, -1))
_CASE_ORDERINGS = (
    SLOTS,                                                   # interior
    ((0, 0), (0, -1), (0, 1), (1, 1), (1, 0), (1, -1)),      # top row
    ((0, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (-1, 0)),   # bottom row
    ((0, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (1, 0)),      # left column
    ((0, 0), (0, -1), (-1, -1), (-1, 0), (1, 0), (1, -1)),   # right column
    ((0, 0), (0, 1), (1, 1), (1, 0)),                         # top-left
    ((0, 0), (0, -1), (1, 0), (1, -1)),                       # top-right
    ((0, 0), (0, 1), (-1, 1), (-1, 0)),                       # bottom-left
    ((0, 0), (0, -1), (-1, -1), (-1, 0)),                     # bottom-right
)


class Settings:
    """The estimator settings the reference reads, from a configuration's
    ``motion_config`` fields (a plain dict)."""

    def __init__(self, fields: dict):
        self.block_sizes = tuple(fields["block_sizes"])
        self.search_sizes = tuple(fields["search_sizes"])
        self.cost = fields["cost"]
        self.sweeps = int(fields["sweeps_per_round"])
        self.lambda_scale = float(fields["lambda_scale"])
        self.reg_radius = fields["reg_radius"]
        self.window_center = fields["window_center"]
        self.rival = bool(fields["rival_window"])
        self.rival_radius = fields["rival_radius"]
        self.mv_cap = fields["mv_cap"]
        self.interp = int(fields["interp_factor"])
        unsupported = {
            "cost": self.cost not in ("sad", "ssd"),
            "interp_factor": self.interp < 1,
            "regularizer": fields["regularizer"] != "windowed",
            "search_order": fields["search_order"] != "spiral",
            "window_center": self.window_center not in ("pred", "search"),
            "cv_compact": fields["cv_compact"] is not None,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"the reference does not cover {bad} = "
                             f"{[fields[k] for k in bad]}")

    def rival_radius_at(self, level: int):
        if isinstance(self.rival_radius, (list, tuple)):
            return self.rival_radius[min(level, len(self.rival_radius) - 1)]
        return self.rival_radius


# --- spiral visit order -----------------------------------------------------

def _spiral_visits(shift: int) -> list[tuple[int, int]]:
    """The reference program's spiral walk: right m, down m, left m+1, up
    m+1 for m = 1, 3, ... < shift, then a final (m-1)-step run right."""
    visits, x, y, m = [(0, 0)], 0, 0, 1
    while m < shift:
        for dx, dy, n in ((1, 0, m), (0, 1, m), (-1, 0, m + 1), (0, -1, m + 1)):
            for _ in range(n):
                x += dx
                y += dy
                visits.append((y, x))
        m += 2
    for _ in range(max(0, m - 1)):
        x += 1
        visits.append((y, x))
    return visits


@functools.lru_cache(maxsize=None)
def spiral_offsets(shift: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Each (dy, dx) of the [-S, S]^2 square once, in first-visit order, and S."""
    seen, dys, dxs = set(), [], []
    for v in _spiral_visits(shift):
        if v not in seen:
            seen.add(v)
            dys.append(v[0])
            dxs.append(v[1])
    ext = max(max(abs(a), abs(b)) for a, b in seen)
    if len(dys) != (2 * ext + 1) ** 2:
        raise AssertionError("the spiral must tile its square")
    return np.asarray(dys, np.int32), np.asarray(dxs, np.int32), ext


# --- frames -----------------------------------------------------------------

def padded_dims(h: int, w: int, block_sizes) -> tuple[int, int]:
    """Smallest (H', W') >= (h, w) with H', W' multiples of 2^i * bs_i at
    every level i, growing one row or column at a time (the reference
    program's search)."""
    th, tw = h, w
    while True:
        rh = sum(th % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        rw = sum(tw % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        if rh == 0 and rw == 0:
            break
        th, tw = th + (rh != 0), tw + (rw != 0)
        if th >= 2 * h + 1 or tw == 2 * w:
            raise ValueError("no padded size fits the block sizes")
    if (th - h) % 2 or (tw - w) % 2:
        raise ValueError(f"odd padding {th - h}x{tw - w}")
    return th, tw


def _reflect101(n: int) -> np.ndarray:
    idx = np.abs(np.arange(-2, n + 2))
    return np.where(idx >= n, 2 * (n - 1) - idx, idx).astype(np.int64)


def pyrdown(image: torch.Tensor) -> torch.Tensor:
    """OpenCV's pyrDown of (B, H, W) uint8: 5-tap [1 4 6 4 1] both ways,
    reflect-101 borders, (acc + 128) >> 8."""
    h, w = image.shape[-2:]
    x = (image.index_select(-2, torch.as_tensor(_reflect101(h), device=image.device))
         .index_select(-1, torch.as_tensor(_reflect101(w), device=image.device))
         .to(torch.int32))
    acc_v = sum(k * x[..., t:t + h:2, :] for t, k in enumerate(_PYR_KERNEL))
    acc = sum(k * acc_v[..., t:t + w:2] for t, k in enumerate(_PYR_KERNEL))
    return ((acc + 128) >> 8).to(torch.uint8)


def _resize_coords(src_n: int, dst_n: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's half-pixel source coordinate of each destination pixel,
    ``(d + 0.5) * scale - 0.5`` in float32: (integer part, fraction)."""
    d = np.arange(dst_n, dtype=np.float64)
    f = ((d + 0.5) * (src_n / dst_n) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s


def _coefs(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two taps' weights in 11-bit fixed point, rounded half to even."""
    return (np.rint((1.0 - frac) * 2048.0).astype(np.int32),
            np.rint(frac * 2048.0).astype(np.int32))


def upscale(image: torch.Tensor, f: int) -> torch.Tensor:
    """OpenCV's ``resize(src, dst, Size(), f, f, INTER_LINEAR)`` of (B, H, W)
    uint8.  Across: two taps, a fraction that is zero at the edge columns,
    summed in int32.  Down: the row indices clamped but not the fraction,
    and OpenCV's 8-bit vertical pass, ``(((b0 * (r0 >> 4)) >> 16) + ((b1 *
    (r1 >> 4)) >> 16) + 2) >> 2``."""
    h, w = image.shape[-2:]
    dev = image.device
    sx, fx = _resize_coords(w, w * f)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0.0), fx)
    x0 = np.clip(sx, 0, w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    a0, a1 = _coefs(fx)
    sy, fy = _resize_coords(h, h * f)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    b0, b1 = _coefs(fy)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    x = image.to(torch.int32)
    row = x.index_select(-1, t(x0)) * t(a0) + x.index_select(-1, t(x1)) * t(a1)
    r0, r1 = row.index_select(-2, t(y0)), row.index_select(-2, t(y1))
    out = (((t(b0)[:, None] * (r0 >> 4)) >> 16) + ((t(b1)[:, None] * (r1 >> 4)) >> 16)
           + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def gather(im2: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor, bs: int, ext: int):
    """Frame-2 windows of edge bs + 2 ext whose block corner is (wy, wx),
    clipped into the frame; outside the frame reads 0.  Returns the windows
    (B, nP, win, win) and the clipped corners (B, npy, npx)."""
    b, h, w = im2.shape
    by = wy.clamp(0, h - bs).to(torch.int32)
    bx = wx.clamp(0, w - bs).to(torch.int32)
    win = bs + 2 * ext
    im2p = F.pad(im2, (ext, ext, ext, ext), value=0)
    ar = torch.arange(win, device=im2.device)
    rows = by.reshape(b, -1).long()[..., None] + ar
    cols = bx.reshape(b, -1).long()[..., None] + ar
    bidx = torch.arange(b, device=im2.device)[:, None, None, None]
    return im2p[bidx, rows[..., :, None], cols[..., None, :]], by, bx


def _origins(npy: int, npx: int, bs: int, dev):
    oy = (torch.arange(npy, device=dev, dtype=torch.int32) * bs)[None, :, None]
    ox = (torch.arange(npx, device=dev, dtype=torch.int32) * bs)[None, None, :]
    return oy, ox


# --- cost volumes -----------------------------------------------------------

def _vol_dtype(cur: int, cost: str) -> torch.dtype:
    peak = (255 * 255 if cost == "ssd" else 255) * cur * cur
    return torch.uint16 if peak < (1 << 16) else torch.int32


def volumes(im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str,
            only_bs: bool = False):
    """{cur: (B, side^2, h/cur, w/cur)} pooled costs for cur = 2 .. bs (only
    cur = bs with ``only_bs``): entry [b, (dy+r)*side + (dx+r), py*f + sy,
    px*f + sx] is the cost of sub-block (sy, sx) of parent (py, px) against
    the window moved by (dy, dx), f = bs // cur.  One delta row at a time;
    each size pools the one below 2x2."""
    b, h, w = im1.shape
    npy, npx = h // bs, w // bs
    side = 2 * r + 1
    patches = (im1.reshape(b, npy, bs, npx, bs).permute(0, 1, 3, 2, 4)
               .reshape(b, npy * npx, 1, bs, bs).to(torch.int32))
    curs = [bs] if only_bs else [1 << k for k in range(1, bs.bit_length())]
    out = {c: torch.empty((b, side * side, h // c, w // c), dtype=_vol_dtype(c, cost),
                          device=im1.device) for c in curs}
    for dyi in range(side):
        shifted = (windows[:, :, dyi:dyi + bs].unfold(-1, bs, 1).permute(0, 1, 3, 2, 4)
                   .to(torch.int32))
        d = patches - shifted
        cvr = d.abs() if cost == "sad" else d * d
        if only_bs:
            vol = cvr.sum(dim=(3, 4), dtype=torch.int32).reshape(b, npy, npx, side)
            out[bs][:, dyi * side:(dyi + 1) * side] = vol.permute(0, 3, 1, 2)
            continue
        cur = 1
        while cur < bs:
            n = bs // cur
            # int32 holds every pooled cost (at most 255^2 * 128^2)
            cvr = cvr.reshape(b, npy * npx, side, n // 2, 2, n // 2, 2).sum(
                dim=(4, 6), dtype=torch.int32)
            cur *= 2
            f = bs // cur
            vol = (cvr.reshape(b, npy, npx, side, f, f).permute(0, 3, 1, 4, 2, 5)
                   .reshape(b, side, npy * f, npx * f))
            out[cur][:, dyi * side:(dyi + 1) * side] = vol.to(out[cur].dtype)
    return out


def spiral_argmin(sad, cy, cx, shift: int, bs: int, h: int, w: int):
    """Per parent the (dy, dx) of least cost over the cur = bs volume,
    ties to the earliest spiral visit; deltas whose block leaves the frame
    are masked."""
    dys, dxs, ext = spiral_offsets(shift)
    side = 2 * ext + 1
    dev = sad.device
    didx = torch.arange(side * side, device=dev)
    ty = cy[:, None] + (didx // side - ext)[None, :, None, None]
    tx = cx[:, None] + (didx % side - ext)[None, :, None, None]
    ok = (ty >= 0) & (ty <= h - bs) & (tx >= 0) & (tx <= w - bs)
    sad_m = torch.where(ok, sad.to(torch.int32), _I32_MAX)
    order = np.full((side, side), _I32_MAX, dtype=np.int32)
    order[dys + ext, dxs + ext] = np.arange(side * side, dtype=np.int32)
    order_t = torch.as_tensor(order.reshape(-1), device=dev)[None, :, None, None]
    best = sad_m.amin(dim=1, keepdim=True)
    oi = torch.where(sad_m == best, order_t, _I32_MAX).amin(dim=1).long()
    return torch.as_tensor(dys, device=dev)[oi], torch.as_tensor(dxs, device=dev)[oi]


def pick_rival(vals: torch.Tensor, base: torch.Tensor, r: int) -> torch.Tensor:
    """Each parent's rival window centre: the neighbour winner covering the
    most neighbours that the main window (radius r around base) excludes,
    ties to the first neighbour in raster order; base where none is
    excluded.  Edge parents see their edge replicated."""
    _, npy, npx, _ = vals.shape
    dev = vals.device
    ry = torch.arange(-1, npy + 1, device=dev).clamp(0, npy - 1)
    rx = torch.arange(-1, npx + 1, device=dev).clamp(0, npx - 1)
    vp = vals[:, ry][:, :, rx]
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    neigh = torch.stack([vp[:, 1 + dy:1 + dy + npy, 1 + dx:1 + dx + npx] for dy, dx in offs])
    excl = (neigh - base[None]).abs().amax(dim=-1) > r
    d = (neigh[:, None] - neigh[None, :]).abs().amax(dim=-1)
    score = ((d <= r) & excl[:, None]).sum(dim=0)
    j = score.argmax(dim=0)
    rival = torch.take_along_dim(neigh, j[None, ..., None], dim=0)[0]
    return torch.where((score.amax(dim=0) > 0)[..., None], rival, base)


# --- the colour steps -------------------------------------------------------

def _rank_table() -> np.ndarray:
    table = np.full((9, 9), _BIG_RANK, dtype=np.int32)
    index = {s: k for k, s in enumerate(SLOTS)}
    for case, ordering in enumerate(_CASE_ORDERINGS):
        for rank, slot in enumerate(ordering):
            table[case, index[slot]] = rank
    return table


_RANK_TABLE = _rank_table()


def _border_case(i, j, nby: int, nbx: int) -> torch.Tensor:
    """The reference program's if-chain over a block's border position."""
    masks = (
        (j == 0, 7), (i == 0, 6), ((i == 0) & (j == 0), 5),
        ((j == nbx - 1) & (i > 0) & (i < nby - 1), 4), ((j == 0) & (i > 0) & (i < nby - 1), 3),
        ((i == nby - 1) & (j > 0) & (j < nbx - 1), 2), ((i == 0) & (j > 0) & (j < nbx - 1), 1),
        ((i > 0) & (i < nby - 1) & (j > 0) & (j < nbx - 1), 0),
    )
    case = torch.full(torch.broadcast_shapes(i.shape, j.shape), 8, dtype=torch.int64,
                      device=i.device)
    for mask, value in masks:  # later entries take precedence, as in the chain
        case = torch.where(mask, value, case)
    return case


def _candidates(grid, cur: int, h: int, w: int, ci: int, cj: int):
    """The 9 candidates of the cells of colour (ci, cj): cands (B, m, n, 9,
    2) (0 off the grid), rank (m, n, 9), present (m, n, 9), in_img (B, m,
    n, 9)."""
    _, nby, nbx, _ = grid.shape
    dev = grid.device
    m, n = (nby - ci + 1) // 2, (nbx - cj + 1) // 2
    gp = F.pad(grid, (0, 0, 1, 1, 1, 1))
    gi = ci + 2 * torch.arange(m, device=dev)[:, None]
    gj = cj + 2 * torch.arange(n, device=dev)[None, :]
    cands = torch.stack([gp[:, 1 + ci + dy:2 + ci + dy + 2 * (m - 1):2,
                            1 + cj + dx:2 + cj + dx + 2 * (n - 1):2] for dy, dx in SLOTS], dim=3)
    nby_t, nbx_t = h // cur, w // cur
    rank = torch.as_tensor(_RANK_TABLE, device=dev)[_border_case(gi, gj, nby_t, nbx_t)]
    sdy = torch.tensor([s[0] for s in SLOTS], device=dev)
    sdx = torch.tensor([s[1] for s in SLOTS], device=dev)
    ty, tx = gi[..., None] + sdy, gj[..., None] + sdx
    present = (rank < _BIG_RANK) & (ty >= 0) & (ty < nby_t) & (tx >= 0) & (tx < nbx_t)
    t_x = (gj * cur)[..., None] + cands[..., 0]
    t_y = (gi * cur)[..., None] + cands[..., 1]
    in_img = (t_x >= 0) & (t_x <= w - cur) & (t_y >= 0) & (t_y <= h - cur)
    return cands, rank, present, in_img


def _window_costs(cands, vol, centres, f: int, ci: int, cj: int, r: int):
    """(costs, inside) (B, m, n, 9): each candidate's cost in a stored
    volume of radius r around its parent's centre, and whether it lies in
    that window."""
    m, n = cands.shape[1:3]
    rows = torch.arange(ci, ci + 2 * m, 2, device=cands.device) // f
    cols = torch.arange(cj, cj + 2 * n, 2, device=cands.device) // f
    c = centres[:, rows][:, :, cols]
    ddx = cands[..., 0] - c[..., None, 0]
    ddy = cands[..., 1] - c[..., None, 1]
    key = (ddy + r).clamp(0, 2 * r) * (2 * r + 1) + (ddx + r).clamp(0, 2 * r)
    slab = vol[:, :, ci::2, cj::2].to(torch.int32)
    costs = torch.gather(slab, 1, key.permute(0, 3, 1, 2).long()).permute(0, 2, 3, 1)
    return costs, (ddx.abs() <= r) & (ddy.abs() <= r)


def _color_step(grid, vol, pm, rvol, rpm, *, cur, h, w, r, r2, ci, cj, lam_mult, dtype):
    """Cells of colour (ci, cj) take their least-energy candidate, in place."""
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = _candidates(grid, cur, h, w, ci, cj)
    costs, usable = _window_costs(cands, vol, pm, f, ci, cj, r)
    if rvol is not None:
        # the own window first; the rival's cost only where it excludes
        rcosts, in_rival = _window_costs(cands, rvol, rpm, f, ci, cj, r2)
        costs = torch.where(usable, costs, rcosts)
        usable = usable | in_rival
    cf = cands.to(torch.float32)
    du = (cf[..., :, None, 0] - cf[..., None, :, 0]).abs()
    dv = (cf[..., :, None, 1] - cf[..., None, :, 1]).abs()
    smooth = ((du + dv) * present.to(torch.float32)[..., None, :]).sum(dim=-1)
    lam = torch.tensor(lam_mult, dtype=dtype, device=grid.device)
    # the multiply and the add round separately, each in ``dtype``
    energy = torch.where(present & in_img & usable, costs.to(dtype) + lam * smooth.to(dtype),
                         torch.finfo(dtype).max)
    e_min = energy.amin(dim=-1, keepdim=True)
    winner = torch.where(energy == e_min, rank.expand_as(energy), _BIG_RANK).argmin(dim=-1)
    b, m, n = cands.shape[:3]
    grid[:, ci::2, cj::2] = torch.gather(cands, 3, winner[..., None, None].expand(b, m, n, 1, 2))[
        :, :, :, 0]


def rounds(grid, vols, pm, rvols, rpm, *, bs, h, w, r, r2, lam0, sweeps, dtype):
    """Rounds cur = bs, bs/2, .., 2 on stored volumes, each ``sweeps`` sweeps
    of the four colours at lambda * (sweep + 1) (Python double, rounded to
    ``dtype`` once), lambda doubling a round; each round ends in a 2x2
    subdivision.  Returns the stride-1 (B, h, w, 2) int32 grid."""
    cur, lam = bs, lam0
    grid = grid.contiguous()
    while cur > 1:
        vol, rvol = vols.pop(cur), (rvols.pop(cur) if rvols is not None else None)
        for sweep in range(sweeps):
            for ci, cj in COLORS:
                _color_step(grid, vol, pm, rvol, rpm, cur=cur, h=h, w=w, r=r, r2=r2, ci=ci,
                            cj=cj, lam_mult=lam * (sweep + 1), dtype=dtype)
        del vol, rvol
        grid = grid.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).contiguous()
        cur >>= 1
        lam *= 2.0
    return grid


# --- levels -----------------------------------------------------------------

def _rival(im1, im2, grid0, base, oy, ox, bs, r, r2, cost):
    rmv = pick_rival(grid0, base, r)
    rwin, rvy, rvx = gather(im2, oy + rmv[..., 1], ox + rmv[..., 0], bs, r2)
    rbase = torch.stack([rvx - ox, rvy - oy], dim=-1).contiguous()
    return volumes(im1, rwin, bs, r2, cost), rbase


def _centres(pred, oy, ox, bs, h, w):
    """Search centres: origin + prediction truncated toward zero; the
    origin where the centre's block leaves the frame (the zero-MV
    early-out)."""
    cy = oy + pred[..., 1].to(torch.int32)
    cx = ox + pred[..., 0].to(torch.int32)
    ok = (cy >= 0) & (cy <= h - bs) & (cx >= 0) & (cx <= w - bs)
    return torch.where(ok, cy, oy), torch.where(ok, cx, ox), ok


def fused_level(im1, im2, pred, bs, ss, lam0, st: Settings, level: int, dtype):
    """``window_center="pred"``: search and rounds from one set of volumes."""
    _, h, w = im1.shape
    shift = ss - bs
    ext = spiral_offsets(shift)[2]
    oy, ox = _origins(*pred.shape[1:3], bs, im1.device)
    cy, cx, ok = _centres(pred, oy, ox, bs, h, w)
    windows, by, bx = gather(im2, cy, cx, bs, ext)
    base = torch.stack([bx - ox, by - oy], dim=-1).contiguous()
    vols = volumes(im1, windows, bs, ext, st.cost)
    del windows
    best_dy, best_dx = spiral_argmin(vols[bs], cy, cx, shift, bs, h, w)
    u = torch.where(ok, cx + best_dx - ox, 0)
    v = torch.where(ok, cy + best_dy - oy, 0)
    grid0 = torch.stack([u, v], dim=-1).to(torch.int32)
    rr = st.rival_radius_at(level)
    r2 = ext if rr is None else min(rr, ext)
    rvols = rbase = None
    if st.rival:
        rvols, rbase = _rival(im1, im2, grid0, base, oy, ox, bs, ext, r2, st.cost)
    return rounds(grid0, vols, base, rvols, rbase, bs=bs, h=h, w=w, r=ext, r2=r2, lam0=lam0,
                  sweeps=st.sweeps, dtype=dtype)


def search(im1, im2, pred, bs, ss, cost):
    """The spiral block search: (B, npy, npx, 2) int32 winning MVs: the
    least cost over the centre's [-S, S]^2 offsets, ties to the earliest
    spiral visit (the walk's strict <), out-of-frame offsets skipped, a
    zero MV where the centre's block leaves the frame."""
    _, h, w = im1.shape
    ext = spiral_offsets(ss - bs)[2]
    oy, ox = _origins(pred.shape[1], pred.shape[2], bs, im1.device)
    cy, cx, ok = _centres(pred, oy, ox, bs, h, w)
    wins = gather(im2, cy, cx, bs, ext)[0]
    cost_bs = volumes(im1, wins, bs, ext, cost, only_bs=True)[bs]
    best_dy, best_dx = spiral_argmin(cost_bs, cy, cx, ss - bs, bs, h, w)
    u = cx + best_dx - ox
    v = cy + best_dy - oy
    return torch.where(ok[..., None], torch.stack([u, v], dim=-1), 0).to(torch.int32)


def searched_level(im1, im2, pred, bs, ss, lam0, st: Settings, level: int, dtype):
    """``window_center="search"``: the search, then windows of radius r =
    min(reg_radius, S) around the winners, their volumes and the rounds."""
    _, h, w = im1.shape
    grid0 = search(im1, im2, pred, bs, ss, st.cost)
    ext = spiral_offsets(ss - bs)[2]
    r = ext if st.reg_radius is None else min(st.reg_radius, ext)
    oy, ox = _origins(*grid0.shape[1:3], bs, im1.device)
    windows = gather(im2, oy + grid0[..., 1], ox + grid0[..., 0], bs, r)[0]
    vols = volumes(im1, windows, bs, r, st.cost)
    del windows
    rr = st.rival_radius_at(level)
    r2 = r if rr is None else min(rr, r)
    rvols = rbase = None
    if st.rival:
        rvols, rbase = _rival(im1, im2, grid0, grid0, oy, ox, bs, r, r2, st.cost)
    return rounds(grid0.clone(), vols, grid0, rvols, rbase, bs=bs, h=h, w=w, r=r, r2=r2,
                  lam0=lam0, sweeps=st.sweeps, dtype=dtype)


def estimate(im1s: torch.Tensor, im2s: torch.Tensor, fields: dict,
             energy_dtype: torch.dtype = torch.float32, devices=None) -> torch.Tensor:
    """(B, H, W, 2) float32 flow (u, v) of (B, H, W) uint8 frame pairs, as
    the reference driver returns it: upscaled, padded, estimated, every
    f-th pixel of the unpadded field, divided by f.  ``devices``, the
    cell's cards, is not used: the whole field runs on the frames' device."""
    st = Settings(fields)
    if im1s.dtype != torch.uint8 or im1s.shape != im2s.shape or im1s.dim() != 3:
        raise ValueError(f"need two (B, H, W) uint8 batches, got {im1s.dtype} "
                         f"{tuple(im1s.shape)} and {tuple(im2s.shape)}")
    f = st.interp
    if f > 1:
        im1s, im2s = upscale(im1s, f), upscale(im2s, f)
    h0, w0 = im1s.shape[1:]
    ph, pw = padded_dims(h0, w0, st.block_sizes)
    py, px = (ph - h0) // 2, (pw - w0) // 2
    pyr1 = [F.pad(im1s, (px, px, py, py), value=0)]
    pyr2 = [F.pad(im2s, (px, px, py, py), value=0)]
    for _ in range(1, len(st.block_sizes)):
        pyr1.append(pyrdown(pyr1[-1]))
        pyr2.append(pyrdown(pyr2[-1]))
    level_fn = fused_level if st.window_center == "pred" and st.reg_radius is None \
        else searched_level
    dense = None
    for level in range(len(st.block_sizes) - 1, -1, -1):
        im1, im2 = pyr1[level], pyr2[level]
        b, h, w = im1.shape
        bs, ss = st.block_sizes[level], st.search_sizes[level]
        if dense is None:
            pred = torch.zeros((b, h // bs, w // bs, 2), dtype=torch.float32, device=im1.device)
        else:
            cbs = st.block_sizes[level + 1]
            hc, wc = dense.shape[1:3]
            sampled = dense[:, ::cbs, ::cbs] * 2.0
            iy = torch.as_tensor((np.arange(2 * hc // bs) * bs) // (2 * cbs), device=im1.device)
            jx = torch.as_tensor((np.arange(2 * wc // bs) * bs) // (2 * cbs), device=im1.device)
            pred = sampled[:, iy][:, :, jx]
            if st.mv_cap is not None:
                pred = pred.clamp(-float(st.mv_cap), float(st.mv_cap))
        lam0 = float(bs) * st.lambda_scale
        dense = level_fn(im1, im2, pred, bs, ss, lam0, st, level, energy_dtype).to(torch.float32)
    flow = dense[:, py:ph - py:f, px:pw - px:f]
    return flow / torch.full_like(flow, float(f))


def mismatched_pixels(flow: torch.Tensor, want: torch.Tensor) -> int:
    """Pixels whose (u, v) differ from the reference's in any way (a NaN
    differs from everything)."""
    if flow.shape != want.shape:
        return math.prod(want.shape[:-1])
    same = (flow == want).all(dim=-1)
    return int((~same).sum())
