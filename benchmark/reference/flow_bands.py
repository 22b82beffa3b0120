"""Plain PyTorch reference of the motion estimator with each level's cost
volumes held in bands of parent rows, one band a card, for the check of
frames whose volumes no single card holds.

The same estimate as ``flow.py`` (its ``estimate`` and
``mismatched_pixels``, the same arguments and the same bits), made of
``flow.py``'s own functions wherever they are unchanged: the upscale, the
padding, the pyramid, the gathers, the volumes of a run of parent rows, the
spiral argmin, the rival pick, the candidates and their window lookup, and
the energy, tie-breaks and order of a colour step.  Only where a level's
volumes live differs:

  * the parents' rows are cut into one band a card of ``devices`` (the
    first bands one row longer where the rows do not divide evenly);
  * each band's volumes are made on its card from its rows of frame 1 and
    its parents' frame-2 windows, a few parent rows a call of
    ``flow.volumes`` (so that the per-delta temporaries stay small), the
    calls of the bands interleaved, so that the cards work at once;
  * the spiral argmin reads the cur = bs volumes gathered on the frames'
    card, and each colour step looks its candidates' costs up band by band
    on the bands' cards, the costs gathered on the frames' card, where the
    energy is formed as ``flow.py`` forms it.

Nothing the bands do on their cards waits on the host: a card's work is
issued in full before anything reads it back, and the only host waits are
those ``flow.py``'s functions make on the frames' card.  Without
``devices`` (or with the frames' card alone) there is one band, and the
estimate is ``flow.py``'s, computed in the same pieces.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import flow
from benchmark.reference.flow import mismatched_pixels  # noqa: F401  (the check's comparison)

# the most bytes of int32 per-delta temporaries one call of ``flow.volumes``
# makes on a band's card (a delta row of its parents' sub-block costs)
CHUNK_BYTES = 1 << 29


def band_rows(npy: int, n: int) -> list[tuple[int, int]]:
    """``min(n, npy)`` bands of parent rows, (first, end) each, covering
    0 .. npy in order: as even as the rows allow, the first ``npy % n`` one
    row longer."""
    n = max(1, min(n, npy))
    size, extra = divmod(npy, n)
    out, p0 = [], 0
    for k in range(n):
        p1 = p0 + size + (k < extra)
        out.append((p0, p1))
        p0 = p1
    return out


class Bands:
    """The bands of one level: parent rows ``rows[k]`` on ``devices[k]``,
    ``npx`` parents a row; ``main`` is the frames' device."""

    def __init__(self, npy: int, npx: int, devices: list, main: torch.device):
        self.rows = band_rows(npy, len(devices))
        self.devices = [torch.device(d) for d in devices[:len(self.rows)]]
        self.npx, self.main = npx, main

    def volumes(self, im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str,
                only_bs: bool = False) -> list[dict]:
        """Each band's ``flow.volumes`` on its card: {cur: (B, side^2,
        rows * bs / cur, w / cur)} of its parents.  Every band's inputs are
        sent first, then the calls of the bands interleaved."""
        b, _, w = im1.shape
        side = 2 * r + 1
        step = max(1, CHUNK_BYTES // (b * self.npx * side * bs * bs * 4))
        curs = [bs] if only_bs else [1 << k for k in range(1, bs.bit_length())]
        inputs, out = [], []
        for (p0, p1), dev in zip(self.rows, self.devices):
            inputs.append((im1[:, p0 * bs:p1 * bs].to(dev),
                           windows[:, p0 * self.npx:p1 * self.npx].to(dev)))
            out.append({c: torch.empty((b, side * side, (p1 - p0) * bs // c, w // c),
                                       dtype=flow._vol_dtype(c, cost), device=dev)
                        for c in curs})
        longest = max(p1 - p0 for p0, p1 in self.rows)
        for q0 in range(0, longest, step):
            for (p0, p1), (rows1, wins), vols in zip(self.rows, inputs, out):
                q1 = min(q0 + step, p1 - p0)
                if q0 >= q1:
                    continue
                part = flow.volumes(rows1[:, q0 * bs:q1 * bs],
                                    wins[:, q0 * self.npx:q1 * self.npx], bs, r, cost, only_bs)
                for c, vol in part.items():
                    vols[c][:, :, q0 * bs // c:q1 * bs // c] = vol
        return out

    def gathered(self, vols: list[dict], cur: int) -> torch.Tensor:
        """The bands' cur volumes as one (B, side^2, h / cur, w / cur) on
        the frames' card."""
        return torch.cat([v[cur].to(self.main) for v in vols], dim=2)

    def costs(self, cands, vols: list, centres, cur: int, f: int, ci: int, cj: int, r: int):
        """``flow._window_costs`` of the cells of colour (ci, cj), band by
        band on the bands' cards: (costs, inside) (B, m, n, 9) on the
        frames' card.  ``vols`` holds each band's cur volume."""
        m = cands.shape[1]
        costs, inside = [], []
        for (p0, p1), dev, vol in zip(self.rows, self.devices, vols):
            # the colour's cells whose rows lie in the band, and the first
            # one's row in the band's volume
            k0 = min(m, max(0, (p0 * f - ci + 1) // 2))
            k1 = min(m, max(0, (p1 * f - ci + 1) // 2))
            if k0 == k1:
                continue
            c, i = flow._window_costs(cands[:, k0:k1].to(dev), vol[cur], centres[:, p0:p1].to(dev),
                                      f, ci + 2 * k0 - p0 * f, cj, r)
            costs.append(c.to(self.main))
            inside.append(i.to(self.main))
        return torch.cat(costs, dim=1), torch.cat(inside, dim=1)


def _color_step(grid, bands: Bands, vol, pm, rvol, rpm, *, cur, h, w, r, r2, ci, cj, lam_mult,
                dtype):
    """``flow._color_step`` with each candidate's cost looked up in the
    bands: cells of colour (ci, cj) take their least-energy candidate, in
    place."""
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = flow._candidates(grid, cur, h, w, ci, cj)
    costs, usable = bands.costs(cands, vol, pm, cur, f, ci, cj, r)
    if rvol is not None:
        # the own window first; the rival's cost only where it excludes
        rcosts, in_rival = bands.costs(cands, rvol, rpm, cur, f, ci, cj, r2)
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
    winner = torch.where(energy == e_min, rank.expand_as(energy), flow._BIG_RANK).argmin(dim=-1)
    b, m, n = cands.shape[:3]
    grid[:, ci::2, cj::2] = torch.gather(cands, 3, winner[..., None, None].expand(b, m, n, 1, 2))[
        :, :, :, 0]


def rounds(grid, bands: Bands, vols, pm, rvols, rpm, *, bs, h, w, r, r2, lam0, sweeps, dtype):
    """``flow.rounds`` on the bands' volumes: rounds cur = bs .. 2, each
    ``sweeps`` sweeps of the four colours, a round's volumes freed after
    it; the stride-1 (B, h, w, 2) int32 grid."""
    cur, lam = bs, lam0
    grid = grid.contiguous()
    while cur > 1:
        vol = [{cur: v.pop(cur)} for v in vols]
        rvol = [{cur: v.pop(cur)} for v in rvols] if rvols is not None else None
        for sweep in range(sweeps):
            for ci, cj in flow.COLORS:
                _color_step(grid, bands, vol, pm, rvol, rpm, cur=cur, h=h, w=w, r=r, r2=r2,
                            ci=ci, cj=cj, lam_mult=lam * (sweep + 1), dtype=dtype)
        del vol, rvol
        grid = grid.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).contiguous()
        cur >>= 1
        lam *= 2.0
    return grid


def _rival(im1, im2, bands: Bands, grid0, base, oy, ox, bs, r, r2, cost):
    rmv = flow.pick_rival(grid0, base, r)
    rwin, rvy, rvx = flow.gather(im2, oy + rmv[..., 1], ox + rmv[..., 0], bs, r2)
    rbase = torch.stack([rvx - ox, rvy - oy], dim=-1).contiguous()
    rvols = bands.volumes(im1, rwin, bs, r2, cost)
    return rvols, rbase


def fused_level(im1, im2, pred, bs, ss, lam0, st: flow.Settings, level: int, dtype, devices):
    """``flow.fused_level`` on bands: search and rounds from one set of
    volumes, windows around the prediction."""
    _, h, w = im1.shape
    shift = ss - bs
    ext = flow.spiral_offsets(shift)[2]
    npy, npx = pred.shape[1:3]
    bands = Bands(npy, npx, devices, im1.device)
    oy, ox = flow._origins(npy, npx, bs, im1.device)
    cy, cx, ok = flow._centres(pred, oy, ox, bs, h, w)
    windows, by, bx = flow.gather(im2, cy, cx, bs, ext)
    base = torch.stack([bx - ox, by - oy], dim=-1).contiguous()
    vols = bands.volumes(im1, windows, bs, ext, st.cost)
    del windows
    best_dy, best_dx = flow.spiral_argmin(bands.gathered(vols, bs), cy, cx, shift, bs, h, w)
    u = torch.where(ok, cx + best_dx - ox, 0)
    v = torch.where(ok, cy + best_dy - oy, 0)
    grid0 = torch.stack([u, v], dim=-1).to(torch.int32)
    rr = st.rival_radius_at(level)
    r2 = ext if rr is None else min(rr, ext)
    rvols = rbase = None
    if st.rival:
        rvols, rbase = _rival(im1, im2, bands, grid0, base, oy, ox, bs, ext, r2, st.cost)
    return rounds(grid0, bands, vols, base, rvols, rbase, bs=bs, h=h, w=w, r=ext, r2=r2,
                  lam0=lam0, sweeps=st.sweeps, dtype=dtype)


def search(im1, im2, pred, bs, ss, cost, devices):
    """``flow.search`` with its cur = bs volume made in bands."""
    _, h, w = im1.shape
    ext = flow.spiral_offsets(ss - bs)[2]
    npy, npx = pred.shape[1:3]
    bands = Bands(npy, npx, devices, im1.device)
    oy, ox = flow._origins(npy, npx, bs, im1.device)
    cy, cx, ok = flow._centres(pred, oy, ox, bs, h, w)
    wins = flow.gather(im2, cy, cx, bs, ext)[0]
    cost_bs = bands.gathered(bands.volumes(im1, wins, bs, ext, cost, only_bs=True), bs)
    best_dy, best_dx = flow.spiral_argmin(cost_bs, cy, cx, ss - bs, bs, h, w)
    u = cx + best_dx - ox
    v = cy + best_dy - oy
    return torch.where(ok[..., None], torch.stack([u, v], dim=-1), 0).to(torch.int32)


def searched_level(im1, im2, pred, bs, ss, lam0, st: flow.Settings, level: int, dtype, devices):
    """``flow.searched_level`` on bands: the search, then windows around
    the winners, their volumes and the rounds."""
    _, h, w = im1.shape
    grid0 = search(im1, im2, pred, bs, ss, st.cost, devices)
    ext = flow.spiral_offsets(ss - bs)[2]
    r = ext if st.reg_radius is None else min(st.reg_radius, ext)
    npy, npx = grid0.shape[1:3]
    bands = Bands(npy, npx, devices, im1.device)
    oy, ox = flow._origins(npy, npx, bs, im1.device)
    windows = flow.gather(im2, oy + grid0[..., 1], ox + grid0[..., 0], bs, r)[0]
    vols = bands.volumes(im1, windows, bs, r, st.cost)
    del windows
    rr = st.rival_radius_at(level)
    r2 = r if rr is None else min(rr, r)
    rvols = rbase = None
    if st.rival:
        rvols, rbase = _rival(im1, im2, bands, grid0, grid0, oy, ox, bs, r, r2, st.cost)
    return rounds(grid0.clone(), bands, vols, grid0, rvols, rbase, bs=bs, h=h, w=w, r=r, r2=r2,
                  lam0=lam0, sweeps=st.sweeps, dtype=dtype)


def estimate(im1s: torch.Tensor, im2s: torch.Tensor, fields: dict,
             energy_dtype: torch.dtype = torch.float32, devices=None) -> torch.Tensor:
    """(B, H, W, 2) float32 flow (u, v) of (B, H, W) uint8 frame pairs, as
    ``flow.estimate`` returns it, each level's volumes in one band of
    parent rows a card of ``devices`` (the cell's cards; None: the frames'
    card alone)."""
    st = flow.Settings(fields)
    if im1s.dtype != torch.uint8 or im1s.shape != im2s.shape or im1s.dim() != 3:
        raise ValueError(f"need two (B, H, W) uint8 batches, got {im1s.dtype} "
                         f"{tuple(im1s.shape)} and {tuple(im2s.shape)}")
    devices = list(devices) if devices else [im1s.device]
    f = st.interp
    if f > 1:
        im1s, im2s = flow.upscale(im1s, f), flow.upscale(im2s, f)
    h0, w0 = im1s.shape[1:]
    ph, pw = flow.padded_dims(h0, w0, st.block_sizes)
    py, px = (ph - h0) // 2, (pw - w0) // 2
    pyr1 = [F.pad(im1s, (px, px, py, py), value=0)]
    pyr2 = [F.pad(im2s, (px, px, py, py), value=0)]
    for _ in range(1, len(st.block_sizes)):
        pyr1.append(flow.pyrdown(pyr1[-1]))
        pyr2.append(flow.pyrdown(pyr2[-1]))
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
            iy = torch.as_tensor((np.arange(2 * hc // bs) * bs) // (2 * cbs),
                                 device=im1.device)
            jx = torch.as_tensor((np.arange(2 * wc // bs) * bs) // (2 * cbs),
                                 device=im1.device)
            pred = sampled[:, iy][:, :, jx]
            if st.mv_cap is not None:
                pred = pred.clamp(-float(st.mv_cap), float(st.mv_cap))
        lam0 = float(bs) * st.lambda_scale
        dense = level_fn(im1, im2, pred, bs, ss, lam0, st, level, energy_dtype,
                         devices).to(torch.float32)
    flow_ = dense[:, py:ph - py:f, px:pw - px:f]
    return flow_ / torch.full_like(flow_, float(f))
