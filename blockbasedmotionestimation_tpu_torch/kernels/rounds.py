"""The rounds of the windowed regularizer: the round kernel's wrappers, in
place on the MV grid.

Every round on every path runs one CUDA template, ``round_kernel<Form,
CUR, kStrips>`` of ``csrc/fused_step.cu``, through its one entry point
``bbme_round``.  It has six forms here (``FORMS``), after where a
candidate's cost comes from:

  * ``stored`` (D, rounds at cur = bs; D', rounds at cur < bs of the
    dense-rival form; 8 and 9 the same without rival windows): main-window
    candidates from the main volume at cur, rival candidates (outside the
    main window, inside the rival one) from the rival volume at cur;
  * ``compact`` (kernel 10, ``cv_compact``'s rounds cur < bs): the stored
    form without rival windows on K-slot tables, each candidate's slot
    looked up in the level's ``ops.compact.slot_map``;
  * ``hybrid`` (E, the hybrid form's rounds cur <= fuse_max): main-window
    candidates from the dense main volume at cur, rival candidates
    recomputed against the rival window's pixels;
  * ``hybrid_tail`` (F, the cur = 2 round with the stored band):
    main-window candidates with |dx - pm_x| <= store_r from the band
    (``cv_diff.pooled_cvs(store_r=)``), the other main-window candidates
    recomputed against the main window's pixels, rival candidates against
    the rival window's;
  * ``fused`` (11, ``cv_fused``'s rounds cur <= fuse): no volume, every
    main-window candidate recomputed against the main window's pixels;
  * ``fused_rival`` (12): 11, and rival candidates against the rival
    window's pixels.

A recomputed cost is the cur x cur SAD/SSD of the cell's frame-1 sub-block
against the window the volumes were built from (kernel A's output, with
its zero padding), so it equals the stored value bit for bit.

Each form has four functions, named from its row of ``FORMS``:
``color_round_<form>`` runs a whole round (``sweeps`` sweeps of the four
colours, ``ops.regularize.COLORS``, sweep s at multiplier ``lam * (s +
1)``, computed in Python double and rounded to f32 as the per-step loop
rounds it: ``sweep_lams``), validated once per round; ``color_step_<form>``
(``color_step`` for ``stored``) runs one colour step (colour (ci, cj),
multiplier ``lam_mult``); ``color_round_<form>_plain`` and
``color_step_<form>_plain`` are the same with torch ops (the round loops
the plain step).  For CPU tensors the wrappers run the plain versions; for
CUDA tensors they launch the kernel: a round one cooperative launch with
a grid barrier between its steps (up to ``MAX_SWEEPS`` sweeps a launch;
more take several launches), a single step a span of one step.  Nothing
falls back from one to the other.  Each wrapper counts its own launches
(``.launches``); a round wrapper names its single step (``.step``), marks
itself a whole round (``.per_round``) and names the form its rounds count
under (``.form``, ``utils.profiling.round_done``).

The wrappers take u16/i32 volumes and sad/ssd; the f32 volumes of
``cost="zsad"`` go to ``color_round_stored_plain`` by name, on any device
(the reference runs zsad in XLA only).

Layouts (batch written out):
  grid: (B, nby, nbx, 2) int32 MVs (x, y) at sub-block size cur, updated in
        place; nby = npy * f with f = bs // cur;
  cv:   (B, side^2, nby, nbx) main-window volume at cur (``kernels.cv_diff``;
        stored, hybrid);
  band: (B, side * (2 store_r + 1), nby, nbx) the stored cur=2 band
        (hybrid_tail);
  pm:   (B, npy, npx, 2) int32 main-window centre MVs of the parents;
  rcv / rpm / r2: the rival window's volume (stored), centres and radius;
  im1:  (B, h, w) u8 frame-1 level image;
  win:  (B, nP, bs + 2r, bs + 2r) u8 main windows (hybrid_tail, fused*);
  rwin: (B, nP, bs + 2r2, bs + 2r2) u8 rival windows;
  table: (B, K, nby, nbx) compact table at cur (``cv_diff.compact_tables``),
        slots: (B, nch, K, 2) its chunks' slot lists and smap: (B, nch,
        side^2) uint16 their ``ops.compact.slot_map``, required on the card.

Tiles (the tiled engine): the single steps of every form but ``compact``
take ``strips`` (``ops.regularize.Strips``: each entry's first row in its
frame, the frame's height and the ghost rows the caller refreshed before
the step; on 2-D tiles also its first column, the frame's width and the
ghost columns with their corners); ``(ci, cj)`` is then the frame's colour.
On the card that is the kernel's span of one step with the tiles'
arguments; on the CPU the plain step under ``ops.regularize.on_strips``.
A tiled round is a loop of single steps (``ops.windowed.rounds_loop``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.ops import regularize as reg
from blockbasedmotionestimation_tpu_torch.ops.compact import CHUNK
from blockbasedmotionestimation_tpu_torch.ops.regularize import (
    COLORS,
    Strips,
    on_strips,
    step_candidates,
    step_commit,
)
from blockbasedmotionestimation_tpu_torch.utils import profiling

# sweeps one round launch takes (csrc/fused_step.cu kMaxSweeps: the f32
# multipliers ride by value in the kernel's argument struct)
MAX_SWEEPS = 8


def sweep_lams(lam: float, sweeps: int) -> list[float]:
    """The multiplier of each sweep of a round, ``lam * (sweep + 1)`` in
    Python double, as the per-step loop passes it (the wrappers round it
    to f32 once, on its way to the kernel)."""
    return [lam * (sweep + 1) for sweep in range(sweeps)]


def _lam_array(lams) -> ctypes.Array:
    """The f32 multipliers of one launch, as the kernel receives them."""
    return (ctypes.c_float * len(lams))(*lams)


def _spans(sweeps: int) -> list[range]:
    """The sweeps of each launch of a round: MAX_SWEEPS at a time."""
    if sweeps < 0:
        raise ValueError(f"need sweeps >= 0, got {sweeps}")
    return [range(s0, min(sweeps, s0 + MAX_SWEEPS)) for s0 in range(0, sweeps, MAX_SWEEPS)]


def _round_plain(step_plain, grid, *args, lam, sweeps, **kw) -> None:
    """A round of ``step_plain``: sweeps x the four colours, in place."""
    for mult in sweep_lams(lam, sweeps):
        for ci, cj in COLORS:
            step_plain(grid, *args, ci=ci, cj=cj, lam_mult=mult, **kw)


# ------------------------------------------------------- plain pieces

def select_costs(
    cv_slab: torch.Tensor,  # (B, (2r+1)(2r_x+1), m, n) volume at one colour's cells
    ddy: torch.Tensor,      # (B, m, n, 9) candidate delta rows
    ddx: torch.Tensor,      # (B, m, n, 9) candidate delta cols
    r: int,
    r_x: int | None = None,
) -> torch.Tensor:
    """(B, m, n, 9) costs at the (clipped) candidate deltas of a volume of
    dy in [-r, r] and dx in [-r_x, r_x] (r_x = r: square): int32, or f32
    from an f32 (zsad) volume."""
    r_x = r if r_x is None else r_x
    key = (ddy + r).clamp(0, 2 * r) * (2 * r_x + 1) + (ddx + r_x).clamp(0, 2 * r_x)
    if cv_slab.dtype != torch.float32:
        cv_slab = cv_slab.to(torch.int32)
    vals = torch.gather(cv_slab, 1, key.permute(0, 3, 1, 2).long())
    return vals.permute(0, 2, 3, 1)


def _parent_slab(mv: torch.Tensor, f: int, ci: int, cj: int, m: int, n: int):
    """Parent MVs (B, npy, npx, 2) at the cells of colour (ci, cj)."""
    rows = torch.arange(ci, ci + 2 * m, 2, device=mv.device) // f
    cols = torch.arange(cj, cj + 2 * n, 2, device=mv.device) // f
    return mv[:, rows][:, :, cols]


def window_deltas(cands: torch.Tensor, centres: torch.Tensor, f: int, ci: int, cj: int, r: int):
    """(ddy, ddx, inside), each (B, m, n, 9): the candidates' deltas from
    their parents' window centres (centres: (B, npy, npx, 2) parent MVs, f
    cells per parent edge) and whether they lie in the window of radius r."""
    m, n = cands.shape[1:3]
    c = _parent_slab(centres, f, ci, cj, m, n)
    ddx = cands[..., 0] - c[..., None, 0]
    ddy = cands[..., 1] - c[..., None, 1]
    return ddy, ddx, (ddx.abs() <= r) & (ddy.abs() <= r)


def recompute_costs(
    im1: torch.Tensor,   # (B, h, w) u8
    win: torch.Tensor,   # (B, nP, bs + 2R, bs + 2R) u8
    ddy: torch.Tensor,   # (B, m, n, 9) deltas from the window centres
    ddx: torch.Tensor,
    radius: int,
    cur: int,
    ci: int,
    cj: int,
    cost: str,
) -> torch.Tensor:
    """(B, m, n, 9) int32 costs of colour (ci, cj)'s cells recomputed from
    window pixels at the (clipped) candidate deltas, with the torch ops of
    ``cv_diff.pooled_cvs_plain``."""
    b, h, w = im1.shape
    m, n = ddy.shape[1:3]
    ws = win.shape[-1]
    f = (ws - 2 * radius) // cur
    npx = w // (f * cur)
    dev = im1.device
    i = ci + 2 * torch.arange(m, device=dev)
    j = cj + 2 * torch.arange(n, device=dev)
    # the cell's parent, and its sub-block's top-left inside the window
    p = ((i // f)[:, None] * npx + (j // f)[None, :])[None, :, :, None]
    oy = ((i % f) * cur)[None, :, None, None]
    ox = ((j % f) * cur)[None, None, :, None]
    top = p * ws * ws + (oy + radius + ddy.clamp(-radius, radius)) * ws \
        + (ox + radius + ddx.clamp(-radius, radius))  # (B, m, n, 9)
    ar = torch.arange(cur, device=dev)
    idx = top[..., None, None] + ar[:, None] * ws + ar[None, :]  # (B, m, n, 9, cur, cur)
    vals = torch.gather(win.reshape(b, -1), 1, idx.reshape(b, -1).long()).reshape(idx.shape)
    blocks = (
        im1.reshape(b, h // cur, cur, w // cur, cur).permute(0, 1, 3, 2, 4)
        [:, ci::2, cj::2][:, :m, :n]
    )  # (B, m, n, cur, cur)
    d = blocks[:, :, :, None].to(torch.int32) - vals.to(torch.int32)
    dmap = d.abs() if cost == "sad" else d * d
    return dmap.sum(dim=(-2, -1), dtype=torch.int32)


# ------------------------------------------------------- plain steps

def color_step_plain(
    grid: torch.Tensor,
    cv: torch.Tensor,
    pm: torch.Tensor,
    *,
    cur: int,
    h: int,
    w: int,
    r: int,
    ci: int,
    cj: int,
    lam_mult: float,
    rcv: torch.Tensor | None = None,
    rpm: torch.Tensor | None = None,
    r2: int = 0,
    strips: Strips | None = None,
) -> None:
    """D, D', 8 or 9 with torch ops: update the cells of colour (ci, cj) of
    ``grid`` in place (ci: the grid's own row parity; see ``on_strips``).
    Also the steps of ``cost="zsad"`` on f32 volumes: the energy is the f32
    cost plus lam * smoothness, as the reference's XLA round computes it."""
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, strips=strips)
    ddy, ddx, in_window = window_deltas(cands, pm, f, ci, cj, r)
    costs = select_costs(cv[:, :, ci::2, cj::2], ddy, ddx, r)
    if rcv is not None:
        # own window first; the rival cost only for own-excluded candidates
        rdy, rdx, in_rival = window_deltas(cands, rpm, f, ci, cj, r2)
        rcosts = select_costs(rcv[:, :, ci::2, cj::2], rdy, rdx, r2)
        costs = torch.where(in_window, costs, rcosts)
        in_window = in_window | in_rival
    step_commit(grid, ci, cj, cands, costs, in_window, present, in_img, rank, lam_mult)


def color_step_compact_plain(
    grid: torch.Tensor,
    table: torch.Tensor,
    pm: torch.Tensor,
    slots: torch.Tensor,
    *,
    cur: int,
    h: int,
    w: int,
    r: int,
    ci: int,
    cj: int,
    lam_mult: float,
    smap: torch.Tensor | None = None,
) -> None:
    """Kernel 10 with torch ops: update colour (ci, cj) of ``grid`` in place.

    A candidate's cost is the table entry of the slot of its cell's chunk
    that holds its delta (rebased on the parent's window centre), found by
    comparing the delta with every slot (the kernel's ``smap`` is not read
    here); a candidate in no slot is excluded, and a cell whose own MV is in
    no slot keeps it (every candidate excluded: rank decides, own MV
    first)."""
    f = grid.shape[1] // pm.shape[1]
    npx = pm.shape[2]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj)
    ddy, ddx, _ = window_deltas(cands, pm, f, ci, cj, r)
    m, n = cands.shape[1:3]
    dev = grid.device
    rows = torch.arange(ci, ci + 2 * m, 2, device=dev) // f
    cols = torch.arange(cj, cj + 2 * n, 2, device=dev) // f
    s = slots[:, (rows[:, None] * npx + cols[None, :]) // CHUNK][:, :, :, None]  # (B,m,n,1,K,2)
    match = (
        ((ddy + r)[..., None] == s[..., 0]) & ((ddx + r)[..., None] == s[..., 1])
        & (s[..., 0] >= 0)
    )  # (B, m, n, 9, K)
    covered = match.any(dim=-1)
    k = match.to(torch.uint8).argmax(dim=-1)  # the slot (slots are distinct)
    costs = torch.gather(
        table[:, :, ci::2, cj::2].to(torch.int32), 1, k.permute(0, 3, 1, 2)
    ).permute(0, 2, 3, 1)
    covered = covered & covered[..., :1]  # the incumbent-safety guard
    step_commit(grid, ci, cj, cands, costs, covered, present, in_img, rank, lam_mult)


def _hybrid_plain(
    grid, vol, pm, *, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, ci, cj, lam_mult, cost,
    strips=None,
) -> None:
    """E (win None: vol is the dense main volume) or F (vol is the band)."""
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, strips=strips)
    ddy, ddx, in_window = window_deltas(cands, pm, f, ci, cj, r)
    rdy, rdx, in_rival = window_deltas(cands, rpm, f, ci, cj, r2)
    costs = recompute_costs(im1, rwin, rdy, rdx, r2, cur, ci, cj, cost)
    if win is None:
        costs = torch.where(in_window, select_costs(vol[:, :, ci::2, cj::2], ddy, ddx, r), costs)
    else:
        tail = recompute_costs(im1, win, ddy, ddx, r, cur, ci, cj, cost)
        band = select_costs(vol[:, :, ci::2, cj::2], ddy, ddx, r, store_r)
        in_band = ddx.abs() <= store_r
        costs = torch.where(in_window, torch.where(in_band, band, tail), costs)
    step_commit(grid, ci, cj, cands, costs, in_window | in_rival, present, in_img, rank,
                lam_mult)


def color_step_hybrid_plain(
    grid, cv, pm, *, im1, rwin, rpm, cur, h, w, r, r2, ci, cj, lam_mult, cost, strips=None
) -> None:
    """Kernel E with torch ops: update colour (ci, cj) of ``grid`` in place."""
    _hybrid_plain(grid, cv, pm, im1=im1, win=None, rwin=rwin, rpm=rpm, cur=cur, h=h, w=w,
                  r=r, store_r=r, r2=r2, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost,
                  strips=strips)


def color_step_hybrid_tail_plain(
    grid, band, pm, *, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, ci, cj, lam_mult,
    cost, strips=None,
) -> None:
    """Kernel F with torch ops: update colour (ci, cj) of ``grid`` in place."""
    _hybrid_plain(grid, band, pm, im1=im1, win=win, rwin=rwin, rpm=rpm, cur=cur, h=h, w=w,
                  r=r, store_r=store_r, r2=r2, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost,
                  strips=strips)


def _fused_plain(grid, pm, *, im1, win, rwin, rpm, cur, h, w, r, r2, ci, cj, lam_mult,
                 cost, strips=None) -> None:
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, strips=strips)
    ddy, ddx, in_window = window_deltas(cands, pm, f, ci, cj, r)
    costs = recompute_costs(im1, win, ddy, ddx, r, cur, ci, cj, cost)
    if rwin is not None:
        rdy, rdx, in_rival = window_deltas(cands, rpm, f, ci, cj, r2)
        rcosts = recompute_costs(im1, rwin, rdy, rdx, r2, cur, ci, cj, cost)
        costs = torch.where(in_window, costs, rcosts)
        in_window = in_window | in_rival
    step_commit(grid, ci, cj, cands, costs, in_window, present, in_img, rank, lam_mult)


def color_step_fused_plain(grid, pm, *, im1, win, cur, h, w, r, ci, cj, lam_mult,
                           cost, strips=None) -> None:
    """Kernel 11 with torch ops: update colour (ci, cj) of ``grid`` in place."""
    _fused_plain(grid, pm, im1=im1, win=win, rwin=None, rpm=None, cur=cur, h=h, w=w, r=r,
                 r2=0, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost, strips=strips)


def color_step_fused_rival_plain(grid, pm, *, im1, win, rwin, rpm, cur, h, w, r, r2, ci, cj,
                                 lam_mult, cost, strips=None) -> None:
    """Kernel 12 with torch ops: update colour (ci, cj) of ``grid`` in place."""
    _fused_plain(grid, pm, im1=im1, win=win, rwin=rwin, rpm=rpm, cur=cur, h=h, w=w, r=r,
                 r2=r2, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost, strips=strips)


# ------------------------------------------------------- validation

def _on_card(grid: torch.Tensor) -> bool:
    """Whether a call launches the kernel (CUDA tensors) or runs the plain
    steps (CPU tensors)."""
    return grid.device.type == "cuda"


def _check_grid(grid, cur, h, w):
    if grid.dtype != torch.int32 or grid.dim() != 4 or grid.shape[3] != 2:
        raise ValueError(f"grid must be (B, nby, nbx, 2) int32, got {grid.dtype} {tuple(grid.shape)}")
    if tuple(grid.shape[1:3]) != (h // cur, w // cur):
        raise ValueError(f"grid {tuple(grid.shape[1:3])} does not tile a {h}x{w} frame at cur={cur}")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {grid.device}")


def _check_tile_tensor(name, t, shape, grid):
    if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != grid.device:
        raise ValueError(f"strips.{name} must be {shape} int32 on {grid.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def strip_args(strips: Strips | None, grid: torch.Tensor, cur: int, h: int, w: int) -> tuple:
    """Validate a single step's tiles; returns the entry point's (row0_b,
    ghost, full_h, col0_b, ghost_cols, full_w): (None, None, h, None, None,
    w) for whole frames, the last three so for row strips, () for tiles on
    the CPU."""
    if strips is None:
        return None, None, h, None, None, w
    b, nby, nbx, _ = grid.shape
    _check_tile_tensor("row0_b", strips.row0_b, (b,), grid)
    _check_tile_tensor("ghost", strips.ghost, (b, 2, nbx, 2), grid)
    if strips.full_h % cur or strips.full_h < h:
        raise ValueError(f"strips.full_h={strips.full_h} must be a multiple of cur={cur} "
                         f"and >= {h}")
    tensors = [strips.row0_b, strips.ghost]
    cols = strips.col0_b is not None
    if cols != (strips.ghost_cols is not None) or cols != (strips.full_w is not None):
        raise ValueError("strips.col0_b, full_w and ghost_cols go together")
    if cols:
        _check_tile_tensor("col0_b", strips.col0_b, (b,), grid)
        _check_tile_tensor("ghost_cols", strips.ghost_cols, (b, 2, nby + 2, 2), grid)
        if strips.full_w % cur or strips.full_w < w:
            raise ValueError(f"strips.full_w={strips.full_w} must be a multiple of cur={cur} "
                             f"and >= {w}")
        tensors += [strips.col0_b, strips.ghost_cols]
    if not _on_card(grid):
        return ()
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the strips' tensors must be contiguous")
    if not cols:
        return strips.row0_b.data_ptr(), strips.ghost.data_ptr(), strips.full_h, None, None, w
    return (strips.row0_b.data_ptr(), strips.ghost.data_ptr(), strips.full_h,
            strips.col0_b.data_ptr(), strips.ghost_cols.data_ptr(), strips.full_w)


def _check_volume(name, vol, b, nd, nby, nbx, dev):
    want = (b, nd, nby, nbx)
    if tuple(vol.shape) != want or vol.dtype not in (torch.uint16, torch.int32):
        raise ValueError(
            f"{name} must be {want} uint16/int32, got {vol.dtype} {tuple(vol.shape)}"
        )
    if vol.device != dev:
        raise ValueError(f"{name} on {vol.device}, grid on {dev}")


def _check_centres(name, mv, b, nby, nbx, dev):
    if (
        mv.dtype != torch.int32 or mv.dim() != 4 or mv.shape[0] != b
        or mv.shape[3] != 2 or nby % mv.shape[1] or nbx % mv.shape[2]
        or nby // mv.shape[1] != nbx // mv.shape[2]
    ):
        raise ValueError(f"{name} must be (B, npy, npx, 2) int32 parent MVs, got "
                         f"{mv.dtype} {tuple(mv.shape)}")
    if mv.device != dev:
        raise ValueError(f"{name} on {mv.device}, grid on {dev}")


def _check_windows(name, t, b, n_p, edge, dev):
    if t.dtype != torch.uint8 or tuple(t.shape) != (b, n_p, edge, edge):
        raise ValueError(f"{name} must be ({b}, {n_p}, {edge}, {edge}) uint8, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, grid on {dev}")


def _check_card(h, w, nby, nbx, *tensors) -> None:
    """The kernel's own limits: contiguous tensors (None: not passed) and
    32-bit indices inside a frame."""
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError("the round kernel needs contiguous tensors")
    if nby * nbx * 2 >= 2**31 or h * w >= 2**31:
        raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _is16(t) -> int:
    return int(t is not None and t.dtype == torch.uint16)


def _rank_table_on(device: torch.device) -> torch.Tensor:
    return profiling.table("tables", "rank", lambda: reg._RANK_TABLE, device).contiguous()


# ------------------------------------------- each form's validate-and-pack
#
# Each validates a call's inputs (a round's once) and returns the entry
# point's arguments from the grid to the chunk on the card, None on the CPU.

def _pack_stored(grid, cv, pm, *, cur, h, w, r, rcv=None, rpm=None, r2=0):
    _check_grid(grid, cur, h, w)
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    _check_volume("cv", cv, b, (2 * r + 1) ** 2, nby, nbx, dev)
    _check_centres("pm", pm, b, nby, nbx, dev)
    if (rcv is None) != (rpm is None):
        raise ValueError("rcv and rpm go together")
    if rcv is not None:
        _check_volume("rcv", rcv, b, (2 * r2 + 1) ** 2, nby, nbx, dev)
        _check_centres("rpm", rpm, b, nby, nbx, dev)
        if rpm.shape != pm.shape:
            raise ValueError("rpm and pm must have the same shape")
    if not _on_card(grid):
        return None
    _check_card(h, w, nby, nbx, grid, cv, pm, rcv, rpm)
    return (grid.data_ptr(), cv.data_ptr(), _is16(cv), _ptr(rcv), _is16(rcv), None, None, None,
            pm.data_ptr(), _ptr(rpm), _rank_table_on(dev).data_ptr(), None,
            b, nby, nbx, nby // pm.shape[1], cur, h, w, r, 0, r2, 0, 0, 0, 0)


def _pack_compact(grid, table, pm, slots, *, cur, h, w, r, smap=None):
    _check_grid(grid, cur, h, w)
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    _check_centres("pm", pm, b, nby, nbx, dev)
    nch = -(-pm.shape[1] * pm.shape[2] // CHUNK)
    if slots.dtype != torch.int32 or slots.dim() != 4 or tuple(slots.shape[:2]) != (b, nch) \
            or slots.shape[3] != 2 or slots.device != dev:
        raise ValueError(f"slots must be ({b}, {nch}, K, 2) int32 on {dev}, got "
                         f"{slots.dtype} {tuple(slots.shape)} on {slots.device}")
    k_slots = slots.shape[2]
    _check_volume("table", table, b, k_slots, nby, nbx, dev)
    side = 2 * r + 1
    if smap is not None and (smap.dtype != torch.uint16
                             or tuple(smap.shape) != (b, nch, side * side) or smap.device != dev):
        raise ValueError(f"smap must be ({b}, {nch}, {side * side}) uint16 on {dev}, got "
                         f"{smap.dtype} {tuple(smap.shape)} on {smap.device}")
    if not _on_card(grid):
        return None
    if smap is None:
        raise ValueError("on the card the compact colour steps need smap, the level's "
                         "ops.compact.slot_map(slots, r)")
    _check_card(h, w, nby, nbx, grid, table, pm, smap)
    return (grid.data_ptr(), table.data_ptr(), _is16(table), None, 0, None, None, None,
            pm.data_ptr(), None, _rank_table_on(dev).data_ptr(), smap.data_ptr(),
            b, nby, nbx, nby // pm.shape[1], cur, h, w, r, 0, 0, 0, k_slots, nch, CHUNK)


def _pack_recompute(grid, vol, pm, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, cost):
    """E, F, 11 or 12: vol, win and rwin/rpm None where the form takes none."""
    _check_grid(grid, cur, h, w)
    if cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cost!r}: the kernels compute sad and ssd; zsad never takes a fused form")
    if not 0 <= store_r <= r:
        raise ValueError(f"need 0 <= store_r <= r = {r}, got {store_r}")
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    if vol is not None:
        _check_volume("volume", vol, b, (2 * r + 1) * (2 * store_r + 1), nby, nbx, dev)
    _check_centres("pm", pm, b, nby, nbx, dev)
    if im1.dtype != torch.uint8 or tuple(im1.shape) != (b, h, w) or im1.device != dev:
        raise ValueError(f"im1 must be ({b}, {h}, {w}) uint8 on {dev}, got "
                         f"{im1.dtype} {tuple(im1.shape)} on {im1.device}")
    f = nby // pm.shape[1]
    n_p = pm.shape[1] * pm.shape[2]
    if win is not None:
        _check_windows("win", win, b, n_p, f * cur + 2 * r, dev)
    if rwin is not None:
        _check_centres("rpm", rpm, b, nby, nbx, dev)
        if rpm.shape != pm.shape:
            raise ValueError("rpm and pm must have the same shape")
        _check_windows("rwin", rwin, b, n_p, f * cur + 2 * r2, dev)
    if not _on_card(grid):
        return None
    _check_card(h, w, nby, nbx, grid, vol, pm, im1, win, rwin, rpm)
    # the kernel reads frame-1 rows as 4-byte words (2-byte at cur = 2)
    align = 4 if cur >= 4 else 2
    if w % align or im1.data_ptr() % align:
        raise ValueError(f"im1 rows must be {align}-byte aligned at cur={cur}")
    return (grid.data_ptr(), _ptr(vol), _is16(vol), None, 0, im1.data_ptr(), _ptr(win),
            _ptr(rwin), pm.data_ptr(), _ptr(rpm), _rank_table_on(dev).data_ptr(), None,
            b, nby, nbx, f, cur, h, w, r, store_r, r2, int(cost == "ssd"), 0, 0, 0)


def _pack_hybrid(grid, cv, pm, *, im1, rwin, rpm, cur, h, w, r, r2, cost):
    return _pack_recompute(grid, cv, pm, im1, None, rwin, rpm, cur, h, w, r, r, r2, cost)


def _pack_hybrid_tail(grid, band, pm, *, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, cost):
    return _pack_recompute(grid, band, pm, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, cost)


def _pack_fused(grid, pm, *, im1, win, cur, h, w, r, cost):
    return _pack_recompute(grid, None, pm, im1, win, None, None, cur, h, w, r, r, 0, cost)


def _pack_fused_rival(grid, pm, *, im1, win, rwin, rpm, cur, h, w, r, r2, cost):
    return _pack_recompute(grid, None, pm, im1, win, rwin, rpm, cur, h, w, r, r, r2, cost)


# ------------------------------------------------------- the forms

class Form(NamedTuple):
    """A form of the round kernel."""

    name: str             # the wrappers' suffix: color_round_<name>, color_step_<name>
    code: int             # csrc/fused_step.cu enum Form
    counter: str          # what its rounds count under (utils.profiling.round_done)
    rows: str             # the TPU kernels it stands for
    pack: Callable        # its validate-and-pack (above)
    step_plain: Callable  # its plain colour step
    tiles: bool = True    # whether its single step takes tiles (``strips``)

    @property
    def round_name(self) -> str:
        return f"color_round_{self.name}"

    @property
    def step_name(self) -> str:
        return self.step_plain.__name__.removesuffix("_plain")


FORMS = {f.name: f for f in (
    Form("stored", 3, "stored", "D, D', 8 or 9", _pack_stored, color_step_plain),
    Form("compact", 4, "compact", "kernel 10", _pack_compact, color_step_compact_plain,
         tiles=False),
    Form("hybrid", 0, "hybrid", "kernel E", _pack_hybrid, color_step_hybrid_plain),
    Form("hybrid_tail", 1, "tail", "kernel F", _pack_hybrid_tail, color_step_hybrid_tail_plain),
    Form("fused", 2, "fused", "kernel 11", _pack_fused, color_step_fused_plain),
    Form("fused_rival", 2, "fused", "kernel 12", _pack_fused_rival,
         color_step_fused_rival_plain),
)}

# bbme_round(form, grid, cv, cv16, rcv, rcv16, im1, win, rwin, pm, rpm,
#            rank_table, smap, batch, nby, nbx, f, cur, h, w, r, store_r, r2,
#            ssd, k_slots, nch, chunk, row0_b, ghost, full_h, col0_b,
#            ghost_cols, full_w, step0, nsteps, lams, n_lam, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = ([_I, _P, _P, _I, _P, _I] + [_P] * 7 + [_I] * 14 + [_P, _P, _I, _P, _P, _I]
            + [_I, _I, ctypes.POINTER(ctypes.c_float), _I, _P])


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.entry("bbme_round", ARGTYPES)


def _launch(wrapper, code: int, args: tuple, device: torch.device, spans) -> None:
    """One launch of the entry point for each (step0, nsteps, lams) span, in
    turn on the current stream, each counted on ``wrapper``; ``args`` are
    the entry point's arguments from the grid to full_w."""
    entry = _entry()
    with torch.cuda.device(device):
        # the current stream's raw handle, as PyTorch's own generated launch
        # code reads it: ~0.2 us of host a call on the H100 machine, against
        # ~7.7 us for torch.cuda.current_stream().cuda_stream
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        for step0, nsteps, lams in spans:
            err = entry(code, *args, step0, nsteps, _lam_array(lams), len(lams), stream)
            _build.check(err, wrapper.__name__)
            wrapper.launches += 1


def _wrappers(form: Form) -> tuple:
    """The round wrapper, its plain version and the single step of
    ``form``."""

    def color_round_plain(grid, *tensors, lam, sweeps, **kw) -> None:
        _round_plain(form.step_plain, grid, *tensors, lam=lam, sweeps=sweeps, **kw)

    def color_round(grid, *tensors, lam, sweeps, **kw) -> None:
        args = form.pack(grid, *tensors, **kw)
        if args is None:
            color_round_plain(grid, *tensors, lam=lam, sweeps=sweeps, **kw)
            return
        lams = sweep_lams(lam, sweeps)
        _launch(color_round, form.code, args + (None, None, kw["h"], None, None, kw["w"]),
                grid.device, [(0, 4 * len(s), lams[s.start:s.stop]) for s in _spans(sweeps)])

    def color_step(grid, *tensors, ci, cj, lam_mult, strips=None, **kw) -> None:
        args = form.pack(grid, *tensors, **kw)
        if ci not in (0, 1) or cj not in (0, 1):
            raise ValueError(f"colour must be (0|1, 0|1), got ({ci}, {cj})")
        if strips is not None and not form.tiles:
            raise ValueError(f"{form.step_name} takes no tiles")
        tile = strip_args(strips, grid, kw["cur"], kw["h"], kw["w"])
        if args is None:
            on_strips(form.step_plain, grid, *tensors, ci=ci, cj=cj, lam_mult=lam_mult,
                      strips=strips, **kw)
            return
        _launch(color_step, form.code, args + tile, grid.device,
                [(2 * ci + cj, 1, (float(lam_mult),))])

    color_round.__doc__ = (
        f"{form.rows}, a whole round in place: ``sweeps`` sweeps of the four colours, sweep s "
        f"at ``lam * (s + 1)``; arguments as ``{form.pack.__name__}``.")
    color_round_plain.__doc__ = f"A round of {form.rows} with torch ops."
    color_step.__doc__ = (
        f"{form.rows}: one colour step (ci, cj) in place at ``lam_mult``"
        f"{', on tiles if ``strips`` is given' if form.tiles else ''}; arguments as "
        f"``{form.pack.__name__}``.")
    for fn, fn_name in ((color_round, form.round_name),
                        (color_round_plain, form.round_name + "_plain"),
                        (color_step, form.step_name)):
        fn.__name__ = fn.__qualname__ = fn_name
    color_round.launches = color_step.launches = 0
    color_round.per_round = color_round_plain.per_round = True
    color_round.form = color_round_plain.form = form.counter
    # what a round runs on tiles (ops.windowed.rounds_loop), step by step
    color_round.step = color_step
    color_round_plain.step = functools.partial(on_strips, form.step_plain)
    return color_round, color_round_plain, color_step


for _form in FORMS.values():
    for _fn in _wrappers(_form):
        globals()[_fn.__name__] = _fn
del _form, _fn
