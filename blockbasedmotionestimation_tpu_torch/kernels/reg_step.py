"""The colour steps of the windowed regularizer on stored volumes, in place
on the MV grid.

Replaces the TPU kernels ``windowed_color_step_rival`` (D, rounds at cur =
bs) and ``windowed_color_step_pm_rival`` (D', rounds at cur < bs of the
dense-rival form), and without rival windows ``windowed_color_step`` (8)
and ``windowed_color_step_pm`` (9), with one step that serves every round
on stored volumes; ``color_round_compact`` (a round) and
``color_step_compact`` (a colour step) replace
``windowed_color_step_pm_compact`` (kernel 10, ``cv_compact``'s rounds cur <
bs), the same step on K-slot tables.  ``window_deltas`` and
``select_costs`` are plain pieces the hybrid steps (``kernels.fused_step``)
share, with ``step_candidates`` and ``step_commit`` of ``ops.regularize``.

``color_step`` runs one colour step (colour (ci, cj), multiplier
``lam_mult``); ``color_round_stored`` runs a whole round: ``sweeps`` sweeps
of the four colours (``ops.regularize.COLORS``), sweep s at multiplier
``lam * (s + 1)``, computed in Python double and rounded to f32 as the
per-step loop rounds it (``sweep_lams``), validated once per round.  On the
card both launch the stored form of ``csrc/fused_step.cu``'s round kernel
(``round_kernel<kStored>``): a single step is a span of one colour step, a
round one cooperative launch with a grid barrier between its steps (up to
``MAX_SWEEPS`` sweeps a launch; more take several launches).  Kernel 10's
wrappers launch its compact form (``round_kernel<kCompact>``) the same way,
each candidate's slot looked up in ``ops.compact.slot_map``.  The round
helpers here (``sweep_lams``, ``_spans``, ``_launch_round``) serve the
round wrappers of ``kernels.fused_step`` too.

Layouts (batch written out):
  grid: (B, nby, nbx, 2) int32 MVs (x, y) at sub-block size cur, updated in
        place; nby = npy * f with f = bs // cur;
  cv:   (B, side^2, nby, nbx) main-window volume at cur (``kernels.cv_diff``);
  pm:   (B, npy, npx, 2) int32 main-window centre MVs of the parents;
  rcv / rpm / r2: the rival window's volume, centres and radius, or None;
  table: (B, K, nby, nbx) compact table at cur (``cv_diff.compact_tables``),
        slots: (B, nch, K, 2) its chunks' slot lists and smap: (B, nch,
        side^2) uint16 their ``ops.compact.slot_map`` (10).

Tiles (the tiled engine): the single steps take ``strips``
(``ops.regularize.Strips``: each entry's first row in its frame, the
frame's height and the ghost rows the caller refreshed before the step; on
2-D tiles also its first column, the frame's width and the ghost columns
with their corners); ``(ci, cj)`` is then the frame's colour.  On the card
that is the round kernel's span of one step with the tiles' arguments; on
the CPU the plain step under ``ops.regularize.on_strips``.  A tiled round
is a loop of single steps (``ops.windowed.rounds_loop``), so each round
wrapper names its single step as ``.step``.

For CPU tensors the wrappers run ``color_step_plain`` (the XLA branch of the
reference's ``_rounds_loop`` body, in torch; a round loops it) and
``color_step_compact_plain`` (the slot-compare formulation, which the map
lookup on the card is held to); for CUDA tensors they launch the round
kernel.  Nothing falls back from one to the other.  The wrappers take
u16/i32 volumes; the f32 volumes of ``cost="zsad"`` go to the plain step
and round by name, on any device (the reference runs zsad in XLA only).
"""

from __future__ import annotations

import ctypes
import functools

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


def _lam_array(lams: list[float]):
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


def _launch_round(wrapper, kernel, args: tuple, grid: torch.Tensor, lam: float,
                  sweeps: int) -> int:
    """Run a round on the card: one cooperative launch of ``kernel`` (a C
    round entry point) for each span of up to MAX_SWEEPS sweeps, each
    counted on ``wrapper``; ``args`` are the entry point's arguments before
    ``lams``.  Returns the launches."""
    lams = sweep_lams(lam, sweeps)
    spans = _spans(sweeps)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        for span in spans:
            part = lams[span.start:span.stop]
            code = kernel(*args, _lam_array(part), len(part), stream)
            _build.check(code, wrapper.__name__)
            wrapper.launches += 1
    return len(spans)


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
    """Update the cells of colour (ci, cj) of ``grid`` in place (ci: the
    grid's own row parity; see ``on_strips``)."""
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


# a single step's tiles (row0_b, ghost, full_h, col0_b, ghost_cols, full_w)
# and its colour, multiplier and stream
STEP_END = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# bbme_color_step(grid, cv, cv16, rcv, rcv16, pm, rpm, rank_table, batch, nby,
#                 nbx, f, cur, h, w, r, r2, row0_b, ghost, full_h, col0_b,
#                 ghost_cols, full_w, ci, cj, lam, stream)
_STORED_HEAD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
ARGTYPES = _STORED_HEAD + [ctypes.c_int] * 9 + STEP_END
# bbme_color_round_stored(grid, cv, cv16, rcv, rcv16, pm, rpm, rank_table,
#                         batch, nby, nbx, f, cur, h, w, r, r2, lams, nsweeps,
#                         stream)
ROUND_ARGTYPES = _STORED_HEAD + [ctypes.c_int] * 9 + [
    ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel(per_round: bool = False):
    if per_round:
        return _build.entry("bbme_color_round_stored", ROUND_ARGTYPES)
    return _build.entry("bbme_color_step", ARGTYPES)


@functools.lru_cache(maxsize=None)
def _rank_table_on(device: torch.device) -> torch.Tensor:
    return profiling.upload(reg._RANK_TABLE, device, "tables").contiguous()


def _check_grid(grid, cur, h, w, ci, cj):
    if grid.dtype != torch.int32 or grid.dim() != 4 or grid.shape[3] != 2:
        raise ValueError(f"grid must be (B, nby, nbx, 2) int32, got {grid.dtype} {tuple(grid.shape)}")
    if tuple(grid.shape[1:3]) != (h // cur, w // cur):
        raise ValueError(f"grid {tuple(grid.shape[1:3])} does not tile a {h}x{w} frame at cur={cur}")
    if ci not in (0, 1) or cj not in (0, 1):
        raise ValueError(f"colour must be (0|1, 0|1), got ({ci}, {cj})")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {grid.device}")


def _check_tile_tensor(name, t, shape, grid):
    if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != grid.device:
        raise ValueError(f"strips.{name} must be {shape} int32 on {grid.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def strip_args(strips: Strips | None, grid: torch.Tensor, cur: int, h: int, w: int) -> tuple:
    """Validate a single step's tiles; returns the C entry points'
    (row0_b, ghost, full_h, col0_b, ghost_cols, full_w): (None, None, h,
    None, None, w) for whole frames, the last three so for row strips."""
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
    if grid.device.type != "cuda":
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


def _stored_args(grid, cv, pm, cur, h, w, r, rcv, rpm, r2, ci, cj) -> tuple:
    """Validate a stored step's or round's inputs; returns the C entry
    points' arguments from the grid to r2 (the colour is checked only)."""
    _check_grid(grid, cur, h, w, ci, cj)
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
    if dev.type != "cuda":
        return ()
    tensors = [grid, cv, pm] + ([rcv, rpm] if rcv is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the stored colour steps need contiguous tensors")
    if nby * nbx * 2 >= 2**31 or h * w >= 2**31:
        raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")
    return (
        grid.data_ptr(), cv.data_ptr(), int(cv.dtype == torch.uint16),
        rcv.data_ptr() if rcv is not None else None,
        int(rcv is not None and rcv.dtype == torch.uint16),
        pm.data_ptr(), rpm.data_ptr() if rpm is not None else None,
        _rank_table_on(dev).data_ptr(),
        b, nby, nbx, nby // pm.shape[1], cur, h, w, r, r2,
    )


def _row(rcv, grid, pm) -> str:
    """The TPU kernel a stored step stands for: D / D' with rival windows
    at f = 1 / f >= 2, 8 / 9 without."""
    return ("D", "D'", "8", "9")[2 * (rcv is None) + (grid.shape[1] > pm.shape[1])]


def color_step(
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
    """One colour step, in place; see the module docstring for layouts
    and ``strips``."""
    args = _stored_args(grid, cv, pm, cur, h, w, r, rcv, rpm, r2, ci, cj)
    tile = strip_args(strips, grid, cur, h, w)
    if grid.device.type == "cpu":
        on_strips(color_step_plain, grid, cv, pm, cur=cur, h=h, w=w, r=r, ci=ci, cj=cj,
                  lam_mult=lam_mult, rcv=rcv, rpm=rpm, r2=r2, strips=strips)
        return
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(*args, *tile, ci, cj, float(lam_mult), stream)
    _build.check(code, "color_step")
    color_step.launches += 1
    color_step.row_launches[_row(rcv, grid, pm)] += 1


color_step.launches = 0
# the TPU kernels this one kernel stands for, counted apart: D / D' with
# rival windows at f = 1 / f >= 2, 8 / 9 without
color_step.row_launches = dict.fromkeys(("D", "D'", "8", "9"), 0)


def color_round_stored_plain(grid, cv, pm, *, lam, sweeps, **kw) -> None:
    """A round of D/D'/8/9 with torch ops: ``sweeps`` x the four colours.
    Also the rounds of ``cost="zsad"`` on f32 volumes, which no kernel
    takes (``color_round_stored`` refuses them): the energy is the f32
    cost plus lam * smoothness, as the reference's XLA round computes it."""
    _round_plain(color_step_plain, grid, cv, pm, lam=lam, sweeps=sweeps, **kw)


def color_round_stored(
    grid: torch.Tensor,
    cv: torch.Tensor,
    pm: torch.Tensor,
    *,
    cur: int,
    h: int,
    w: int,
    r: int,
    lam: float,
    sweeps: int,
    rcv: torch.Tensor | None = None,
    rpm: torch.Tensor | None = None,
    r2: int = 0,
) -> None:
    """D, D', 8 or 9, a whole round in place: ``sweeps`` sweeps of the four
    colours, sweep s at ``lam * (s + 1)``; see the module docstring."""
    args = _stored_args(grid, cv, pm, cur, h, w, r, rcv, rpm, r2, 0, 0)
    if grid.device.type == "cpu":
        color_round_stored_plain(grid, cv, pm, cur=cur, h=h, w=w, r=r, lam=lam, sweeps=sweeps,
                                 rcv=rcv, rpm=rpm, r2=r2)
        return
    n = _launch_round(color_round_stored, _kernel(True), args, grid, lam, sweeps)
    color_round_stored.row_launches[_row(rcv, grid, pm)] += n


color_round_stored.launches = 0
color_round_stored.row_launches = dict.fromkeys(("D", "D'", "8", "9"), 0)
# what ops.windowed.rounds_loop calls once per round, not once per step;
# on row strips it calls the round's single step, step by step
color_round_stored.per_round = color_round_stored_plain.per_round = True
color_round_stored.step = color_step
color_round_stored_plain.step = functools.partial(on_strips, color_step_plain)


# ------------------------------------------------- compact colour step (10)

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
) -> None:
    """Kernel 10 with torch ops: update colour (ci, cj) of ``grid`` in place.

    A candidate's cost is the table entry of the slot of its cell's chunk
    that holds its delta (rebased on the parent's window centre), found by
    comparing the delta with every slot; a candidate
    in no slot is excluded, and a cell whose own MV is in no slot keeps it
    (every candidate excluded: rank decides, own MV first)."""
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


def color_round_compact_plain(grid, table, pm, slots, *, lam, sweeps, smap=None, **kw) -> None:
    """A round of kernel 10 with torch ops: ``sweeps`` x the four colours.
    The plain step finds slots by comparison, so the kernel's ``smap`` is
    dropped here."""
    _round_plain(color_step_compact_plain, grid, table, pm, slots, lam=lam, sweeps=sweeps, **kw)


# bbme_color_step_compact(grid, table, table16, smap, pm, rank_table, batch,
#                         nby, nbx, f, cur, h, w, r, k_slots, nch, chunk, ci, cj,
#                         lam, stream)
_COMPACT_HEAD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
COMPACT_ARGTYPES = _COMPACT_HEAD + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
# bbme_color_round_compact(grid, table, table16, smap, pm, rank_table, batch,
#                          nby, nbx, f, cur, h, w, r, k_slots, nch, chunk, lams,
#                          nsweeps, stream)
ROUND_COMPACT_ARGTYPES = _COMPACT_HEAD + [ctypes.c_int] * 11 + [
    ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _compact_kernel(per_round: bool = False):
    if per_round:
        return _build.entry("bbme_color_round_compact", ROUND_COMPACT_ARGTYPES)
    return _build.entry("bbme_color_step_compact", COMPACT_ARGTYPES)


def _compact_args(grid, table, pm, slots, smap, cur, h, w, r, ci, cj) -> tuple:
    """Validate a compact step's or round's inputs; returns the C entry
    points' arguments from the grid to the chunk (the colour is checked
    only).  On the card ``smap`` is required (the caller keeps it alive
    through the launch)."""
    _check_grid(grid, cur, h, w, ci, cj)
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    _check_centres("pm", pm, b, nby, nbx, dev)
    n_p = pm.shape[1] * pm.shape[2]
    nch = -(-n_p // CHUNK)
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
    if dev.type != "cuda":
        return ()
    if smap is None:
        raise ValueError("on the card the compact colour steps need smap, the level's "
                         "ops.compact.slot_map(slots, r)")
    if not all(t.is_contiguous() for t in (grid, table, pm, smap)):
        raise ValueError("the compact colour steps need contiguous tensors")
    if nby * nbx * 2 >= 2**31 or h * w >= 2**31:
        raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")
    return (
        grid.data_ptr(), table.data_ptr(), int(table.dtype == torch.uint16), smap.data_ptr(),
        pm.data_ptr(), _rank_table_on(dev).data_ptr(),
        b, nby, nbx, nby // pm.shape[1], cur, h, w, r, k_slots, nch, CHUNK,
    )


def color_step_compact(
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
    """Kernel 10: one colour step on a K-slot table, in place (on the card a
    span of one step of the round kernel's compact form).  table: (B, K,
    nby, nbx) (``cv_diff.compact_tables`` at cur); slots: the level's (B,
    nch, K, 2) ``ops.compact.chunk_delta_slots``; smap: its ``slot_map``,
    required on the card (the CPU's plain version compares with the slots)."""
    args = _compact_args(grid, table, pm, slots, smap, cur, h, w, r, ci, cj)
    if grid.device.type == "cpu":
        color_step_compact_plain(grid, table, pm, slots, cur=cur, h=h, w=w, r=r, ci=ci, cj=cj,
                                 lam_mult=lam_mult)
        return
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _compact_kernel()(*args, ci, cj, float(lam_mult), stream)
    _build.check(code, "color_step_compact")
    color_step_compact.launches += 1


color_step_compact.launches = 0


def color_round_compact(
    grid: torch.Tensor,
    table: torch.Tensor,
    pm: torch.Tensor,
    slots: torch.Tensor,
    *,
    cur: int,
    h: int,
    w: int,
    r: int,
    lam: float,
    sweeps: int,
    smap: torch.Tensor | None = None,
) -> None:
    """Kernel 10, a whole round in place: ``sweeps`` sweeps of the four
    colours, sweep s at ``lam * (s + 1)``; arguments as
    ``color_step_compact``."""
    args = _compact_args(grid, table, pm, slots, smap, cur, h, w, r, 0, 0)
    if grid.device.type == "cpu":
        color_round_compact_plain(grid, table, pm, slots, cur=cur, h=h, w=w, r=r, lam=lam,
                                  sweeps=sweeps)
        return
    _launch_round(color_round_compact, _compact_kernel(True), args, grid, lam, sweeps)


color_round_compact.launches = 0
color_round_compact.per_round = color_round_compact_plain.per_round = True
