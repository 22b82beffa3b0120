"""The colour steps that recompute candidate costs from window pixels
(kernels E, F, 11 and 12).

Replace the TPU kernels ``windowed_color_step_pm_hybrid`` (E),
``windowed_color_step_pm_hybrid_tail`` (F), ``windowed_color_step_pm_fused``
(11) and ``windowed_color_step_pm_fused_rival`` (12).  Each is one colour
step, in place on the MV grid like ``kernels.reg_step.color_step``, whose
candidate costs come from where its form keeps them:

  * E (the hybrid form's rounds cur <= fuse_max): main-window candidates
    from the dense main volume at cur; rival candidates (in the rival
    window, not in the main one) recomputed against the rival window's
    pixels;
  * F (the cur = 2 round with the stored band): main-window candidates with
    |dx - pm_x| <= store_r from the band (``cv_diff.pooled_cvs(store_r=)``),
    the other main-window candidates recomputed against the main window's
    pixels, rival candidates against the rival window's;
  * 11 (``cv_fused``'s rounds cur <= fuse): no volume, every main-window
    candidate recomputed against the main window's pixels;
  * 12 (the same with rival windows): 11, and rival candidates against the
    rival window's pixels.

A recomputed cost is the cur x cur SAD/SSD of the cell's frame-1 sub-block
against the window the volumes were built from (kernel A's output, with its
zero padding), so it equals the stored value bit for bit.

Layouts (batch written out), beside ``reg_step``'s grid / pm / rpm:
  im1:  (B, h, w) u8 frame-1 level image;
  win:  (B, nP, bs + 2r, bs + 2r) u8 main windows (F, 11, 12);
  rwin: (B, nP, bs + 2r2, bs + 2r2) u8 rival windows (E, F, 12);
  cv:   (B, side^2, nby, nbx) main volume at cur (E);
  band: (B, side * (2 store_r + 1), nby, nbx) stored cur=2 band (F).

Each kernel has two entry points, as ``kernels.reg_step``'s stored steps
(D, D', 8, 9) have, with which they share the round kernel.  ``color_step_*`` runs one colour step
(colour (ci, cj), multiplier ``lam_mult``).  ``color_round_*`` runs a whole
round: ``sweeps`` sweeps of the four colours (``ops.regularize.COLORS``),
sweep s at multiplier ``lam * (s + 1)``, computed in Python double and
rounded to f32 as the per-step loop rounds it (``sweep_lams``); each is
validated once per round.  For CPU tensors the wrappers run the
``*_plain`` versions (the round ones loop the plain steps); for CUDA
tensors they launch ``csrc/fused_step.cu`` (one kernel template for the
four), one colour step a launch, or one cooperative launch a round with a
grid barrier between its steps (up to ``MAX_SWEEPS`` sweeps a launch; more
take several launches).  Nothing falls back from one to the other.  The
single steps take tiles (``strips``: row strips or 2-D tiles) as
``reg_step.color_step`` does, and each round wrapper names its single step
as ``.step``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.kernels import reg_step as rs
from blockbasedmotionestimation_tpu_torch.kernels.reg_step import (  # noqa: F401 (re-exported)
    MAX_SWEEPS,
    _lam_array,
    _round_plain,
    _spans,
    sweep_lams,
)
from blockbasedmotionestimation_tpu_torch.ops.regularize import (
    Strips,
    on_strips,
    step_candidates,
    step_commit,
)


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


def _hybrid_plain(
    grid, vol, pm, *, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, ci, cj, lam_mult, cost,
    strips=None,
) -> None:
    """E (win None: vol is the dense main volume) or F (vol is the band)."""
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, strips=strips)
    ddy, ddx, in_window = rs.window_deltas(cands, pm, f, ci, cj, r)
    rdy, rdx, in_rival = rs.window_deltas(cands, rpm, f, ci, cj, r2)
    costs = recompute_costs(im1, rwin, rdy, rdx, r2, cur, ci, cj, cost)
    if win is None:
        costs = torch.where(in_window, rs.select_costs(vol[:, :, ci::2, cj::2], ddy, ddx, r), costs)
    else:
        tail = recompute_costs(im1, win, ddy, ddx, r, cur, ci, cj, cost)
        band = rs.select_costs(vol[:, :, ci::2, cj::2], ddy, ddx, r, store_r)
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


# bbme_color_step_hybrid(grid, cv, cv16, im1, rwin, pm, rpm, rank_table, batch,
#                        nby, nbx, f, cur, h, w, r, r2, ssd, row0_b, ghost,
#                        full_h, col0_b, ghost_cols, full_w, ci, cj, lam, stream)
ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 10 + rs.STEP_END
)
# bbme_color_step_hybrid_tail(grid, band, band16, im1, win, rwin, pm, rpm,
#                             rank_table, batch, nby, nbx, f, cur, h, w, r,
#                             store_r, r2, ssd, row0_b, ghost, full_h, col0_b,
#                             ghost_cols, full_w, ci, cj, lam, stream)
TAIL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 11 + rs.STEP_END
)


@functools.lru_cache(maxsize=None)
def _kernel(tail: bool):
    if tail:
        return _build.entry("bbme_color_step_hybrid_tail", TAIL_ARGTYPES)
    return _build.entry("bbme_color_step_hybrid", ARGTYPES)


def _check_windows(name, t, b, n_p, edge, dev):
    if t.dtype != torch.uint8 or tuple(t.shape) != (b, n_p, edge, edge):
        raise ValueError(f"{name} must be ({b}, {n_p}, {edge}, {edge}) uint8, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, grid on {dev}")


def _checked(grid, vol, pm, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, ci, cj, cost):
    """Validate one step's inputs (E, F, 11 or 12: vol, win and rwin/rpm
    may be None where the step takes none); returns f (cells per parent
    edge)."""
    rs._check_grid(grid, cur, h, w, ci, cj)
    if cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cost!r}: the kernels compute sad and ssd; zsad never takes a fused form")
    if not 0 <= store_r <= r:
        raise ValueError(f"need 0 <= store_r <= r = {r}, got {store_r}")
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    if vol is not None:
        rs._check_volume("volume", vol, b, (2 * r + 1) * (2 * store_r + 1), nby, nbx, dev)
    rs._check_centres("pm", pm, b, nby, nbx, dev)
    if im1.dtype != torch.uint8 or tuple(im1.shape) != (b, h, w) or im1.device != dev:
        raise ValueError(f"im1 must be ({b}, {h}, {w}) uint8 on {dev}, got "
                         f"{im1.dtype} {tuple(im1.shape)} on {im1.device}")
    f = nby // pm.shape[1]
    n_p = pm.shape[1] * pm.shape[2]
    if win is not None:
        _check_windows("win", win, b, n_p, f * cur + 2 * r, dev)
    if rwin is not None:
        rs._check_centres("rpm", rpm, b, nby, nbx, dev)
        if rpm.shape != pm.shape:
            raise ValueError("rpm and pm must have the same shape")
        _check_windows("rwin", rwin, b, n_p, f * cur + 2 * r2, dev)
    tensors = [t for t in (grid, vol, pm, im1, win, rwin, rpm) if t is not None]
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("the colour steps need contiguous tensors")
        # the kernel reads frame-1 rows as 4-byte words (2-byte at cur = 2)
        # and indexes a frame with 32-bit ints
        align = 4 if cur >= 4 else 2
        if w % align or im1.data_ptr() % align:
            raise ValueError(f"im1 rows must be {align}-byte aligned at cur={cur}")
        if nby * nbx * 2 >= 2**31 or h * w >= 2**31:
            raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")
    return f


def color_step_hybrid(
    grid: torch.Tensor,
    cv: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    r2: int,
    ci: int,
    cj: int,
    lam_mult: float,
    cost: str,
    strips: Strips | None = None,
) -> None:
    """Kernel E: one colour step, in place; see the module docstring."""
    f = _checked(grid, cv, pm, im1, None, rwin, rpm, cur, h, w, r, r, r2, ci, cj, cost)
    tile = rs.strip_args(strips, grid, cur, h, w)
    if grid.device.type == "cpu":
        on_strips(color_step_hybrid_plain, grid, cv, pm, im1=im1, rwin=rwin, rpm=rpm, cur=cur,
                  h=h, w=w, r=r, r2=r2, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost,
                  strips=strips)
        return
    b, nby, nbx, _ = grid.shape
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel(False)(
            grid.data_ptr(), cv.data_ptr(), int(cv.dtype == torch.uint16), im1.data_ptr(),
            rwin.data_ptr(), pm.data_ptr(), rpm.data_ptr(),
            rs._rank_table_on(grid.device).data_ptr(),
            b, nby, nbx, f, cur, h, w, r, r2, int(cost == "ssd"), *tile, ci, cj,
            float(lam_mult), stream,
        )
    _build.check(code, "color_step_hybrid")
    color_step_hybrid.launches += 1


def color_step_hybrid_tail(
    grid: torch.Tensor,
    band: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    store_r: int,
    r2: int,
    ci: int,
    cj: int,
    lam_mult: float,
    cost: str,
    strips: Strips | None = None,
) -> None:
    """Kernel F: one colour step on the stored band, in place; see the
    module docstring."""
    f = _checked(grid, band, pm, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, ci, cj, cost)
    tile = rs.strip_args(strips, grid, cur, h, w)
    if grid.device.type == "cpu":
        on_strips(
            color_step_hybrid_tail_plain, grid, band, pm, im1=im1, win=win, rwin=rwin, rpm=rpm,
            cur=cur, h=h, w=w, r=r, store_r=store_r, r2=r2, ci=ci, cj=cj, lam_mult=lam_mult,
            cost=cost, strips=strips,
        )
        return
    b, nby, nbx, _ = grid.shape
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel(True)(
            grid.data_ptr(), band.data_ptr(), int(band.dtype == torch.uint16),
            im1.data_ptr(), win.data_ptr(), rwin.data_ptr(), pm.data_ptr(), rpm.data_ptr(),
            rs._rank_table_on(grid.device).data_ptr(),
            b, nby, nbx, f, cur, h, w, r, store_r, r2, int(cost == "ssd"), *tile, ci, cj,
            float(lam_mult), stream,
        )
    _build.check(code, "color_step_hybrid_tail")
    color_step_hybrid_tail.launches += 1


color_step_hybrid.launches = 0
color_step_hybrid_tail.launches = 0


# ------------------------------------------------- whole rounds (E, F, 11, 12)

_ROUND_HEAD = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_ROUND_END = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
# bbme_color_round_hybrid(grid, cv, cv16, im1, rwin, pm, rpm, rank_table,
#                         batch, nby, nbx, f, cur, h, w, r, r2, ssd, lams,
#                         nsweeps, stream)
ROUND_ARGTYPES = _ROUND_HEAD + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + _ROUND_END
# bbme_color_round_hybrid_tail(grid, band, band16, im1, win, rwin, pm, rpm,
#                              rank_table, batch, nby, nbx, f, cur, h, w, r,
#                              store_r, r2, ssd, lams, nsweeps, stream)
ROUND_TAIL_ARGTYPES = _ROUND_HEAD + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + _ROUND_END
# bbme_color_round_fused(grid, im1, win, rwin, pm, rpm, rank_table, batch,
#                        nby, nbx, f, cur, h, w, r, r2, ssd, lams, nsweeps,
#                        stream)
ROUND_FUSED_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + _ROUND_END


@functools.lru_cache(maxsize=None)
def _round_kernel(name: str):
    argtypes = {"bbme_color_round_hybrid": ROUND_ARGTYPES,
                "bbme_color_round_hybrid_tail": ROUND_TAIL_ARGTYPES,
                "bbme_color_round_fused": ROUND_FUSED_ARGTYPES}[name]
    return _build.entry(name, argtypes)


def color_round_hybrid_plain(grid, cv, pm, *, lam, sweeps, **kw) -> None:
    """A round of kernel E with torch ops: ``sweeps`` x the four colours."""
    _round_plain(color_step_hybrid_plain, grid, cv, pm, lam=lam, sweeps=sweeps, **kw)


def color_round_hybrid_tail_plain(grid, band, pm, *, lam, sweeps, **kw) -> None:
    """A round of kernel F with torch ops."""
    _round_plain(color_step_hybrid_tail_plain, grid, band, pm, lam=lam, sweeps=sweeps, **kw)


def color_round_hybrid(
    grid: torch.Tensor,
    cv: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    r2: int,
    lam: float,
    sweeps: int,
    cost: str,
) -> None:
    """Kernel E, a whole round in place: ``sweeps`` sweeps of the four
    colours, sweep s at ``lam * (s + 1)``; see the module docstring."""
    f = _checked(grid, cv, pm, im1, None, rwin, rpm, cur, h, w, r, r, r2, 0, 0, cost)
    if grid.device.type == "cpu":
        color_round_hybrid_plain(grid, cv, pm, im1=im1, rwin=rwin, rpm=rpm, cur=cur, h=h, w=w,
                                 r=r, r2=r2, lam=lam, sweeps=sweeps, cost=cost)
        return
    b, nby, nbx, _ = grid.shape
    rs._launch_round(color_round_hybrid, _round_kernel("bbme_color_round_hybrid"), (
        grid.data_ptr(), cv.data_ptr(), int(cv.dtype == torch.uint16), im1.data_ptr(),
        rwin.data_ptr(), pm.data_ptr(), rpm.data_ptr(),
        rs._rank_table_on(grid.device).data_ptr(),
        b, nby, nbx, f, cur, h, w, r, r2, int(cost == "ssd"),
    ), grid, lam, sweeps)


def color_round_hybrid_tail(
    grid: torch.Tensor,
    band: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    store_r: int,
    r2: int,
    lam: float,
    sweeps: int,
    cost: str,
) -> None:
    """Kernel F, a whole round on the stored band, in place."""
    f = _checked(grid, band, pm, im1, win, rwin, rpm, cur, h, w, r, store_r, r2, 0, 0, cost)
    if grid.device.type == "cpu":
        color_round_hybrid_tail_plain(
            grid, band, pm, im1=im1, win=win, rwin=rwin, rpm=rpm, cur=cur, h=h, w=w, r=r,
            store_r=store_r, r2=r2, lam=lam, sweeps=sweeps, cost=cost,
        )
        return
    b, nby, nbx, _ = grid.shape
    rs._launch_round(color_round_hybrid_tail, _round_kernel("bbme_color_round_hybrid_tail"), (
        grid.data_ptr(), band.data_ptr(), int(band.dtype == torch.uint16), im1.data_ptr(),
        win.data_ptr(), rwin.data_ptr(), pm.data_ptr(), rpm.data_ptr(),
        rs._rank_table_on(grid.device).data_ptr(),
        b, nby, nbx, f, cur, h, w, r, store_r, r2, int(cost == "ssd"),
    ), grid, lam, sweeps)


color_round_hybrid.launches = 0
color_round_hybrid_tail.launches = 0


# ----------------------------------------- cv_fused colour steps (11, 12)

def _fused_plain(grid, pm, *, im1, win, rwin, rpm, cur, h, w, r, r2, ci, cj, lam_mult,
                 cost, strips=None) -> None:
    f = grid.shape[1] // pm.shape[1]
    cands, rank, present, in_img = step_candidates(grid, cur, h, w, ci, cj, strips=strips)
    ddy, ddx, in_window = rs.window_deltas(cands, pm, f, ci, cj, r)
    costs = recompute_costs(im1, win, ddy, ddx, r, cur, ci, cj, cost)
    if rwin is not None:
        rdy, rdx, in_rival = rs.window_deltas(cands, rpm, f, ci, cj, r2)
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


# bbme_color_step_fused(grid, im1, win, rwin, pm, rpm, rank_table, batch, nby,
#                       nbx, f, cur, h, w, r, r2, ssd, row0_b, ghost, full_h,
#                       col0_b, ghost_cols, full_w, ci, cj, lam, stream)
FUSED_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + rs.STEP_END


@functools.lru_cache(maxsize=None)
def _fused_kernel():
    return _build.entry("bbme_color_step_fused", FUSED_ARGTYPES)


def _launch_fused(wrapper, grid, pm, im1, win, rwin, rpm, cur, h, w, r, r2, ci, cj, lam_mult,
                  cost, strips) -> None:
    """Check a fused step's inputs; run the plain version on the CPU, else
    launch the kernel and count the launch on ``wrapper``."""
    f = _checked(grid, None, pm, im1, win, rwin, rpm, cur, h, w, r, r, r2, ci, cj, cost)
    tile = rs.strip_args(strips, grid, cur, h, w)
    if grid.device.type == "cpu":
        on_strips(_fused_plain, grid, pm, im1=im1, win=win, rwin=rwin, rpm=rpm, cur=cur, h=h,
                  w=w, r=r, r2=r2, ci=ci, cj=cj, lam_mult=lam_mult, cost=cost, strips=strips)
        return
    b, nby, nbx, _ = grid.shape
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _fused_kernel()(
            grid.data_ptr(), im1.data_ptr(), win.data_ptr(),
            rwin.data_ptr() if rwin is not None else None, pm.data_ptr(),
            rpm.data_ptr() if rwin is not None else None,
            rs._rank_table_on(grid.device).data_ptr(),
            b, nby, nbx, f, cur, h, w, r, r2, int(cost == "ssd"), *tile, ci, cj,
            float(lam_mult), stream,
        )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1


def color_step_fused(
    grid: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    ci: int,
    cj: int,
    lam_mult: float,
    cost: str,
    strips: Strips | None = None,
) -> None:
    """Kernel 11: one colour step, in place, every candidate's cost
    recomputed against the main window ``win`` (no volume)."""
    _launch_fused(color_step_fused, grid, pm, im1, win, None, None, cur, h, w, r, 0, ci, cj,
                  lam_mult, cost, strips)


def color_step_fused_rival(
    grid: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    r2: int,
    ci: int,
    cj: int,
    lam_mult: float,
    cost: str,
    strips: Strips | None = None,
) -> None:
    """Kernel 12: kernel 11 with rival windows: candidates outside the main
    window are recomputed against the rival window ``rwin``."""
    _launch_fused(color_step_fused_rival, grid, pm, im1, win, rwin, rpm, cur, h, w, r, r2, ci,
                  cj, lam_mult, cost, strips)


color_step_fused.launches = 0
color_step_fused_rival.launches = 0


def color_round_fused_plain(grid, pm, *, lam, sweeps, **kw) -> None:
    """A round of kernel 11 with torch ops."""
    _round_plain(color_step_fused_plain, grid, pm, lam=lam, sweeps=sweeps, **kw)


def color_round_fused_rival_plain(grid, pm, *, lam, sweeps, **kw) -> None:
    """A round of kernel 12 with torch ops."""
    _round_plain(color_step_fused_rival_plain, grid, pm, lam=lam, sweeps=sweeps, **kw)


def _fused_round(wrapper, grid, pm, im1, win, rwin, rpm, cur, h, w, r, r2, lam, sweeps,
                 cost) -> None:
    """Check a fused round's inputs; run the plain steps on the CPU, else
    launch the round kernel and count its launches on ``wrapper``."""
    f = _checked(grid, None, pm, im1, win, rwin, rpm, cur, h, w, r, r, r2, 0, 0, cost)
    if grid.device.type == "cpu":
        _round_plain(_fused_plain, grid, pm, im1=im1, win=win, rwin=rwin, rpm=rpm, cur=cur, h=h,
                     w=w, r=r, r2=r2, lam=lam, sweeps=sweeps, cost=cost)
        return
    b, nby, nbx, _ = grid.shape
    rs._launch_round(wrapper, _round_kernel("bbme_color_round_fused"), (
        grid.data_ptr(), im1.data_ptr(), win.data_ptr(),
        rwin.data_ptr() if rwin is not None else None, pm.data_ptr(),
        rpm.data_ptr() if rwin is not None else None,
        rs._rank_table_on(grid.device).data_ptr(),
        b, nby, nbx, f, cur, h, w, r, r2, int(cost == "ssd"),
    ), grid, lam, sweeps)


def color_round_fused(
    grid: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    lam: float,
    sweeps: int,
    cost: str,
) -> None:
    """Kernel 11, a whole round in place."""
    _fused_round(color_round_fused, grid, pm, im1, win, None, None, cur, h, w, r, 0, lam,
                 sweeps, cost)


def color_round_fused_rival(
    grid: torch.Tensor,
    pm: torch.Tensor,
    *,
    im1: torch.Tensor,
    win: torch.Tensor,
    rwin: torch.Tensor,
    rpm: torch.Tensor,
    cur: int,
    h: int,
    w: int,
    r: int,
    r2: int,
    lam: float,
    sweeps: int,
    cost: str,
) -> None:
    """Kernel 12, a whole round in place."""
    _fused_round(color_round_fused_rival, grid, pm, im1, win, rwin, rpm, cur, h, w, r, r2, lam,
                 sweeps, cost)


color_round_fused.launches = 0
color_round_fused_rival.launches = 0
# the single step of each round, for the rounds on row strips
color_round_hybrid.step = color_step_hybrid
color_round_hybrid_tail.step = color_step_hybrid_tail
color_round_fused.step = color_step_fused
color_round_fused_rival.step = color_step_fused_rival
color_round_hybrid_plain.step = functools.partial(on_strips, color_step_hybrid_plain)
color_round_hybrid_tail_plain.step = functools.partial(on_strips, color_step_hybrid_tail_plain)
color_round_fused_plain.step = functools.partial(on_strips, color_step_fused_plain)
color_round_fused_rival_plain.step = functools.partial(on_strips, color_step_fused_rival_plain)
# what ops.windowed.rounds_loop calls once per round, not once per step
for _fn in (color_round_hybrid, color_round_hybrid_tail, color_round_fused,
            color_round_fused_rival, color_round_hybrid_plain, color_round_hybrid_tail_plain,
            color_round_fused_plain, color_round_fused_rival_plain):
    _fn.per_round = True
del _fn
