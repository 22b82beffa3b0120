"""One colour step of the windowed regularizer, in place on the MV grid.

Replaces the TPU kernels ``windowed_color_step_rival`` (rounds at cur = bs)
and ``windowed_color_step_pm_rival`` (rounds at cur < bs) with one step that
serves every round, with or without rival windows.

Layouts (batch written out):
  grid: (B, nby, nbx, 2) int32 MVs (x, y) at sub-block size cur, updated in
        place; nby = npy * f with f = bs // cur;
  cv:   (B, side^2, nby, nbx) main-window volume at cur (``kernels.cv_diff``);
  pm:   (B, npy, npx, 2) int32 main-window centre MVs of the parents;
  rcv / rpm / r2: the rival window's volume, centres and radius, or None.

For CPU tensors the wrapper runs ``color_step_plain`` (the XLA branch of the
reference's ``_rounds_loop`` body, in torch); for CUDA tensors it launches
``csrc/reg_step.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.ops import regularize as reg

_F32_MAX = float(np.finfo(np.float32).max)


def select_costs(
    cv_slab: torch.Tensor,  # (B, side^2, m, n) volume at one colour's cells
    ddy: torch.Tensor,      # (B, m, n, 9) candidate delta rows
    ddx: torch.Tensor,      # (B, m, n, 9) candidate delta cols
    r: int,
) -> torch.Tensor:
    """(B, m, n, 9) f32 costs at the (clipped) candidate deltas."""
    side = 2 * r + 1
    key = (ddy + r).clamp(0, side - 1) * side + (ddx + r).clamp(0, side - 1)
    vals = torch.gather(cv_slab.to(torch.int32), 1, key.permute(0, 3, 1, 2).long())
    return vals.permute(0, 2, 3, 1).to(torch.float32)


def _parent_slab(mv: torch.Tensor, f: int, ci: int, cj: int, m: int, n: int):
    """Parent MVs (B, npy, npx, 2) at the cells of colour (ci, cj)."""
    rows = torch.arange(ci, ci + 2 * m, 2, device=mv.device) // f
    cols = torch.arange(cj, cj + 2 * n, 2, device=mv.device) // f
    return mv[:, rows][:, :, cols]


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
) -> None:
    """Update the cells of colour (ci, cj) of ``grid`` in place."""
    b, nby, nbx, _ = grid.shape
    f = nby // pm.shape[1]
    dev = grid.device
    m, n = (nby - ci + 1) // 2, (nbx - cj + 1) // 2
    nby_t, nbx_t = h // cur, w // cur
    # zero ring = the reference's padded grid: off-grid slots read 0
    gp = F.pad(grid, (0, 0, 1, 1, 1, 1))
    cands = torch.stack(
        [
            gp[:, 1 + ci + dy : 1 + ci + dy + 2 * m - 1 : 2,
               1 + cj + dx : 1 + cj + dx + 2 * n - 1 : 2]
            for dy, dx in reg.SLOTS
        ],
        dim=3,
    )  # (B, m, n, 9, 2) int32

    gi = ci + 2 * torch.arange(m, device=dev)[:, None]
    gj = cj + 2 * torch.arange(n, device=dev)[None, :]
    case = reg.border_case(gi, gj, nby_t, nbx_t)
    rank = torch.as_tensor(reg._RANK_TABLE, device=dev)[case]  # (m, n, 9)
    slot_dy = torch.tensor([s[0] for s in reg.SLOTS], device=dev)
    slot_dx = torch.tensor([s[1] for s in reg.SLOTS], device=dev)
    ty_, tx_ = gi[..., None] + slot_dy, gj[..., None] + slot_dx
    present = (
        (rank < reg._BIG_RANK)
        & (ty_ >= 0) & (ty_ < nby_t) & (tx_ >= 0) & (tx_ < nbx_t)
    )

    cx, cy = cands[..., 0], cands[..., 1]  # (B, m, n, 9)
    pms = _parent_slab(pm, f, ci, cj, m, n)
    ddx = cx - pms[..., None, 0]
    ddy = cy - pms[..., None, 1]
    in_window = (ddx.abs() <= r) & (ddy.abs() <= r)
    t_x = (gj * cur)[..., None] + cx
    t_y = (gi * cur)[..., None] + cy
    in_img = (t_x >= 0) & (t_x <= w - cur) & (t_y >= 0) & (t_y <= h - cur)

    costs = select_costs(cv[:, :, ci::2, cj::2], ddy, ddx, r)
    if rcv is not None:
        # own window first; the rival cost only for own-excluded candidates
        rps = _parent_slab(rpm, f, ci, cj, m, n)
        rdx = cx - rps[..., None, 0]
        rdy = cy - rps[..., None, 1]
        in_rival = (rdx.abs() <= r2) & (rdy.abs() <= r2)
        rcosts = select_costs(rcv[:, :, ci::2, cj::2], rdy, rdx, r2)
        costs = torch.where(in_window, costs, rcosts)
        in_window = in_window | in_rival

    cf = cands.to(torch.float32)
    du = (cf[..., :, None, 0] - cf[..., None, :, 0]).abs()
    dv = (cf[..., :, None, 1] - cf[..., None, :, 1]).abs()
    smooth = ((du + dv) * present.to(torch.float32)[..., None, :]).sum(dim=-1)
    lam = torch.tensor(lam_mult, dtype=torch.float32, device=dev)
    energy = torch.where(
        present & in_img & in_window, costs + lam * smooth, _F32_MAX
    )
    winner = reg.select_lexicographic(energy, rank.expand_as(energy))
    new_mv = torch.gather(
        cands, 3, winner[..., None, None].expand(b, m, n, 1, 2)
    )[:, :, :, 0]
    grid[:, ci::2, cj::2] = new_mv


# bbme_color_step(grid, cv, cv16, rcv, rcv16, pm, rpm, rank_table, batch, nby,
#                 nbx, f, cur, h, w, r, r2, ci, cj, lam, stream)
ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.entry("bbme_color_step", ARGTYPES)


@functools.lru_cache(maxsize=None)
def _rank_table_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(reg._RANK_TABLE, device=device).contiguous()


def _check_volume(name, vol, b, side, nby, nbx, dev):
    want = (b, side * side, nby, nbx)
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
) -> None:
    """One colour step, in place; see the module docstring for layouts."""
    if grid.dtype != torch.int32 or grid.dim() != 4 or grid.shape[3] != 2:
        raise ValueError(f"grid must be (B, nby, nbx, 2) int32, got {grid.dtype} {tuple(grid.shape)}")
    b, nby, nbx, _ = grid.shape
    dev = grid.device
    if (nby, nbx) != (h // cur, w // cur):
        raise ValueError(f"grid {nby}x{nbx} does not tile a {h}x{w} frame at cur={cur}")
    if ci not in (0, 1) or cj not in (0, 1):
        raise ValueError(f"colour must be (0|1, 0|1), got ({ci}, {cj})")
    _check_volume("cv", cv, b, 2 * r + 1, nby, nbx, dev)
    _check_centres("pm", pm, b, nby, nbx, dev)
    if (rcv is None) != (rpm is None):
        raise ValueError("rcv and rpm go together")
    if rcv is not None:
        _check_volume("rcv", rcv, b, 2 * r2 + 1, nby, nbx, dev)
        _check_centres("rpm", rpm, b, nby, nbx, dev)
        if rpm.shape != pm.shape:
            raise ValueError("rpm and pm must have the same shape")
    kw = dict(cur=cur, h=h, w=w, r=r, ci=ci, cj=cj, lam_mult=lam_mult,
              rcv=rcv, rpm=rpm, r2=r2)
    if dev.type == "cpu":
        color_step_plain(grid, cv, pm, **kw)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tensors = [grid, cv, pm] + ([rcv, rpm] if rcv is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("color_step needs contiguous tensors")
    f = nby // pm.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            grid.data_ptr(), cv.data_ptr(), int(cv.dtype == torch.uint16),
            rcv.data_ptr() if rcv is not None else None,
            int(rcv is not None and rcv.dtype == torch.uint16),
            pm.data_ptr(), rpm.data_ptr() if rpm is not None else None,
            _rank_table_on(dev).data_ptr(),
            b, nby, nbx, f, cur, h, w, r, r2, ci, cj, float(lam_mult), stream,
        )
    _build.check(code, "color_step")
    color_step.launches += 1


color_step.launches = 0
