"""Pooled cost volumes at every sub-block size (replaces ``delta_pooled_cvs``).

``pooled_cvs`` returns ``{cur: volume}`` for cur = 2, 4, ..., bs.  Each
volume is the reference's ``ops/windowed.py:_compute_cv`` layout with a
leading batch dim, (B, side^2, npy*f, npx*f) with f = bs // cur:
``cv[b, (dy+r)*side + (dx+r), py*f + sy, px*f + sx]`` is the cost of
sub-block (sy, sx) of parent (py, px) against the frame-2 window shifted by
(dy, dx).  Volumes are stored in the reference's ``_cv_dtype`` widths:
uint16 while the worst-case cost fits (sad at cur <= 16), int32 otherwise.

For CPU tensors the wrapper runs ``pooled_cvs_plain`` (the ``_compute_cv``
code in torch); for CUDA tensors it launches ``csrc/cv_diff.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build


def cv_dtype(cur: int, cost: str) -> torch.dtype:
    """Smallest dtype holding a worst-case cost at sub-block size cur."""
    peak = (255 * 255 if cost == "ssd" else 255) * cur * cur
    return torch.uint16 if peak < (1 << 16) else torch.int32


def _curs(bs: int) -> list[int]:
    return [1 << k for k in range(1, bs.bit_length())]


def _check_cost(cost: str) -> None:
    if cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cost!r}: only sad and ssd are ported (ROADMAP Queue 1 item 9)"
        )


def pooled_cvs_plain(
    im1: torch.Tensor,      # (B, H, W) u8 frame-1 level image
    windows: torch.Tensor,  # (B, nP, bs + 2r, bs + 2r) u8 frame-2 windows
    bs: int,
    r: int,
    cost: str,
) -> dict[int, torch.Tensor]:
    """All sizes' volumes with torch ops: one delta row per step, the row's
    deltas unfolded, pooled 2x2 from each size to the next."""
    _check_cost(cost)
    b, h, w = im1.shape
    npy, npx = h // bs, w // bs
    side = 2 * r + 1
    dev = im1.device
    patches = (
        im1.reshape(b, npy, bs, npx, bs).permute(0, 1, 3, 2, 4)
        .reshape(b, npy * npx, 1, bs, bs).to(torch.int32)
    )
    out = {
        c: torch.empty(
            (b, side * side, npy * (bs // c), npx * (bs // c)),
            dtype=cv_dtype(c, cost), device=dev,
        )
        for c in _curs(bs)
    }
    for dyi in range(side):
        rows = windows[:, :, dyi : dyi + bs]
        # (B, nP, bs, side, bs) -> (B, nP, side, bs, bs): window of delta dx
        shifted = rows.unfold(-1, bs, 1).permute(0, 1, 3, 2, 4).to(torch.int32)
        d = patches - shifted
        dmap = d.abs() if cost == "sad" else d * d
        cvr = dmap
        cur = 1
        while cur < bs:
            n = bs // cur
            cvr = cvr.reshape(b, npy * npx, side, n // 2, 2, n // 2, 2).sum(dim=(4, 6))
            cur *= 2
            f = bs // cur
            vol = (
                cvr.reshape(b, npy, npx, side, f, f)
                .permute(0, 3, 1, 4, 2, 5)
                .reshape(b, side, npy * f, npx * f)
            )
            out[cur][:, dyi * side : (dyi + 1) * side] = vol.to(out[cur].dtype)
    return out


# bbme_pooled_cvs(im1, windows, outs, ncur, is16_mask, batch, h, w, bs, side,
#                 ssd, stream)
ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.entry("bbme_pooled_cvs", ARGTYPES)


def pooled_cvs(
    im1: torch.Tensor,
    windows: torch.Tensor,
    bs: int,
    r: int,
    cost: str,
) -> dict[int, torch.Tensor]:
    """Volumes of every sub-block size; see ``pooled_cvs_plain`` for shapes.

    ``windows`` has edge ``bs + 2*r``; deltas span [-r, r] around the
    window centre.
    """
    _check_cost(cost)
    if im1.dtype != torch.uint8 or im1.dim() != 3:
        raise ValueError(f"im1 must be (B, H, W) uint8, got {im1.dtype} {tuple(im1.shape)}")
    b, h, w = im1.shape
    if r < 0:
        raise ValueError(f"need r >= 0, got {r}")
    win = bs + 2 * r
    n_p = (h // bs) * (w // bs)
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of bs={bs}")
    if windows.dtype != torch.uint8 or tuple(windows.shape) != (b, n_p, win, win):
        raise ValueError(
            f"windows must be ({b}, {n_p}, {win}, {win}) uint8, got "
            f"{windows.dtype} {tuple(windows.shape)}"
        )
    if windows.device != im1.device:
        raise ValueError(f"windows on {windows.device}, im1 on {im1.device}")
    if im1.device.type == "cpu":
        return pooled_cvs_plain(im1, windows, bs, r, cost)
    if im1.device.type != "cuda":
        raise ValueError(f"unsupported device {im1.device}")
    if not (im1.is_contiguous() and windows.is_contiguous()):
        raise ValueError("pooled_cvs needs contiguous tensors")
    side = 2 * r + 1
    curs = _curs(bs)
    out = {
        c: torch.empty(
            (b, side * side, h // c, w // c), dtype=cv_dtype(c, cost),
            device=im1.device,
        )
        for c in curs
    }
    ptrs = (ctypes.c_void_p * len(curs))(*(out[c].data_ptr() for c in curs))
    is16 = sum(1 << i for i, c in enumerate(curs) if out[c].dtype == torch.uint16)
    with torch.cuda.device(im1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            im1.data_ptr(), windows.data_ptr(), ptrs, len(curs), is16,
            b, h, w, bs, side, int(cost == "ssd"), stream,
        )
    _build.check(code, "pooled_cvs")
    pooled_cvs.launches += 1
    return out


pooled_cvs.launches = 0
