"""The spiral block search's argmin (replaces ``sad_spiral_argmin``, kernel 7).

``sad_spiral_argmin`` scores every bs x bs block of the level image ``im1``
against its (bs + 2S)^2 frame-2 window (kernel A's output) at every offset
of [-S, S]^2, masks offsets whose block leaves the frame, and returns the
winning offset per block: minimum cost, ties to the earliest visit of the
reference's spiral walk.  The batch dimension is written out.

For a CPU tensor the wrapper runs ``sad_spiral_argmin_plain``, the
reference's XLA formulation (a scan over the offsets in spiral order with a
strict-< update); for a CUDA tensor it launches ``csrc/sad_search.cu``
(a thread block a block, a thread a delta row and a run of 4 dx, four
pixels an instruction), which visits the offsets in no set order with
(cost, spiral rank) compares.  The two formulations check each other.

``im1`` may be a tile of its frame (the tiled engine): the centres are
then the frame's rows and columns, and ``full_h`` / ``full_w`` the frame's
height and width, which the in-frame test uses (default: im1's own).

The kernel computes sad and ssd.  ``cost="zsad"`` (f32 zero-mean SAD,
``block_cost``) has no kernel, here or in the reference, which runs it in
XLA: its callers run ``sad_spiral_argmin_plain`` on any device, and the
wrapper refuses it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_offsets, spiral_rank
from blockbasedmotionestimation_tpu_torch.utils import profiling

_I32_MAX = int(np.iinfo(np.int32).max)


def extract_blocks(image: torch.Tensor, bs: int) -> torch.Tensor:
    """(B, H, W) -> (B, nby*nbx, bs, bs) row-major block grid."""
    b, h, w = image.shape
    nby, nbx = h // bs, w // bs
    return (
        image.reshape(b, nby, bs, nbx, bs).permute(0, 1, 3, 2, 4).reshape(b, nby * nbx, bs, bs)
    )


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last dim (a power of two: a block's pixels) in a
    fixed order: halves added elementwise until one is left, so every
    device rounds the same way."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def zero_mean_sad(d: torch.Tensor) -> torch.Tensor:
    """f32 zero-mean SAD of integer diffs over the last dim: the mean as an
    f32 sum divided by the count, then sum |d - mean| (the reference's
    ``block_cost(cost="zsad")``).  Both sums are ``pairwise_sum``: the
    first is exact (integers below 2^24), the second while the block has
    at most 16 x 16 pixels (its terms are multiples of 1/count, its sum at
    most 255 * count); at 32 x 32 and above the reference's XLA order may
    round the last place differently."""
    df = d.to(torch.float32)
    n = profiling.upload(float(df.shape[-1]), df.device, "zsad", dtype=torch.float32)
    mean = pairwise_sum(df) / n
    return pairwise_sum((df - mean[..., None]).abs())


def block_cost(a: torch.Tensor, b: torch.Tensor, dims, cost: str) -> torch.Tensor:
    """Cost of a - b over ``dims``: int32 SAD (the reference's L1 norm) or
    SSD, or f32 zero-mean SAD (``zero_mean_sad``)."""
    d = a.to(torch.int32) - b.to(torch.int32)
    if cost == "sad":
        return d.abs().sum(dim=dims, dtype=torch.int32)
    if cost == "ssd":
        return (d * d).sum(dim=dims, dtype=torch.int32)
    if cost == "zsad":
        dims = [k % d.dim() for k in dims]
        keep = [k for k in range(d.dim()) if k not in dims]
        flat = d.permute(*keep, *sorted(dims)).reshape(*[d.shape[k] for k in keep], -1)
        return zero_mean_sad(flat)
    raise ValueError(f"unknown cost: {cost}")


def sad_spiral_argmin_plain(
    im1: torch.Tensor,      # (B, H, W) u8 level image
    windows: torch.Tensor,  # (B, nblk, win, win) u8, win = bs + 2S
    cy: torch.Tensor,       # (B, nblk) i32 window centre rows
    cx: torch.Tensor,       # (B, nblk) i32 window centre cols
    bs: int,
    ss: int,
    cost: str,
    full_h: int | None = None,
    full_w: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(best_dy, best_dx), each (B, nblk) int32 in window coordinates
    (0 .. 2S, centre S): the offsets in spiral order, strict < wins.  Costs
    are int32, f32 for zsad (the reference's ``cdt``), masked offsets
    I32_MAX in either.  An offset is masked where its block leaves the
    frame of ``full_h`` rows and ``full_w`` columns (default: im1's)."""
    _, h, w = im1.shape
    h = h if full_h is None else full_h
    w = w if full_w is None else full_w
    dys, dxs, ext = spiral_offsets(ss - bs)
    blocks = extract_blocks(im1, bs).to(torch.int32)
    wins = windows.to(torch.int32)
    cdt = torch.float32 if cost == "zsad" else torch.int32
    best = torch.full(cy.shape, _I32_MAX, dtype=cdt, device=im1.device)
    best_dy = torch.full(cy.shape, ext, dtype=torch.int32, device=im1.device)
    best_dx = torch.full_like(best_dy, ext)
    for dy, dx in zip((dys + ext).tolist(), (dxs + ext).tolist()):
        c = block_cost(blocks, wins[:, :, dy : dy + bs, dx : dx + bs], (2, 3), cost)
        ty = cy + (dy - ext)
        tx = cx + (dx - ext)
        ok = (ty >= 0) & (ty <= h - bs) & (tx >= 0) & (tx <= w - bs)
        c = torch.where(ok, c, _I32_MAX)
        better = c < best
        best = torch.where(better, c, best)
        best_dy = torch.where(better, dy, best_dy)
        best_dx = torch.where(better, dx, best_dx)
    return best_dy, best_dx


# bbme_sad_spiral_argmin(im1, windows, cy, cx, rank, out_dy, out_dx, nblk,
#                        n_per_frame, nbx, h, w, full_h, full_w, bs, ext, ssd,
#                        stream)
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

# the launch's shared memory (window + block) must fit a thread block
SMEM_LIMIT = 227 * 1024


def smem_bytes(bs: int, ext: int) -> int:
    """The fewest shared bytes a block of the kernel takes: the window's rows
    in whole words, then the block's at a 16-byte boundary (bs = 2: a word a
    row), and the 192 bytes of its reduction (``csrc/sad_search.cu``
    ``smem_of``; where a word more a row fits, the kernel takes it)."""
    win = bs + 2 * ext
    return -(-win * -(-win // 4) * 4 // 16) * 16 + bs * max(1, bs // 4) * 4 + 192


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.entry("bbme_sad_spiral_argmin", ARGTYPES)


def _rank_on(shift: int, device: torch.device) -> torch.Tensor:
    return profiling.table("tables", ("spiral_rank", shift),
                           lambda: spiral_rank(shift).reshape(-1), device).contiguous()


def sad_spiral_argmin(
    im1: torch.Tensor,
    windows: torch.Tensor,
    cy: torch.Tensor,
    cx: torch.Tensor,
    bs: int,
    ss: int,
    cost: str,
    full_h: int | None = None,
    full_w: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7; see ``sad_spiral_argmin_plain`` for shapes, ``full_h`` and
    ``full_w``.  Window k of frame b has its pixel (0, 0) at frame position
    (cy - S, cx - S)."""
    if cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cost!r}: kernel 7 computes sad and ssd; zsad runs "
            "sad_spiral_argmin_plain, as the reference runs it in XLA"
        )
    if im1.dtype != torch.uint8 or im1.dim() != 3:
        raise ValueError(f"im1 must be (B, H, W) uint8, got {im1.dtype} {tuple(im1.shape)}")
    b, h, w = im1.shape
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of bs={bs}")
    full_h = h if full_h is None else int(full_h)
    if full_h < h:
        raise ValueError(f"full_h={full_h} is less than the strip's {h} rows")
    full_w = w if full_w is None else int(full_w)
    if full_w < w:
        raise ValueError(f"full_w={full_w} is less than the tile's {w} columns")
    ext = spiral_offsets(ss - bs)[2]
    win = bs + 2 * ext
    nblk = (h // bs) * (w // bs)
    if windows.dtype != torch.uint8 or tuple(windows.shape) != (b, nblk, win, win):
        raise ValueError(
            f"windows must be ({b}, {nblk}, {win}, {win}) uint8, got "
            f"{windows.dtype} {tuple(windows.shape)}"
        )
    for name, t in (("windows", windows), ("cy", cy), ("cx", cx)):
        if t.device != im1.device:
            raise ValueError(f"{name} is on {t.device}, im1 on {im1.device}")
    for name, t in (("cy", cy), ("cx", cx)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b, nblk):
            raise ValueError(f"{name} must be ({b}, {nblk}) int32, got {t.dtype} {tuple(t.shape)}")
    if im1.device.type == "cpu":
        return sad_spiral_argmin_plain(im1, windows, cy, cx, bs, ss, cost, full_h, full_w)
    if im1.device.type != "cuda":
        raise ValueError(f"unsupported device {im1.device}")
    if smem_bytes(bs, ext) > SMEM_LIMIT:
        raise ValueError(f"window {win}^2 and block {bs}^2 take {smem_bytes(bs, ext)} bytes, "
                         f"over a thread block's shared memory")
    for t in (im1, windows, cy, cx):
        if not t.is_contiguous():
            raise ValueError("sad_spiral_argmin needs contiguous tensors")
    out_dy = torch.empty((b, nblk), dtype=torch.int32, device=im1.device)
    out_dx = torch.empty_like(out_dy)
    with torch.cuda.device(im1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            im1.data_ptr(), windows.data_ptr(), cy.data_ptr(), cx.data_ptr(),
            _rank_on(ss - bs, im1.device).data_ptr(), out_dy.data_ptr(), out_dx.data_ptr(),
            b * nblk, nblk, w // bs, h, w, full_h, full_w, bs, ext, int(cost == "ssd"), stream,
        )
    _build.check(code, "sad_spiral_argmin")
    sad_spiral_argmin.launches += 1
    return out_dy, out_dx


sad_spiral_argmin.launches = 0
