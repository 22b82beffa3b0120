"""Per-parent frame-2 window gather (replaces the TPU ``gather_windows_dma``).

``gather_windows`` returns, for every parent block, the (win, win) window
``im2p[b, by:by+win, bx:bx+win]`` of its own batch entry's frame zero-padded
by ``ext``, with ``win = bs + 2*ext``.  The batch dimension is written out:
this replaces both ``ops/search.py:_gather_windows`` and its vmap rule, which
stacked the padded frames vertically.

For a CPU tensor the wrapper runs ``gather_windows_plain``; for a CUDA tensor
it launches ``csrc/gather.cu``: a block a window, each thread 16, 8 or 4
bytes of a window row as ``win`` allows (byte stores where ``win % 4 != 0``),
assembled from the aligned frame words that cover them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from blockbasedmotionestimation_tpu_torch.kernels import _build


def gather_windows_plain(
    im2: torch.Tensor, by: torch.Tensor, bx: torch.Tensor, bs: int, ext: int
) -> torch.Tensor:
    """(B, H, W) u8 frames, (B, nP) i32 offsets -> (B, nP, win, win) u8."""
    win = bs + 2 * ext
    im2p = F.pad(im2, (ext, ext, ext, ext), value=0)
    ar = torch.arange(win, device=im2.device)
    rows = by.long()[..., :, None] + ar  # (B, nP, win)
    cols = bx.long()[..., :, None] + ar
    bidx = torch.arange(im2.shape[0], device=im2.device)[:, None, None, None]
    return im2p[bidx, rows[..., :, None], cols[..., None, :]]


# bbme_gather_windows(im2, by, bx, out, nblk, n_per_frame, h, w, win, ext, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.entry("bbme_gather_windows", ARGTYPES)


def gather_windows(
    im2: torch.Tensor, by: torch.Tensor, bx: torch.Tensor, bs: int, ext: int
) -> torch.Tensor:
    """Windows of every parent; see ``gather_windows_plain`` for the shapes.

    ``by``/``bx`` are window top-left corners in the ext-padded frame,
    already clipped by the caller to [0, H - bs] / [0, W - bs].
    """
    if im2.dtype != torch.uint8 or im2.dim() != 3:
        raise ValueError(f"im2 must be (B, H, W) uint8, got {im2.dtype} {tuple(im2.shape)}")
    b, h, w = im2.shape
    for name, t in (("by", by), ("bx", bx)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"{name} must be (B, nP) int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != im2.device:
            raise ValueError(f"{name} is on {t.device}, im2 on {im2.device}")
    if by.shape != bx.shape:
        raise ValueError("by and bx must have the same shape")
    if im2.device.type == "cpu":
        return gather_windows_plain(im2, by, bx, bs, ext)
    if im2.device.type != "cuda":
        raise ValueError(f"unsupported device {im2.device}")
    for t in (im2, by, bx):
        if not t.is_contiguous():
            raise ValueError("gather_windows needs contiguous tensors")
    if h * w >= 2**31:
        raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")
    n_p = by.shape[1]
    win = bs + 2 * ext
    out = torch.empty((b, n_p, win, win), dtype=torch.uint8, device=im2.device)
    with torch.cuda.device(im2.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            im2.data_ptr(), by.data_ptr(), bx.data_ptr(), out.data_ptr(),
            b * n_p, n_p, h, w, win, ext, stream,
        )
    _build.check(code, "gather_windows")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0
