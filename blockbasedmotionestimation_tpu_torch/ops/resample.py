"""OpenCV-parity integer resampling (``blockbasedmotionestimation_tpu/ops/resample.py``).

Same fixed-point algorithms as the reference package, on tensors whose last
two dims are (H, W): ``cv::pyrDown`` (separable 1-4-6-4-1, reflect-101, one
``(acc + 128) >> 8`` rounding) and ``cv::resize(INTER_LINEAR)`` 8u (x2048
coefficients, int32 horizontal pass, OpenCV's 8u vertical cast).  Index and
coefficient tables are built with numpy and copied to the frames' device
once a shape and device (``utils.profiling.table``: the first copy a
counted sync, later calls reuse the device's tensor); the arithmetic is
int32 on the frames' device.
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.utils import profiling

_PYR_KERNEL = (1, 4, 6, 4, 1)


def _reflect101_indices(n: int, lo: int = 2, hi: int = 2) -> np.ndarray:
    """Indices implementing BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``)."""
    idx = np.abs(np.arange(-lo, n + hi))
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx.astype(np.int64)


def pyrdown_u8(image: torch.Tensor) -> torch.Tensor:
    """``cv::pyrDown`` on (..., H, W) uint8 with even H, W -> (..., H/2, W/2)."""
    h, w = image.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"pyrdown_u8 requires even dims, got {h}x{w}")
    ridx, cidx = (profiling.table("pyramid", (n, 2, 2), lambda n=n: _reflect101_indices(n),
                                  image.device) for n in (h, w))
    x = image.index_select(-2, ridx).index_select(-1, cidx).to(torch.int32)
    acc_v = sum(k * x[..., t : t + h : 2, :] for t, k in enumerate(_PYR_KERNEL))
    acc = sum(k * acc_v[..., t : t + w : 2] for t, k in enumerate(_PYR_KERNEL))
    return ((acc + 128) >> 8).to(torch.uint8)


def _coords(src_n: int, dst_n: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV half-pixel-center source mapping: float32 ``(d+0.5)*scale-0.5``."""
    scale = src_n / dst_n
    d = np.arange(dst_n, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s


def _fixed_coefs(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``saturate_cast<short>(f * 2048)``, round-half-to-even (cvRound)."""
    a1 = np.rint(frac * 2048.0).astype(np.int32)
    a0 = np.rint((1.0 - frac) * 2048.0).astype(np.int32)
    return a0, a1


def _resize_tables_x(src_n: int, dst_n: int):
    """Horizontal taps: OpenCV zeroes the fraction at the edges, so edge
    columns become one full-weight tap."""
    s0, fx = _coords(src_n, dst_n)
    fx = np.where(s0 < 0, np.float32(0.0), fx)
    s0 = np.maximum(s0, 0)
    fx = np.where(s0 >= src_n - 1, np.float32(0.0), fx)
    s0 = np.minimum(s0, src_n - 1)
    s1 = np.minimum(s0 + 1, src_n - 1)
    a0, a1 = _fixed_coefs(fx)
    return s0, s1, a0, a1


def _resize_tables_y(src_n: int, dst_n: int):
    """Vertical taps: the fraction stays unclamped and only the two row
    indices are replicate-clamped (two separate ``>>16`` truncations)."""
    s, fy = _coords(src_n, dst_n)
    s0 = np.clip(s, 0, src_n - 1)
    s1 = np.clip(s + 1, 0, src_n - 1)
    b0, b1 = _fixed_coefs(fy)
    return s0, s1, b0, b1


def _resize_tables_on(axis: str, src_n: int, dst_n: int, device) -> tuple[torch.Tensor, ...]:
    """An axis's four tables (``_resize_tables_y`` or ``_x``) on ``device``."""
    build = _resize_tables_y if axis == "y" else _resize_tables_x
    return tuple(profiling.table("resize", (axis, src_n, dst_n, i),
                                 lambda i=i: build(src_n, dst_n)[i], device) for i in range(4))


def resize_linear_u8(image: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """``cv::resize(..., INTER_LINEAR)`` on (..., H, W) uint8."""
    src_h, src_w = image.shape[-2:]
    ys0, ys1, yb0, yb1 = _resize_tables_on("y", src_h, dst_h, image.device)
    xs0, xs1, xa0, xa1 = _resize_tables_on("x", src_w, dst_w, image.device)
    x = image.to(torch.int32)
    row = x.index_select(-1, xs0) * xa0 + x.index_select(-1, xs1) * xa1
    s0 = row.index_select(-2, ys0)
    s1 = row.index_select(-2, ys1)
    b0 = yb0[:, None]
    b1 = yb1[:, None]
    # OpenCV VResizeLinear<uchar>:
    #   uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def resize_scale_u8(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor upscale, the driver's ``cv::resize(src, dst, Size(), f, f)``."""
    h, w = image.shape[-2:]
    return resize_linear_u8(image, h * factor, w * factor)


def build_pyramid(image: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """Gaussian half-resolution pyramid, level 0 = full resolution."""
    levels = [image]
    for _ in range(1, num_levels):
        levels.append(pyrdown_u8(levels[-1]))
    return levels
