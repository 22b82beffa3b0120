"""OpenCV-exact 8-bit resampling (``blockbasedmotionestimation_tpu/ops/resample.py``).

The same fixed-point algorithms as the reference package, on tensors whose
last two dims are (H, W): ``cv::pyrDown`` (separable 1-4-6-4-1, reflect-101,
one ``(acc + 128) >> 8`` rounding) and ``cv::resize(INTER_LINEAR)`` 8u (x2048
coefficients, int32 horizontal pass, OpenCV's 8u vertical cast).

For a CPU tensor the wrappers run the plain versions (``*_plain``): index and
coefficient tables built with numpy and copied to the frames' device once a
shape and device (``utils.profiling.table``: the first copy a counted sync,
later calls reuse the device's tensor), the arithmetic int32 tensor ops on
the frames' device.  For a CUDA tensor they launch ``csrc/resample.cu``, a
launch a call, which reads u8 and writes u8 once and keeps every int32
intermediate in registers: the upscale reads the same row and column tables
as its plain version; pyrDown reflects at the borders by index arithmetic
and reads no table.  Each call counts its route in
``profiling.counters()["resample_by_route"]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.utils import profiling

_PYR_KERNEL = (1, 4, 6, 4, 1)


def _reflect101_indices(n: int, lo: int = 2, hi: int = 2) -> np.ndarray:
    """Indices implementing BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``),
    folded again until they lie in [0, n) (a 2-wide axis folds twice)."""
    period = max(2 * n - 2, 1)
    idx = np.arange(-lo, n + hi) % period
    idx = np.where(idx >= n, period - idx, idx)
    return idx.astype(np.int64)


def _check(image: torch.Tensor, what: str) -> None:
    if image.dtype != torch.uint8 or image.dim() < 2:
        raise ValueError(f"{what} takes (..., H, W) uint8, got {image.dtype} {tuple(image.shape)}")


def _check_pyrdown(image: torch.Tensor) -> None:
    _check(image, "pyrdown_u8")
    h, w = image.shape[-2:]
    if h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"pyrdown_u8 requires even dims, got {h}x{w}")


def pyrdown_u8_plain(image: torch.Tensor) -> torch.Tensor:
    """``cv::pyrDown`` on (..., H, W) uint8 with even H, W -> (..., H/2, W/2)."""
    _check_pyrdown(image)
    h, w = image.shape[-2:]
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
    """An axis's four tables (``_resize_tables_y`` or ``_x``) on ``device``:
    source rows or columns (int64) and their coefficients (int32)."""
    build = _resize_tables_y if axis == "y" else _resize_tables_x
    return tuple(profiling.table("resize", (axis, src_n, dst_n, i),
                                 lambda i=i: build(src_n, dst_n)[i], device) for i in range(4))


def _check_resize(image: torch.Tensor, dst_h: int, dst_w: int) -> None:
    _check(image, "resize_linear_u8")
    if min(image.shape[-2:]) < 1 or dst_h < 1 or dst_w < 1:
        raise ValueError(f"resize_linear_u8 takes non-empty sizes, got "
                         f"{tuple(image.shape[-2:])} -> {(dst_h, dst_w)}")


def resize_linear_u8_plain(image: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """``cv::resize(..., INTER_LINEAR)`` on (..., H, W) uint8."""
    _check_resize(image, dst_h, dst_w)
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


ARGTYPES = {
    # bbme_resize_linear(src, out, ys0, ys1, yb0, yb1, xs0, xs1, xa0, xa1,
    #                    n, src_h, src_w, dst_h, dst_w, stream)
    "bbme_resize_linear": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    # bbme_pyrdown(src, out, n, h, w, stream)
    "bbme_pyrdown": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    return _build.entry(name, ARGTYPES[name])


def _route(image: torch.Tensor, *frames: tuple[int, int]) -> str:
    """``plain`` for a CPU tensor, ``kernel`` for a CUDA one whose (H, W)
    ``frames`` fit the kernel's 32-bit indices (counted)."""
    if image.device.type == "cpu":
        route = "plain"
    elif image.device.type == "cuda":
        for h, w in frames:
            if h * w >= 2**31:
                raise ValueError(f"a {h}x{w} frame is too large for the kernel's 32-bit indices")
        route = "kernel"
    else:
        raise ValueError(f"unsupported device {image.device}")
    profiling.resample_route(route)
    return route


def pyrdown_u8(image: torch.Tensor) -> torch.Tensor:
    """``cv::pyrDown`` on (..., H, W) uint8 with even H, W -> (..., H/2, W/2)."""
    _check_pyrdown(image)
    if _route(image, image.shape[-2:]) == "plain":
        return pyrdown_u8_plain(image)
    h, w = image.shape[-2:]
    src = image.contiguous()
    out = torch.empty((*image.shape[:-2], h // 2, w // 2), dtype=torch.uint8, device=image.device)
    n = src.numel() // (h * w)
    if n == 0:
        return out
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel("bbme_pyrdown")(src.data_ptr(), out.data_ptr(), n, h, w, stream)
    _build.check(code, "pyrdown_u8")
    pyrdown_u8.launches += 1
    return out


pyrdown_u8.launches = 0


def resize_linear_u8(image: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """``cv::resize(..., INTER_LINEAR)`` on (..., H, W) uint8."""
    _check_resize(image, dst_h, dst_w)
    if _route(image, image.shape[-2:], (dst_h, dst_w)) == "plain":
        return resize_linear_u8_plain(image, dst_h, dst_w)
    src_h, src_w = image.shape[-2:]
    ys0, ys1, yb0, yb1 = _resize_tables_on("y", src_h, dst_h, image.device)
    xs0, xs1, xa0, xa1 = _resize_tables_on("x", src_w, dst_w, image.device)
    src = image.contiguous()
    out = torch.empty((*image.shape[:-2], dst_h, dst_w), dtype=torch.uint8, device=image.device)
    n = src.numel() // (src_h * src_w)
    if n == 0:
        return out
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel("bbme_resize_linear")(
            src.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in (ys0, ys1, yb0, yb1, xs0, xs1,
                                                                       xa0, xa1)),
            n, src_h, src_w, dst_h, dst_w, stream)
    _build.check(code, "resize_linear_u8")
    resize_linear_u8.launches += 1
    return out


resize_linear_u8.launches = 0
