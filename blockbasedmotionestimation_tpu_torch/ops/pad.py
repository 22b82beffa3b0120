"""Block-divisibility padding (``blockbasedmotionestimation_tpu/ops/pad.py``).

The padded size is found in plain Python exactly as the reference package
does; only the zero pad itself touches a tensor.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from blockbasedmotionestimation_tpu_torch.config import MotionConfig


@dataclasses.dataclass(frozen=True)
class Padding:
    orig_h: int
    orig_w: int
    padded_h: int
    padded_w: int
    pad_y: int
    pad_x: int


@functools.lru_cache(maxsize=None)
def _find_padded_dims(
    orig_h: int, orig_w: int, block_sizes: tuple[int, ...], row_tiles: int = 1
) -> tuple[int, int]:
    """Smallest (H', W') with H' % (2^i * bs_i) == 0 for every level i;
    with row_tiles > 1 the finest level's rows also split into row_tiles
    block-aligned strips."""
    row_mult = row_tiles * block_sizes[0] if row_tiles > 1 else 1
    temp_h, temp_w = orig_h, orig_w
    while True:
        if temp_h >= 2 * orig_h + row_mult or temp_w == 2 * orig_w:
            raise ValueError(
                "Could not find any multiples of the block size that match "
                "padded image dimensions (motion_framework.cpp:21-26)"
            )
        rem_h = sum(temp_h % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        rem_h += temp_h % row_mult
        rem_w = sum(temp_w % ((1 << i) * bs) for i, bs in enumerate(block_sizes))
        if rem_h == 0 and rem_w == 0:
            return temp_h, temp_w
        if rem_h:
            temp_h += 1
        if rem_w:
            temp_w += 1


def compute_padding(
    orig_h: int, orig_w: int, cfg: MotionConfig, row_tiles: int = 1
) -> Padding:
    """Static padding metadata for a frame of (orig_h, orig_w); row_tiles:
    the row-tiling mesh axis's size, so the padded height also splits into
    that many block-aligned strips (``parallel.tiled``)."""
    padded_h, padded_w = _find_padded_dims(orig_h, orig_w, cfg.block_sizes, row_tiles)
    if (padded_h - orig_h) % 2 or (padded_w - orig_w) % 2:
        raise ValueError(
            f"padding difference must be even, got {padded_h - orig_h}x"
            f"{padded_w - orig_w} for {orig_h}x{orig_w} under {cfg.block_sizes}"
        )
    return Padding(
        orig_h=orig_h,
        orig_w=orig_w,
        padded_h=padded_h,
        padded_w=padded_w,
        pad_y=(padded_h - orig_h) // 2,
        pad_x=(padded_w - orig_w) // 2,
    )


def pad_frame(image: torch.Tensor, p: Padding) -> torch.Tensor:
    """Zero-pad the last two dims (BORDER_CONSTANT 0)."""
    return F.pad(image, (p.pad_x, p.pad_x, p.pad_y, p.pad_y), value=0)
