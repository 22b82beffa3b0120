"""Debug and diagnostic visualizations (reference ``motion_framework.cpp:864-905``).

The reference ships three commented-out diagnostics; all are first-class here:

  * ``dump_flow_text``   <- ``print_debug`` (``:864-874``): every pixel's
    "(u, v)" to a text file for diff-based verification.
  * ``draw_mv_overlay``  <- ``draw_MVs`` (``:876-885``): per-block motion
    vectors drawn as line segments over the frame.
  * ``motion_compensate``<- ``draw_MVimage`` (``:887-905``): reconstruct
    frame 1 by pasting each block's matched frame-2 block - the classic
    eyeball check that MVs point at the right content.
"""

from __future__ import annotations

import os

import numpy as np


def dump_flow_text(flow: np.ndarray, path: str | os.PathLike) -> None:
    """Write every pixel's ``(u, v) `` row-major, rows newline-separated."""
    flow = np.asarray(flow)
    with open(path, "w") as f:
        for row in flow:
            f.write(" ".join(f"({u:g}, {v:g})" for u, v in row))
            f.write("\n")


def _draw_line(img: np.ndarray, y0: int, x0: int, y1: int, x1: int, color) -> None:
    """Bresenham segment, clipped to the image."""
    h, w = img.shape[:2]
    dy, dx = abs(y1 - y0), abs(x1 - x0)
    sy = 1 if y0 < y1 else -1
    sx = 1 if x0 < x1 else -1
    err = dx - dy
    y, x = y0, x0
    while True:
        if 0 <= y < h and 0 <= x < w:
            img[y, x] = color
        if y == y1 and x == x1:
            break
        e2 = 2 * err
        if e2 > -dy:
            err -= dy
            x += sx
        if e2 < dx:
            err += dx
            y += sy


def draw_mv_overlay(
    image: np.ndarray,
    flow: np.ndarray,
    block_size: int = 16,
    color=(255, 0, 0),
    mark_origin: bool = True,
) -> np.ndarray:
    """Overlay block MVs as segments origin -> origin + (u, v) (``:876-885``)."""
    h, w = image.shape[:2]
    out = np.stack([image] * 3, axis=-1).astype(np.uint8) if image.ndim == 2 else image.copy()
    for i in range(0, h, block_size):
        for j in range(0, w, block_size):
            u, v = flow[i, j]
            _draw_line(out, i, j, int(round(i + v)), int(round(j + u)), color)
            if mark_origin and 0 <= i < h and 0 <= j < w:
                out[i, j] = (0, 255, 0)
    return out


def motion_compensate(
    im2: np.ndarray, flow: np.ndarray, block_size: int = 2
) -> np.ndarray:
    """Reconstruct frame 1 from frame 2 blocks via the MV field (``:887-905``).

    For each block origin p with MV c, paste ``im2[p+c]``'s block at p;
    out-of-bounds targets fall back to the co-located block.
    """
    h, w = im2.shape
    out = np.zeros_like(im2)
    for i in range(0, h, block_size):
        for j in range(0, w, block_size):
            u = int(flow[i, j, 0])
            v = int(flow[i, j, 1])
            y, x = i + v, j + u
            if not (0 <= y <= h - block_size and 0 <= x <= w - block_size):
                y, x = i, j
            out[i : i + block_size, j : j + block_size] = im2[
                y : y + block_size, x : x + block_size
            ]
    return out


def compensation_error(im1: np.ndarray, im2: np.ndarray, flow: np.ndarray,
                       block_size: int = 2) -> float:
    """Mean |im1 - motion_compensate(im2, flow)| - a no-GT quality signal."""
    rec = motion_compensate(im2, flow, block_size)
    return float(np.abs(im1.astype(np.int32) - rec.astype(np.int32)).mean())
