"""OpenCV-parity integer resampling (``blockbasedmotionestimation_tpu/ops/resample.py``).

The driver's integer-factor upscale and the Gaussian pyramid, on tensors
whose last two dims are (H, W).  Both run on the wrappers of
``kernels/resample.py`` (``cv::resize(INTER_LINEAR)`` 8u and ``cv::pyrDown``):
their plain versions for a CPU tensor, the CUDA kernels for a CUDA one.
"""

from __future__ import annotations

import torch

from blockbasedmotionestimation_tpu_torch.kernels.resample import (
    pyrdown_u8,
    resize_linear_u8,
)


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
