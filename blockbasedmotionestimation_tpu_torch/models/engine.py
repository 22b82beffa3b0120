"""The coarse-to-fine engine (``blockbasedmotionestimation_tpu/models/engine.py``).

Per pyramid level, coarsest to finest: transfer the coarser level's MVs as
predictions (x2, one per fine block), then run the fused windowed level
(``ops.windowed.windowed_level``).  The result at each level is the stride-1
MV grid.  Every entry point takes uint8 frames as torch tensors (the device
is theirs) or numpy arrays with an explicit ``device=``; the batch dim is
written out where the reference vmapped.

Only the default schedule is ported: ``regularizer="windowed"`` with
prediction-centred windows, sad or ssd, with or without rival windows.
Other configurations raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
from blockbasedmotionestimation_tpu_torch.ops import resample
from blockbasedmotionestimation_tpu_torch.ops.windowed import subdivide, windowed_level

__all__ = [
    "check_config",
    "estimate_flow",
    "estimate_flow_batched",
    "estimate_flow_driver",
    "estimate_flow_driver_batched",
    "estimate_flow_padded",
    "subdivide",
    "transfer_mvs",
]


def check_config(cfg: MotionConfig) -> None:
    """Raise NotImplementedError for configurations outside the ported slice.

    ``cv_store_radius`` is accepted and has no effect (the dense volumes are
    bit-identical to the reference's slab recompute); ``search_impl`` is
    ignored (the device decides).
    """
    if cfg.regularizer != "windowed":
        raise NotImplementedError(
            f"regularizer={cfg.regularizer!r} is not ported yet "
            "(ROADMAP Queue 1 item 7: the other schedules)"
        )
    if not cfg.uses_fused_windowed:
        raise NotImplementedError(
            "window_center='search', search_order='raster' and reg_radius are "
            "not ported yet (ROADMAP Queue 1 item 8: windowed_schedule)"
        )
    if cfg.cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cfg.cost!r} is not ported yet (ROADMAP Queue 1 item 9)"
        )
    if cfg.cv_fused is not None or cfg.cv_compact is not None:
        raise NotImplementedError(
            "cv_fused and cv_compact are not ported yet "
            "(ROADMAP Queue 1 item 10: capacity modes)"
        )


def _as_frames(x, device, ndim: int) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device) != x.device:
            raise ValueError(f"frames are on {x.device}, device={device} was asked")
        t = x
    else:
        if device is None:
            raise ValueError("numpy frames need an explicit device=")
        t = torch.as_tensor(np.asarray(x), device=device)
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"expected {ndim}-d uint8 frames, got {t.dtype} {tuple(t.shape)}")
    return t


def transfer_mvs(dense_coarse: torch.Tensor, coarse_bs: int, fine_bs: int) -> torch.Tensor:
    """Cross-level MV prediction (``copyMVs``): (B, Hc, Wc, 2) f32 stride-1
    coarse grid -> (B, 2*Hc//fine_bs, 2*Wc//fine_bs, 2) f32 predictions."""
    hc, wc = dense_coarse.shape[1:3]
    sampled = dense_coarse[:, ::coarse_bs, ::coarse_bs] * 2.0
    dev = dense_coarse.device
    iy = torch.as_tensor((np.arange(2 * hc // fine_bs) * fine_bs) // (2 * coarse_bs), device=dev)
    jx = torch.as_tensor((np.arange(2 * wc // fine_bs) * fine_bs) // (2 * coarse_bs), device=dev)
    return sampled[:, iy][:, :, jx]


def estimate_flow_padded(im1p: torch.Tensor, im2p: torch.Tensor, cfg: MotionConfig) -> torch.Tensor:
    """Dense (B, H, W, 2) f32 flow of pre-padded (B, H, W) u8 frames."""
    check_config(cfg)
    levels = cfg.num_levels
    pyr1 = resample.build_pyramid(im1p, levels)
    pyr2 = resample.build_pyramid(im2p, levels)
    dense = None
    for level in range(levels - 1, -1, -1):
        im1, im2 = pyr1[level], pyr2[level]
        b, h, w = im1.shape
        bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
        if dense is None:
            pred = torch.zeros((b, h // bs, w // bs, 2), dtype=torch.float32, device=im1.device)
        else:
            pred = transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
            if cfg.mv_cap is not None:
                pred = pred.clamp(-float(cfg.mv_cap), float(cfg.mv_cap))
        grid = windowed_level(
            im1, im2, pred, bs, ss, float(bs) * cfg.lambda_scale,
            cfg.sweeps_per_round, cost=cfg.cost, rival=cfg.rival_window,
            rival_radius=cfg.rival_radius_at(level),
        )
        dense = grid.to(torch.float32)
    return dense


def estimate_flow_batched(
    im1s, im2s, cfg: MotionConfig, device=None
) -> tuple[torch.Tensor, pad_ops.Padding]:
    """Batched pipeline over (B, H, W) pairs: (B-padded flow, padding)."""
    a = _as_frames(im1s, device, 3)
    b = _as_frames(im2s, a.device, 3)
    p = pad_ops.compute_padding(a.shape[1], a.shape[2], cfg)
    return estimate_flow_padded(pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p), cfg), p


def estimate_flow(im1, im2, cfg: MotionConfig, device=None) -> tuple[torch.Tensor, pad_ops.Padding]:
    """Pad + engine on one (H, W) pair as given (no interp): (padded flow, padding)."""
    a = _as_frames(im1, device, 2)
    b = _as_frames(im2, a.device, 2)
    flow, p = estimate_flow_batched(a[None], b[None], cfg)
    return flow[0], p


def estimate_flow_driver_batched(im1s, im2s, cfg: MotionConfig, device=None) -> torch.Tensor:
    """The reference driver on (B, H, W) pairs: upsample by interp_factor,
    pad, run, subsample by the factor and divide the MVs by it.  Returns
    (B, H, W, 2) f32 flow at the original resolution."""
    a = _as_frames(im1s, device, 3)
    b = _as_frames(im2s, a.device, 3)
    f = cfg.interp_factor
    if f > 1:
        a = resample.resize_scale_u8(a, f)
        b = resample.resize_scale_u8(b, f)
    flow, p = estimate_flow_batched(a, b, cfg)
    sub = flow[:, p.pad_y : p.padded_h - p.pad_y : f, p.pad_x : p.padded_w - p.pad_x : f]
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently for odd f
    return sub / torch.full_like(sub, float(f))


def estimate_flow_driver(im1, im2, cfg: MotionConfig, device=None) -> torch.Tensor:
    """The reference driver on one (H, W) pair -> (H, W, 2) f32 flow."""
    a = _as_frames(im1, device, 2)
    b = _as_frames(im2, a.device, 2)
    return estimate_flow_driver_batched(a[None], b[None], cfg)[0]
