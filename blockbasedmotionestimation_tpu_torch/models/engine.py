"""The coarse-to-fine engine (``blockbasedmotionestimation_tpu/models/engine.py``).

Per pyramid level, coarsest to finest: transfer the coarser level's MVs as
predictions (x2, one per fine block), then run the level (``_run_level``,
the reference's dispatch):

  * the default, ``regularizer="windowed"`` with prediction-centred windows,
    spiral search and no ``reg_radius``: the fused windowed level
    (``ops.windowed.windowed_level``), one set of cost volumes for the
    search and every round;
  * every other configuration: the block search (``ops.search``, spiral
    with kernel 7 or raster), then the regularization schedule:
    ``windowed`` (``ops.windowed.windowed_schedule``, windows around the
    search winners) or ``exact``/``fourcolor``/``jacobi``
    (``ops.regularize.run_schedule``).

The result at each level is the stride-1 MV grid.  Every entry point takes
uint8 frames as torch tensors (the device is theirs) or numpy arrays, which
go to ``device=`` (CUDA when it is not given; ``device="cpu"`` runs the
plain versions); the batch dim is written out where the reference vmapped.

``search_impl`` picks the reference's path.  ``"auto"``, ``"pallas"`` and
``"pallas_interpret"`` run what the reference runs on its accelerator: the
capacity modes ``cv_fused`` and ``cv_compact`` (with ``cv_compact_ring``)
shape the fused windowed level (``ops.windowed.windowed_level``); the other
paths ignore them, as the reference's do.  ``"xla"`` runs the level as the
reference's XLA path does, which ignores both: no compact tables and no
fused volumes.  That matters for ``cv_compact`` alone, whose flow differs
from the dense one where a chunk of 128 parents has more than
``cv_compact`` distinct deltas (``ops.compact.overflow_fraction``) or a
value travels further than ``cv_compact_ring`` parents in the rounds (the
slot lists hold only the winners that close); every other form (fused,
hybrid, the stored band) gives the dense bits.  The device, not
``search_impl``, decides between the kernels (CUDA) and their plain
versions (CPU).

``cost="zsad"`` (f32 zero-mean SAD) runs as the reference's XLA path runs
it, whatever ``search_impl`` and the capacity options say: the dense-rival
form of the fused level, the search, ``windowed_schedule`` and
exact/fourcolor/jacobi, all on the plain versions (f32 volumes and costs)
on every device; no kernel computes zsad, so on the card only the window
gathers (A) launch one.  The route follows from ``cfg.cost`` before any
work.  On a CUDA device, a level whose shapes no kernel can take
(``cuda_refusals``) raises ``ValueError`` before any work.

Every public entry point counts its outermost call, its fields and its
host time (``utils.profiling.entry``); each copy of a host table to the
device is a counted sync (``utils.profiling.upload``).  The entry's
stages run in the program's spans, ``mf.driver`` around ``mf.upscale``,
``mf.pad``, ``mf.pyramid``, one ``mf.level`` a level and ``mf.subsample``,
which cost a flag test unless ``utils.profiling.spans`` or ``trace``
turns them on.
"""

from __future__ import annotations

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.config import MotionConfig
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, sad_search
from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
from blockbasedmotionestimation_tpu_torch.ops import resample
from blockbasedmotionestimation_tpu_torch.ops.regularize import run_schedule, subdivide
from blockbasedmotionestimation_tpu_torch.ops.search import block_search_level
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent
from blockbasedmotionestimation_tpu_torch.ops.windowed import windowed_level, windowed_schedule
from blockbasedmotionestimation_tpu_torch.utils import profiling

__all__ = [
    "check_config",
    "cuda_refusals",
    "estimate_flow",
    "estimate_flow_batched",
    "estimate_flow_driver",
    "estimate_flow_driver_batched",
    "estimate_flow_padded",
    "subdivide",
    "transfer_mvs",
]


def _accelerated(cfg: MotionConfig) -> bool:
    """Whether the capacity modes apply (the reference's accelerator path)."""
    return cfg.search_impl != "xla"


def cuda_refusals(cfg: MotionConfig) -> list[str]:
    """The levels of ``cfg`` that no CUDA kernel of the port can take, each
    named with its (bs, search size) and the kernel's limit; empty when the
    whole configuration runs on the card.

    The limits are shared memory a thread block may use (232 448 bytes on
    the H100): kernel 7 holds a whole (bs + 2S)^2 window and its block; the
    volume kernel (B, C, 13; built for bs 2 .. 128) at least one delta row
    of one parent's window; kernel 14 the parent's window and its pooled
    sums.  The plain versions (CPU tensors) have no such limit, nor a zsad
    configuration, whose levels run the plain versions on the card too.
    """
    if cfg.cost == "zsad":
        return []
    out = []
    for level, (bs, ss) in enumerate(zip(cfg.block_sizes, cfg.search_sizes)):
        ext = spiral_extent(ss - bs)
        where = f"level {level} (bs={bs}, search={ss}, S={ext})"
        vol_r = None
        if cfg.uses_fused_windowed:
            vol_r = ext
            compact = (_accelerated(cfg) and cfg.cv_compact is not None
                       and not cfg.rival_window and bs >= 8)
            if compact and cv_diff.compact_smem(bs, ext) > cv_diff.SMEM_LIMIT:
                out.append(f"{where}: kernel 14 needs {cv_diff.compact_smem(bs, ext)} bytes of "
                           f"shared memory, over {cv_diff.SMEM_LIMIT}")
        else:
            if cfg.search_order == "spiral":
                need = sad_search.smem_bytes(bs, ext)
                if need > sad_search.SMEM_LIMIT:
                    out.append(f"{where}: kernel 7's window ({bs + 2 * ext}^2) and block need "
                               f"{need} bytes of shared memory, over {sad_search.SMEM_LIMIT}")
            if cfg.regularizer == "windowed":
                vol_r = ext if cfg.reg_radius is None else min(cfg.reg_radius, ext)
        if vol_r is None:
            continue
        if bs > cv_diff.MAX_BS:
            out.append(f"{where}: the volume kernel is built for bs 2 .. {cv_diff.MAX_BS}")
        elif cv_diff.volume_smem(bs, vol_r, 1, 1) > cv_diff.SMEM_LIMIT:
            out.append(f"{where}: the volume kernel needs {cv_diff.volume_smem(bs, vol_r, 1, 1)} "
                       f"bytes of shared memory at one parent and one delta row (r={vol_r}), "
                       f"over {cv_diff.SMEM_LIMIT}")
    return out


def check_config(cfg: MotionConfig, device=None) -> None:
    """Raise ValueError for an unknown cost, and on a CUDA ``device`` for
    levels no kernel can take (``cuda_refusals``), before any work.
    ``search_impl="xla"`` turns the capacity modes off, as in the
    reference; the device decides between kernels and plain versions."""
    if cfg.cost not in ("sad", "ssd", "zsad"):
        raise ValueError(f"unknown cost: {cfg.cost}")
    if device is not None and torch.device(device).type == "cuda":
        refused = cuda_refusals(cfg)
        if refused:
            raise ValueError("no CUDA kernel of the port takes " + "; ".join(refused))


def _as_frames(x, device, ndim: int) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        if device is not None and torch.device(device) != x.device:
            raise ValueError(f"frames are on {x.device}, device={device} was asked")
        t = x
    else:
        # numpy frames run on the card unless the caller asks for another
        # device; without CUDA this raises, as device="cuda" does
        t = profiling.upload(np.asarray(x), "cuda" if device is None else device, "frames")
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"expected {ndim}-d uint8 frames, got {t.dtype} {tuple(t.shape)}")
    return t


def transfer_mvs(dense_coarse: torch.Tensor, coarse_bs: int, fine_bs: int) -> torch.Tensor:
    """Cross-level MV prediction (``copyMVs``): (B, Hc, Wc, 2) f32 stride-1
    coarse grid -> (B, 2*Hc//fine_bs, 2*Wc//fine_bs, 2) f32 predictions."""
    hc, wc = dense_coarse.shape[1:3]
    with profiling.span("transfer"):
        sampled = dense_coarse[:, ::coarse_bs, ::coarse_bs] * 2.0
        dev = dense_coarse.device
        iy = profiling.upload((np.arange(2 * hc // fine_bs) * fine_bs) // (2 * coarse_bs), dev,
                              "transfer")
        jx = profiling.upload((np.arange(2 * wc // fine_bs) * fine_bs) // (2 * coarse_bs), dev,
                              "transfer")
        return sampled[:, iy][:, :, jx]


def _run_level(
    im1: torch.Tensor,
    im2: torch.Tensor,
    pred: torch.Tensor,
    bs: int,
    ss: int,
    cfg: MotionConfig,
    level: int,
) -> torch.Tensor:
    """Search and regularization of one level: the (B, h, w, 2) int32
    stride-1 grid."""
    lam0 = float(bs) * cfg.lambda_scale
    rr = cfg.rival_radius_at(level)
    if cfg.uses_fused_windowed:
        accel = _accelerated(cfg)
        return windowed_level(
            im1, im2, pred, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            rival=cfg.rival_window, rival_radius=rr, store_radius=cfg.cv_store_radius,
            fuse=cfg.cv_fused if accel else None, compact=cfg.cv_compact if accel else None,
            compact_ring=cfg.cv_compact_ring,
        )
    grid = block_search_level(im1, im2, pred, bs, ss, order=cfg.search_order, cost=cfg.cost)
    if cfg.regularizer == "windowed":
        return windowed_schedule(
            im1, im2, grid, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            reg_radius=cfg.reg_radius, rival=cfg.rival_window, rival_radius=rr,
        )
    return run_schedule(
        im1, im2, grid, bs, lam0, cfg.sweeps_per_round, cfg.regularizer, cost=cfg.cost
    )


@profiling.entry
def estimate_flow_padded(im1p: torch.Tensor, im2p: torch.Tensor, cfg: MotionConfig) -> torch.Tensor:
    """Dense (B, H, W, 2) f32 flow of pre-padded (B, H, W) u8 frames."""
    check_config(cfg, im1p.device)
    levels = cfg.num_levels
    with profiling.span("pyramid"):
        pyr1 = resample.build_pyramid(im1p, levels)
        pyr2 = resample.build_pyramid(im2p, levels)
    dense = None
    for level in range(levels - 1, -1, -1):
        with profiling.span("level", level=level):
            im1, im2 = pyr1[level], pyr2[level]
            b, h, w = im1.shape
            bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
            if dense is None:
                pred = torch.zeros((b, h // bs, w // bs, 2), dtype=torch.float32,
                                   device=im1.device)
            else:
                pred = transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
                if cfg.mv_cap is not None:
                    pred = pred.clamp(-float(cfg.mv_cap), float(cfg.mv_cap))
            dense = _run_level(im1, im2, pred, bs, ss, cfg, level).to(torch.float32)
    return dense


@profiling.entry
def estimate_flow_batched(
    im1s, im2s, cfg: MotionConfig, device=None
) -> tuple[torch.Tensor, pad_ops.Padding]:
    """Batched pipeline over (B, H, W) pairs: (B-padded flow, padding)."""
    a = _as_frames(im1s, device, 3)
    b = _as_frames(im2s, a.device, 3)
    with profiling.span("pad"):
        p = pad_ops.compute_padding(a.shape[1], a.shape[2], cfg)
        a, b = pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p)
    return estimate_flow_padded(a, b, cfg), p


@profiling.entry
def estimate_flow(im1, im2, cfg: MotionConfig, device=None) -> tuple[torch.Tensor, pad_ops.Padding]:
    """Pad + engine on one (H, W) pair as given (no interp): (padded flow, padding)."""
    a = _as_frames(im1, device, 2)
    b = _as_frames(im2, a.device, 2)
    flow, p = estimate_flow_batched(a[None], b[None], cfg)
    return flow[0], p


@profiling.entry
def estimate_flow_driver_batched(im1s, im2s, cfg: MotionConfig, device=None) -> torch.Tensor:
    """The reference driver on (B, H, W) pairs: upsample by interp_factor,
    pad, run, subsample by the factor and divide the MVs by it.  Returns
    (B, H, W, 2) f32 flow at the original resolution."""
    a = _as_frames(im1s, device, 3)
    b = _as_frames(im2s, a.device, 3)
    f = cfg.interp_factor
    if f > 1:
        with profiling.span("upscale"):
            a = resample.resize_scale_u8(a, f)
            b = resample.resize_scale_u8(b, f)
    flow, p = estimate_flow_batched(a, b, cfg)
    with profiling.span("subsample"):
        sub = flow[:, p.pad_y : p.padded_h - p.pad_y : f, p.pad_x : p.padded_w - p.pad_x : f]
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # multiply by its reciprocal, which rounds differently for odd f
        return sub / torch.full_like(sub, float(f))


@profiling.entry
def estimate_flow_driver(im1, im2, cfg: MotionConfig, device=None) -> torch.Tensor:
    """The reference driver on one (H, W) pair -> (H, W, 2) f32 flow."""
    a = _as_frames(im1, device, 2)
    b = _as_frames(im2, a.device, 2)
    return estimate_flow_driver_batched(a[None], b[None], cfg)[0]
