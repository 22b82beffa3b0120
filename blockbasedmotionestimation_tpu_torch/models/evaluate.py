"""Middlebury evaluation runner (``blockbasedmotionestimation_tpu/models/evaluate.py``).

Input frames are not bundled with the reference, so two modes exist:
  * frames mode: read ``frame10/frame11`` grayscale pairs from a data dir
    laid out like ``middlebury/data-gray/<seq>/frame10.png``;
  * synth mode (default): synthesize brightness-constant pairs by warping a
    texture through the ground-truth flow (``utils.synth``), keeping the
    true Middlebury flow geometry.
Each entry point takes ``device=`` (CUDA unless asked), and times the
estimate with its download.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from blockbasedmotionestimation_tpu_torch.config import MotionConfig
from blockbasedmotionestimation_tpu_torch.models.engine import estimate_flow_driver
from blockbasedmotionestimation_tpu_torch.utils import flowio, synth

SEQUENCES = (
    "Dimetrodon", "Grove2", "Grove3", "Hydrangea",
    "RubberWhale", "Urban2", "Urban3", "Venus",
)


@dataclasses.dataclass
class SequenceResult:
    name: str
    epe: float
    seconds: float
    shape: tuple[int, int]


def _timed_flow(im1: np.ndarray, im2: np.ndarray, cfg: MotionConfig, device):
    t0 = time.time()
    flow = estimate_flow_driver(im1, im2, cfg, device=device).cpu().numpy()
    return flow, time.time() - t0


def evaluate_sequence(
    name: str,
    gt_dir: str,
    cfg: MotionConfig,
    frames_dir: str | None = None,
    seed: int = 0,
    device=None,
) -> SequenceResult:
    gt = flowio.read_flo(os.path.join(gt_dir, name, "flow10.flo"))
    if frames_dir is not None:
        im1 = flowio.read_gray(os.path.join(frames_dir, name, "frame10.png"))
        im2 = flowio.read_gray(os.path.join(frames_dir, name, "frame11.png"))
    else:
        rng = np.random.default_rng(seed)
        im1, im2 = synth.pair_from_gt(gt, rng)
    flow, dt = _timed_flow(im1, im2, cfg, device)
    return SequenceResult(name=name, epe=flowio.average_epe(gt, flow), seconds=dt,
                          shape=im1.shape)


def evaluate_sequence_photometric(
    name: str,
    gt_dir: str,
    cfg: MotionConfig,
    *,
    gain: float = 1.0,
    offset: float = 0.0,
    noise_sigma: float = 0.0,
    occlusion_fill: bool = False,
    seed: int = 0,
    device=None,
) -> SequenceResult:
    """Synth-warp eval with a controlled brightness-constancy violation
    applied to frame 1 (``synth.pair_from_gt_photometric``)."""
    gt = flowio.read_flo(os.path.join(gt_dir, name, "flow10.flo"))
    rng = np.random.default_rng(seed)
    im1, im2 = synth.pair_from_gt_photometric(
        gt, rng, gain=gain, offset=offset, noise_sigma=noise_sigma,
        occlusion_fill=occlusion_fill,
    )
    flow, dt = _timed_flow(im1, im2, cfg, device)
    return SequenceResult(name=name, epe=flowio.average_epe(gt, flow), seconds=dt,
                          shape=im1.shape)


def evaluate_middlebury(
    gt_dir: str,
    cfg: MotionConfig,
    sequences: tuple[str, ...] = SEQUENCES,
    frames_dir: str | None = None,
    seed: int = 0,
    device=None,
) -> list[SequenceResult]:
    return [
        evaluate_sequence(s, gt_dir, cfg, frames_dir=frames_dir, seed=seed, device=device)
        for s in sequences
    ]


def format_report(results: list[SequenceResult]) -> str:
    lines = [f"{'sequence':<14} {'size':>10} {'EPE':>8} {'sec':>7}"]
    for r in results:
        lines.append(
            f"{r.name:<14} {r.shape[1]}x{r.shape[0]:>5} {r.epe:>8.4f} {r.seconds:>7.2f}"
        )
    mean = float(np.mean([r.epe for r in results])) if results else float("nan")
    lines.append(f"{'mean':<14} {'':>10} {mean:>8.4f}")
    return "\n".join(lines)
