"""Synthetic frame-pair generation for evaluation without bundled frames.

The reference reads Middlebury input frames from disk (``main_class.cpp:24-26``)
but ships only the ground-truth ``.flo`` fields (``*.png`` is git-ignored,
``.gitignore:5-10``).  To evaluate against real Middlebury flow GEOMETRY
without the frames, we synthesize a texture, then build frame 1 by backward-
warping frame 2 through the ground-truth flow:

    im1(x) = im2(x + gt(x))      (bilinear; the brightness-constancy ideal)

An estimator that recovers gt exactly would score EPE 0 on known pixels, so
EPE measured this way is a true accuracy signal on realistic flow fields
(discontinuities, unknown regions, sub-pixel motion).
"""

from __future__ import annotations

import numpy as np

from blockbasedmotionestimation_tpu_torch.utils.flowio import unknown_flow_mask


def textured_image(h: int, w: int, rng: np.random.Generator, octaves: int = 4) -> np.ndarray:
    """Multi-octave value-noise texture, uint8 - matchable at several scales."""
    img = np.zeros((h, w), dtype=np.float64)
    amp = 1.0
    for o in range(octaves):
        step = 1 << (octaves - o)
        gh, gw = h // step + 2, w // step + 2
        grid = rng.standard_normal((gh, gw))
        ys = np.arange(h) / step
        xs = np.arange(w) / step
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + grid[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        img += amp * g
        amp *= 0.6
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.uint8)


def warp_backward(image: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Sample ``image`` at x + flow(x), bilinear with edge clamping -> uint8.

    Unknown-flow pixels sample the identity (flow treated as 0 there).
    """
    h, w = image.shape
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    unk = unknown_flow_mask(flow)
    u = np.where(unk, 0.0, u)
    v = np.where(unk, 0.0, v)
    yy, xx = np.mgrid[0:h, 0:w]
    sx = np.clip(xx + u, 0, w - 1)
    sy = np.clip(yy + v, 0, h - 1)
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = sx - x0
    fy = sy - y0
    img = image.astype(np.float64)
    out = (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x1] * (1 - fy) * fx
        + img[y1, x0] * fy * (1 - fx)
        + img[y1, x1] * fy * fx
    )
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def pair_from_gt(
    gt_flow: np.ndarray, rng: np.random.Generator, octaves: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """(frame1, frame2) uint8 whose true motion is ``gt_flow``."""
    h, w = gt_flow.shape[:2]
    im2 = textured_image(h, w, rng, octaves)
    im1 = warp_backward(im2, gt_flow)
    return im1, im2


def perturb_photometric(
    image: np.ndarray,
    rng: np.random.Generator,
    *,
    gain: float = 1.0,
    offset: float = 0.0,
    noise_sigma: float = 0.0,
) -> np.ndarray:
    """Photometric perturbation of one frame: out = gain*in + offset + N(0, s).

    The GT-warp suite idealizes brightness constancy; real camera pairs have
    exposure/illumination drift and sensor noise (the reference's entire
    quantitative record, ``error.txt``, is on such real frames).  Applying
    this to ONE frame of a pair breaks the constancy by a controlled amount
    so EPE robustness can be measured (EVAL_robust.md).
    """
    out = image.astype(np.float64) * gain + offset
    if noise_sigma > 0.0:
        out = out + rng.normal(0.0, noise_sigma, size=image.shape)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def pair_from_gt_photometric(
    gt_flow: np.ndarray,
    rng: np.random.Generator,
    *,
    gain: float = 1.0,
    offset: float = 0.0,
    noise_sigma: float = 0.0,
    occlusion_fill: bool = False,
    octaves: int = 4,
) -> tuple[np.ndarray, np.ndarray]:
    """GT-warp pair with photometric nuisance applied to frame 1.

    occlusion_fill: where the backward warp folds (multiple sources map to
    one target, |gt| discontinuities), real frames show DIFFERENT content
    rather than a smooth warp; emulate by re-texturing pixels whose local
    flow divergence exceeds 1px with an independent texture patch.
    """
    h, w = gt_flow.shape[:2]
    im2 = textured_image(h, w, rng, octaves)
    im1 = warp_backward(im2, gt_flow)
    if occlusion_fill:
        u = np.where(unknown_flow_mask(gt_flow), 0.0, gt_flow[..., 0])
        v = np.where(unknown_flow_mask(gt_flow), 0.0, gt_flow[..., 1])
        div = np.abs(np.gradient(u, axis=1)) + np.abs(np.gradient(v, axis=0))
        occ = div > 1.0
        alt = textured_image(h, w, rng, octaves)
        im1 = np.where(occ, alt, im1).astype(np.uint8)
    im1 = perturb_photometric(
        im1, rng, gain=gain, offset=offset, noise_sigma=noise_sigma
    )
    return im1, im2
