"""The port's search-then-regularize schedules against the JAX package, on
the CPU.

``run_schedule`` (fourcolor and jacobi on even and odd grids, exact),
``regularize_sweep``, ``windowed_schedule`` on search winners outside the
frame, and the engine end to end for the configurations that take
``block_search_level`` (exact, jacobi, the search-centred windowed schedule
without rival windows and with ``reg_radius``, the raster search, ssd, a
non-dyadic ``lambda_scale``; ``tests/test_torch_engine.py`` has fourcolor,
the search-centred rival case, raster windowed and ``reg_radius`` with
prediction-centred windows); exact also against the NumPy oracle.  MVs are integers and the f32 energies are computed in
the reference's order, so the tolerance is exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu.models import engine as jeng
from blockbasedmotionestimation_tpu.models import oracle
from blockbasedmotionestimation_tpu.ops import pad as jpad
from blockbasedmotionestimation_tpu.ops import regularize as jreg
from blockbasedmotionestimation_tpu.ops import windowed as jwin
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import engine as teng
from blockbasedmotionestimation_tpu_torch.ops import regularize as treg
from blockbasedmotionestimation_tpu_torch.ops import windowed as twin


def _pairs(rng, b, h, w, dy=2, dx=-3, margin=8):
    """b random base images and their translated crops: (b, h, w) u8 each."""
    base = rng.integers(0, 256, size=(b, h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[:, margin : margin + h, margin : margin + w]
    im2 = base[:, margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _two_motion(rng, b, h, w):
    """b textured pairs whose left and right halves move differently."""
    im1s, im2s = [], []
    for k in range(b):
        tex = synth.textured_image(h + 64, w + 64, rng)
        (ul, vl), (ur, vr) = ((11, -3), (-4, 2)) if k % 2 == 0 else ((-2, 5), (9, 0))
        a = tex[32 + vl : 32 + vl + h, 32 + ul : 32 + ul + w]
        c = tex[32 + vr : 32 + vr + h, 32 + ur : 32 + ur + w]
        im1s.append(np.where(np.arange(w)[None, :] < w // 2, a, c).astype(np.uint8))
        im2s.append(tex[32 : 32 + h, 32 : 32 + w])
    return np.stack(im1s), np.stack(im2s)


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


# ----------------------------------------------------------- run_schedule

@pytest.mark.parametrize("mode", ["fourcolor", "jacobi"])
@pytest.mark.parametrize("h,w", [(24, 40), (20, 36)], ids=["even", "odd"])
@pytest.mark.parametrize("cost", ["sad", "ssd"])
def test_run_schedule_matches_jax(rng, mode, h, w, cost):
    # bs 4: a 6x10 grid (even) or 5x9 (odd: the reference pads it)
    bs, b = 4, 2
    im1, im2 = _pairs(rng, b, h, w)
    grid = rng.integers(-3, 4, size=(b, h // bs, w // bs, 2)).astype(np.int32)
    lam0 = bs * 0.5
    got = treg.run_schedule(*_t(im1, im2, grid), bs, lam0, 2, mode, cost=cost)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, h, w, 2)
    for k in range(b):
        want = jreg.run_schedule(im1[k], im2[k], grid[k].astype(np.float32), bs, lam0, 2, mode,
                                 cost=cost)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["exact", "fourcolor", "jacobi"])
@pytest.mark.parametrize("h,w,bs", [(24, 32, 4), (24, 32, 2), (4, 32, 4)],
                         ids=["bs4", "bs2", "one-row"])
def test_regularize_sweep_matches_jax(rng, mode, h, w, bs):
    # a non-dyadic lambda * multiplier: f32(lam) * f32(mult), as the reference;
    # one block row: exact's candidates read the edge-replicated ring
    b = 2
    im1, im2 = _pairs(rng, b, h, w)
    grid = rng.integers(-3, 4, size=(b, h // bs, w // bs, 2)).astype(np.int32)
    lam, mult = 0.3 * bs, 3
    grid_t = torch.as_tensor(grid)
    got = treg.regularize_sweep(*_t(im1, im2), grid_t, bs, lam, mult, mode)
    assert torch.equal(grid_t, torch.as_tensor(grid))  # the input is not changed
    for k in range(b):
        want = jreg.regularize_sweep(im1[k], im2[k], grid[k].astype(np.float32), bs,
                                     np.float32(lam), np.float32(mult), mode)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("bs", [2, 4])
def test_exact_sweep_matches_oracle(rng, bs):
    h, w = 24, 32
    im1, im2 = _pairs(rng, 1, h, w)
    grid = rng.integers(-3, 4, size=(1, h // bs, w // bs, 2)).astype(np.int32)
    got = treg.regularize_sweep(*_t(im1, im2, grid), bs, bs / 2, 2, "exact")
    flow = np.zeros((h, w, 2), dtype=np.float32)
    flow[::bs, ::bs] = grid[0]
    oracle.regularize_mvs(im1[0], im2[0], flow, bs, np.float32(bs / 2), 2)
    np.testing.assert_array_equal(got[0].numpy(), flow[::bs, ::bs])


def test_run_schedule_exact_matches_jax(rng):
    bs, b, h, w = 4, 2, 20, 24
    im1, im2 = _pairs(rng, b, h, w)
    grid = rng.integers(-3, 4, size=(b, h // bs, w // bs, 2)).astype(np.int32)
    # exact scores SAD whatever the level's cost
    got = treg.run_schedule(*_t(im1, im2, grid), bs, 2.0, 2, "exact", cost="ssd")
    for k in range(b):
        want = jreg.run_schedule(im1[k], im2[k], grid[k].astype(np.float32), bs, 2.0, 2, "exact")
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


def test_run_schedule_rejects_unknown_mode(rng):
    im1, im2 = _pairs(rng, 1, 8, 8)
    grid = torch.zeros((1, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        treg.run_schedule(*_t(im1, im2), grid, 4, 2.0, 2, "redblack")


@pytest.mark.parametrize("rival,reg_radius", [(True, None), (False, None), (True, 3)])
def test_windowed_schedule_matches_jax_off_frame_winners(rng, rival, reg_radius):
    # a raster search keeps an out-of-frame prediction where its window is
    # clipped away entirely: the rounds rebase on that winner, not on the
    # clipped window centre, and the rival centres come from the winners
    bs, ss, b, h, w = 8, 24, 2, 40, 56
    im1, im2 = _pairs(rng, b, h, w)
    grid = rng.integers(-6, 7, size=(b, h // bs, w // bs, 2)).astype(np.int32)
    grid[:, 0, 0] = (-40, 30)
    grid[:, -1, 2] = (3, 100)
    kw = dict(reg_radius=reg_radius, rival=rival, rival_radius=4)
    got = twin.windowed_schedule(*_t(im1, im2, grid), bs, ss, 4.0, 2, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, h, w, 2)
    for k in range(b):
        want = jwin.windowed_schedule(im1[k], im2[k], grid[k], bs, ss, 4.0, 2, impl="xla", **kw)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))


# ------------------------------------------------------------- end to end

# 80x112 frames: level 1 is 40x56, a 5x7 (odd) parent grid at bs 8
H, W = 80, 112
TINY = MotionConfig(
    block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
    rival_radius=(4, None),
)


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


@pytest.mark.parametrize(
    "cfg",
    [
        TINY.replace(regularizer="jacobi"),
        TINY.replace(regularizer="fourcolor", cost="ssd"),
        TINY.replace(regularizer="fourcolor", lambda_scale=0.3, sweeps_per_round=3),
        TINY.replace(window_center="search", rival_window=False, cost="ssd"),
        TINY.replace(window_center="search", reg_radius=2),
        TINY.replace(search_order="raster", regularizer="fourcolor", mv_cap=16),
    ],
    ids=["jacobi", "fourcolor-ssd", "fourcolor-lambda0.3-3sweeps", "search-norival-ssd",
         "search-reg_radius2", "raster-fourcolor-mv_cap"],
)
def test_estimate_flow_batched_matches_jax(rng, cfg):
    im1s, im2s = _two_motion(rng, 2, H, W)
    want, _ = jeng.estimate_flow_batched(im1s, im2s, cfg.replace(search_impl="xla"))
    got, _ = teng.estimate_flow_batched(im1s, im2s, _port(cfg), device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "cfgkw",
    [
        dict(block_sizes=(4, 4), search_sizes=(8, 8)),
        dict(block_sizes=(2, 4, 4), search_sizes=(6, 8, 12)),
        dict(block_sizes=(4, 4), search_sizes=(12, 8), cost="ssd", lambda_scale=0.3,
             sweeps_per_round=3),
        dict(block_sizes=(4, 4), search_sizes=(12, 12), search_order="raster"),
    ],
    ids=["two-levels", "three-levels", "ssd-lambda0.3-3sweeps", "raster"],
)
def test_exact_engine_matches_jax(rng, cfgkw):
    cfg = MotionConfig(interp_factor=1, regularizer="exact", **cfgkw)
    im1, im2 = _pairs(rng, 2, 32, 48, dy=1, dx=-2)
    want, _ = jeng.estimate_flow_batched(im1, im2, cfg.replace(search_impl="xla"))
    got, _ = teng.estimate_flow_batched(im1, im2, _port(cfg), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_engine_matches_oracle(rng):
    cfg = MotionConfig(interp_factor=1, regularizer="exact", block_sizes=(2, 4, 4),
                       search_sizes=(6, 8, 12))
    h, w = 32, 48
    im1, im2 = _pairs(rng, 1, h, w, dy=1, dx=-2)
    p = jpad.compute_padding(h, w, cfg)
    im1p = np.pad(im1[0], ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x)))
    im2p = np.pad(im2[0], ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x)))
    want = oracle.calc_motion_block_matching(im1p, im2p, cfg)
    got = teng.estimate_flow_padded(*_t(im1p[None], im2p[None]), _port(cfg))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_exact_driver_matches_oracle(rng):
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(8, 8), interp_factor=2,
                       regularizer="exact")
    im1, im2 = _pairs(rng, 1, 20, 26, dy=1, dx=-1)
    want = oracle.estimate_flow_driver(im1[0], im2[0], cfg)
    got = teng.estimate_flow_driver(*_t(im1[0], im2[0]), _port(cfg))
    np.testing.assert_array_equal(got.numpy(), want)
