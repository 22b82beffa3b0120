"""The port's NumPy/OpenCV oracle against the JAX package's, on the CPU.

Every public function of ``blockbasedmotionestimation_tpu_torch/models/
oracle.py`` on the same seeded numpy inputs as the JAX package's
``models/oracle.py``: exact equality of every value (the oracles are
integer and f32 code on uint8 frames).  Then the port's CPU engine
(``regularizer="exact"``) against the port's own oracle on the
configurations of ``tests/test_engine.py``, which closes the loop without
JAX, and the port's exact sweep (wavefronts of blocks with equal 2 * row +
column) against the oracle's raster sweep on tall, wide and odd grids.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu import config as jconfig
from blockbasedmotionestimation_tpu.models import oracle as joracle
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import engine as teng
from blockbasedmotionestimation_tpu_torch.models import oracle as toracle
from blockbasedmotionestimation_tpu_torch.ops import pad as tpad

# the four exact configurations of tests/test_engine.py's engine-vs-oracle
# test, and its raster one
EXACT = [
    dict(block_sizes=(4,), search_sizes=(8,)),
    dict(block_sizes=(4, 4), search_sizes=(8, 8)),
    dict(block_sizes=(4, 4), search_sizes=(12, 8)),
    dict(block_sizes=(2, 4, 4), search_sizes=(6, 8, 12)),
]
RASTER = dict(block_sizes=(4, 4), search_sizes=(12, 12), search_order="raster")
DRIVER = dict(block_sizes=(4, 4), search_sizes=(8, 8), interp_factor=2)


def _cfgs(**kw):
    """The JAX package's config and the port's, from the same fields."""
    return jconfig.MotionConfig(**kw), tconfig.MotionConfig(**kw)


def _pair(rng, h, w, dy, dx, margin=8):
    """A random base image and a translated crop pair (uint8)."""
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin : margin + h, margin : margin + w]
    im2 = base[margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _padded(im1, im2, cfg):
    p = tpad.compute_padding(*im1.shape, cfg)
    pad = ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x))
    return np.pad(im1, pad), np.pad(im2, pad)


# ------------------------------------------------------------------ padding


@pytest.mark.parametrize(
    "cfgkw,size",
    [
        (dict(block_sizes=(8, 8), search_sizes=(16, 16)), (64, 48)),
        (dict(block_sizes=(8, 8), search_sizes=(16, 16)), (60, 41)),
        (dict(), (1552, 2336)),
        (dict(block_sizes=(64, 64), search_sizes=(64, 64)), (63, 256)),
    ],
)
def test_find_padding(cfgkw, size):
    jc, tc = _cfgs(**cfgkw)
    try:
        want = joracle.find_padding(*size, jc)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            toracle.find_padding(*size, tc)
        assert str(got.value) == str(err)
        return
    assert toracle.find_padding(*size, tc) == want


@pytest.mark.parametrize("size", [(60, 44), (61, 44)])
def test_pad_images(rng, size):
    # (61, 44) pads by an odd difference, which both refuse alike
    jc, tc = _cfgs(block_sizes=(8, 8), search_sizes=(16, 16))
    a = rng.integers(0, 256, size=size, dtype=np.uint8)
    b = rng.integers(0, 256, size=size, dtype=np.uint8)
    try:
        want = joracle.pad_images(a, b, jc)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            toracle.pad_images(a, b, tc)
        assert str(got.value) == str(err)
        return
    got = toracle.pad_images(a, b, tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- resampling (OpenCV)


@pytest.mark.parametrize("size,levels", [((64, 96), 4), ((50, 74), 3)])
def test_build_pyramid(rng, size, levels):
    im = rng.integers(0, 256, size=size, dtype=np.uint8)
    want = joracle.build_pyramid(im, levels)
    got = toracle.build_pyramid(im, levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("factor", [2, 4])
def test_resize_x4_u8(rng, factor):
    im = rng.integers(0, 256, size=(20, 26), dtype=np.uint8)
    np.testing.assert_array_equal(toracle.resize_x4_u8(im, factor),
                                  joracle.resize_x4_u8(im, factor))


# ----------------------------------------------------------------- searches

# (y1, x1, y2, x2): inside, at the corners, partly out of the frame (probes
# skipped while the cursor advances), and predicted centres out of the
# frame (the spiral's zero-MV early-out; the raster's empty window)
POSITIONS = [(8, 8, 8, 8), (0, 0, 2, 1), (8, 8, 7, 9), (28, 36, 27, 35), (8, 8, 0, 0),
             (8, 8, 28, 36), (4, 4, -1, 4), (4, 4, 4, 37), (12, 20, 40, 20), (0, 36, -3, 38)]


@pytest.mark.parametrize("order", ["spiral", "raster"])
@pytest.mark.parametrize("bs,ss", [(4, 8), (4, 12), (8, 16)])
def test_block_finders(rng, order, bs, ss):
    h, w = 32, 40
    # low entropy: many SAD ties, so the tie-breaks decide
    im1 = rng.integers(0, 8, size=(h, w)).astype(np.uint8)
    im2 = rng.integers(0, 8, size=(h, w)).astype(np.uint8)
    name = f"find_min_block_{order}"
    for pos in POSITIONS:
        y1, x1, y2, x2 = pos
        y1, x1 = min(y1, h - bs), min(x1, w - bs)
        want = getattr(joracle, name)(im1, im2, y1, x1, y2, x2, bs, ss)
        got = getattr(toracle, name)(im1, im2, y1, x1, y2, x2, bs, ss)
        assert got == want, (order, pos)


@pytest.mark.parametrize("order", ["spiral", "raster"])
@pytest.mark.parametrize("bs,ss", [(4, 8), (8, 16)])
def test_calc_level_bm(rng, order, bs, ss):
    h, w = 32, 40
    im1, im2 = _pair(rng, h, w, 2, -3)
    flow = np.zeros((h, w, 2), np.float32)
    pred = rng.integers(-6, 7, size=(h // bs, w // bs, 2)).astype(np.float32)
    pred[0, 0] = (1000.0, 1000.0)   # out of the frame: early-out / empty window
    pred[0, 1] = (-(w + 5.0), 0.0)  # partly clipped
    pred[1, 1] = (-2.5, 1.75)       # truncated toward zero
    flow[::bs, ::bs] = pred
    want, got = flow.copy(), flow.copy()
    joracle.calc_level_bm(im1, im2, want, bs, ss, order=order)
    toracle.calc_level_bm(im1, im2, got, bs, ss, order=order)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- regularization

H9, W9, BS9 = 20, 24, 4
# one block of each border case on a 5x6 grid of 4 px blocks
CASES = {"interior": (4, 4), "top": (0, 4), "bottom": (16, 4), "left": (4, 0),
         "right": (4, 20), "top-left": (0, 0), "top-right": (0, 20),
         "bottom-left": (16, 0), "bottom-right": (16, 20)}


@pytest.mark.parametrize("case", list(CASES))
def test_candidate_offsets(case):
    i, j = CASES[case]
    got = toracle.candidate_offsets(i, j, BS9, H9, W9)
    assert got == joracle.candidate_offsets(i, j, BS9, H9, W9)
    # the nine cases are nine different orderings
    others = [toracle.candidate_offsets(*ij, BS9, H9, W9) for c, ij in CASES.items() if c != case]
    assert all(o != got for o in others)


@pytest.mark.parametrize("bs,mult", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_regularize_mvs(rng, bs, mult):
    h, w = 24, 32
    im1, im2 = _pair(rng, h, w, 2, -3)
    flow = np.zeros((h, w, 2), np.float32)
    flow[::bs, ::bs] = rng.integers(-3, 4, size=(h // bs, w // bs, 2))
    flow[0, w - bs] = (40.0, 0.0)  # a candidate out of the frame
    want, got = flow.copy(), flow.copy()
    joracle.regularize_mvs(im1, im2, want, bs, np.float32(bs / 2), mult)
    toracle.regularize_mvs(im1, im2, got, bs, np.float32(bs / 2), mult)
    np.testing.assert_array_equal(got, want)


def test_regularize_mvs_refuses_below_2x2(rng):
    im = rng.integers(0, 256, size=(8, 16), dtype=np.uint8)
    flow = np.zeros((8, 16, 2), np.float32)
    with pytest.raises(ValueError) as want:
        joracle.regularize_mvs(im, im, flow, 8, np.float32(4), 1)
    with pytest.raises(ValueError) as got:
        toracle.regularize_mvs(im, im, flow, 8, np.float32(4), 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn", ["divide_blocks", "copy_to_all_pixels", "copy_mvs",
                                "fill_block_mv"])
def test_mv_bookkeeping(rng, fn):
    flow = rng.integers(-9, 10, size=(16, 24, 2)).astype(np.float32)
    want, got = flow.copy(), flow.copy()
    if fn == "copy_mvs":
        want = np.zeros((32, 48, 2), np.float32)
        got = want.copy()
        joracle.copy_mvs(flow, want, 4)
        toracle.copy_mvs(flow, got, 4)
    elif fn == "fill_block_mv":
        mv = np.float32([3.0, -2.0])
        joracle.fill_block_mv(want, 4, 8, 4, mv)
        toracle.fill_block_mv(got, 4, 8, 4, mv)
    else:
        getattr(joracle, fn)(want, 4)
        getattr(toracle, fn)(got, 4)
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- end to end


@pytest.mark.parametrize("cfgkw", EXACT + [RASTER], ids=lambda kw: str(kw["block_sizes"])
                         + kw.get("search_order", ""))
def test_calc_motion_block_matching(rng, cfgkw):
    jc, tc = _cfgs(interp_factor=1, regularizer="exact", **cfgkw)
    im1p, im2p = _padded(*_pair(rng, 32, 48, 1, -2), tc)
    want = joracle.calc_motion_block_matching(im1p, im2p, jc)
    got = toracle.calc_motion_block_matching(im1p, im2p, tc)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_estimate_flow_driver(rng):
    jc, tc = _cfgs(regularizer="exact", **DRIVER)
    im1, im2 = _pair(rng, 20, 26, 1, -1)
    want = joracle.estimate_flow_driver(im1, im2, jc)
    got = toracle.estimate_flow_driver(im1, im2, tc)
    assert got.shape == (20, 26, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfgkw", EXACT + [RASTER], ids=lambda kw: str(kw["block_sizes"])
                         + kw.get("search_order", ""))
def test_port_exact_engine_equals_port_oracle(rng, cfgkw):
    cfg = tconfig.MotionConfig(interp_factor=1, regularizer="exact", **cfgkw)
    im1p, im2p = _padded(*_pair(rng, 32, 48, 1, -2), cfg)
    want = toracle.calc_motion_block_matching(im1p, im2p, cfg)
    got = teng.estimate_flow_padded(torch.as_tensor(im1p)[None], torch.as_tensor(im2p)[None], cfg)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_port_exact_driver_equals_port_oracle(rng):
    cfg = tconfig.MotionConfig(regularizer="exact", **DRIVER)
    im1, im2 = _pair(rng, 20, 26, 1, -1)
    want = toracle.estimate_flow_driver(im1, im2, cfg)
    got = teng.estimate_flow_driver(im1, im2, cfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", [(10, 3), (3, 10), (7, 9), (2, 2)])
@pytest.mark.parametrize("bs", [2, 4])
def test_port_exact_sweep_equals_oracle_sweep(rng, grid, bs):
    # the port sweeps in wavefronts of equal 2 * row + column; the oracle
    # block by block in raster order: tall, wide, odd and 2x2 grids
    from blockbasedmotionestimation_tpu_torch.ops import regularize as treg

    h, w = grid[0] * bs, grid[1] * bs
    im1, im2 = _pair(rng, h, w, 1, -1)
    mvs = rng.integers(-3, 4, size=grid + (2,)).astype(np.int32)
    mvs[0, -1] = (w, 0)  # a candidate out of the frame
    flow = np.zeros((h, w, 2), np.float32)
    flow[::bs, ::bs] = mvs
    toracle.regularize_mvs(im1, im2, flow, bs, np.float32(bs / 2), 2)
    got = treg.regularize_sweep(torch.as_tensor(im1)[None], torch.as_tensor(im2)[None],
                                torch.as_tensor(mvs)[None], bs, np.float32(bs / 2),
                                np.float32(2), "exact")
    np.testing.assert_array_equal(got[0].numpy(), flow[::bs, ::bs])
