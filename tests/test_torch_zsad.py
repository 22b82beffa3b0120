"""``cost="zsad"`` in the port against the JAX package, on the CPU.

zsad (zero-mean SAD) is the one float-valued cost.  The JAX package runs it
in XLA only (its Pallas kernels take sad and ssd), so the port runs it on
its plain versions on every device, and no kernel wrapper accepts it.

Tolerances: a cost is held to JAX's within ``rtol=1e-6`` (a few f32 ulps),
and bit for bit where f32 holds the sum exactly: every term |d - mean| is a
multiple of 1 / (cur * cur) and the sum is at most 255 * cur * cur, so for
sub-blocks of up to 16 x 16 pixels every partial sum is exact in any order.
At 32 x 32 and above the port's fixed pairwise order and XLA's may round
the last place differently.  The flows are held to JAX's exactly: the
engine tests run blocks of 16 and 8 pixels, and at the default 32 x 32
blocks (dense-rival, fourcolor, search-centred) every MV of the two pairs
equals JAX's (``MV_DIFF_BOUND``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu.models import engine as jeng
from blockbasedmotionestimation_tpu.ops import search as jsearch
from blockbasedmotionestimation_tpu.ops import windowed as jwin
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, rounds, sad_search
from blockbasedmotionestimation_tpu_torch.models import engine as teng
from blockbasedmotionestimation_tpu_torch.ops import windowed as twin
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent

H, W = 64, 96
ZSAD = MotionConfig(
    block_sizes=(16, 8), search_sizes=(32, 24), interp_factor=1, cost="zsad",
    rival_radius=(4, None),
)
RTOL = 1e-6


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


def _photometric_pairs(seed: int, h: int = H, w: int = W):
    """Two pairs: frame 1 is frame 2 moved (two motions in the second pair,
    left and right halves), then put through a gain and an offset."""
    rng = np.random.default_rng(seed)
    im1s, im2s = [], []
    for k, (gain, offset) in enumerate(((1.1, 12.0), (0.9, -10.0))):
        tex = synth.textured_image(h + 32, w + 32, rng)
        a = tex[16 + 3 : 16 + 3 + h, 16 - 5 : 16 - 5 + w]
        if k == 1:
            c = tex[16 - 4 : 16 - 4 + h, 16 + 6 : 16 + 6 + w]
            a = np.where(np.arange(w)[None, :] < w // 2, a, c)
        im1s.append(synth.perturb_photometric(a, rng, gain=gain, offset=offset))
        im2s.append(tex[16 : 16 + h, 16 : 16 + w])
    return np.stack(im1s), np.stack(im2s)


@pytest.mark.parametrize("bs", [2, 4, 8, 16, 32])
def test_block_cost_matches_jax(bs):
    rng = np.random.default_rng(bs)
    a = rng.integers(0, 256, size=(2, 5, bs, bs)).astype(np.int16)
    b = rng.integers(0, 256, size=(2, 5, bs, bs)).astype(np.int16)
    b[0, 0] = a[0, 0] + 7  # a pure offset costs 0
    want = np.asarray(jsearch.block_cost(a, b, (-1, -2), "zsad"))
    got = sad_search.block_cost(torch.as_tensor(a), torch.as_tensor(b), (-2, -1), "zsad")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert float(got[0, 0]) == 0.0
    if bs <= 16:  # the sums are exact
        np.testing.assert_array_equal(got.numpy(), want)
    # the layout the search reduces: pixels on the leading dims
    want_t = np.asarray(jsearch.block_cost(a.transpose(2, 3, 0, 1), b.transpose(2, 3, 0, 1),
                                           (0, 1), "zsad"))
    np.testing.assert_allclose(want_t, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("bs,r", [(8, 2), (16, 3)])
def test_pooled_cvs_plain_matches_jax_compute_cv(bs, r):
    rng = np.random.default_rng(100 + bs)
    npy, npx = 2, 3
    im1 = rng.integers(0, 256, size=(npy * bs, npx * bs), dtype=np.uint8)
    ws = bs + 2 * r
    wins = rng.integers(0, 256, size=(npy * npx, ws, ws), dtype=np.uint8)
    patches = im1.reshape(npy, bs, npx, bs).transpose(0, 2, 1, 3).astype(np.int16)
    wins_j = wins.reshape(npy, npx, ws, ws).astype(np.int16)
    got = cv_diff.pooled_cvs_plain(torch.as_tensor(im1[None]), torch.as_tensor(wins[None]),
                                   bs, r, "zsad")
    assert sorted(got) == [c for c in (2, 4, 8, 16) if c <= bs]
    for cur, vol in got.items():
        want = np.asarray(jwin._compute_cv(patches, wins_j, bs, cur, r, r, "zsad"))
        assert vol.dtype == torch.float32 and vol.shape[0] == 1
        np.testing.assert_allclose(vol[0].numpy(), want, rtol=RTOL, atol=0)
        np.testing.assert_array_equal(vol[0].numpy(), want)  # cur <= 16: exact


@pytest.mark.parametrize(
    "cfg",
    [
        ZSAD,
        ZSAD.replace(rival_window=False),
        ZSAD.replace(window_center="search"),
        ZSAD.replace(regularizer="fourcolor"),
        ZSAD.replace(regularizer="jacobi"),
        ZSAD.replace(regularizer="exact"),
        ZSAD.replace(search_order="raster"),
        ZSAD.replace(search_order="raster", regularizer="fourcolor"),
    ],
    ids=["dense-rival", "norival", "search-rival", "fourcolor", "jacobi", "exact",
         "raster-windowed", "raster-fourcolor"],
)
def test_engine_zsad_matches_jax(cfg):
    im1s, im2s = _photometric_pairs(7)
    want, wp = jeng.estimate_flow_batched(im1s, im2s, cfg)
    got, gp = teng.estimate_flow_batched(im1s, im2s, _port(cfg), device="cpu")
    assert (gp.padded_h, gp.padded_w, gp.pad_y, gp.pad_x) == (wp.padded_h, wp.padded_w,
                                                              wp.pad_y, wp.pad_x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_zsad_recovers_motion_under_gain_and_offset():
    im1s, im2s = _photometric_pairs(11)
    flow, p = teng.estimate_flow_batched(im1s, im2s, _port(ZSAD), device="cpu")
    inner = flow[0, p.pad_y + 16 : p.pad_y + H - 16, p.pad_x + 16 : p.pad_x + W - 16]
    # frame 1 is frame 2 moved by (+3, -5): flow (u, v) = (-5, 3)
    assert float((inner == torch.tensor([-5.0, 3.0])).all(-1).float().mean()) > 0.95


def test_zsad_ignores_the_accelerator_forms():
    # JAX runs zsad in XLA whatever search_impl and the capacity options
    # say (ops/windowed.py, ops/search.py): every one gives the same flow
    im1s, im2s = _photometric_pairs(3)
    port = _port(ZSAD)
    ref, _ = teng.estimate_flow_batched(im1s, im2s, port, device="cpu")
    for kw in (dict(search_impl="xla"), dict(search_impl="pallas"), dict(cv_fused=4),
               dict(cv_store_radius=None)):
        got, _ = teng.estimate_flow_batched(im1s, im2s, port.replace(**kw), device="cpu")
        assert torch.equal(got, ref), kw
    norival = port.replace(rival_window=False)
    ref, _ = teng.estimate_flow_batched(im1s, im2s, norival, device="cpu")
    got, _ = teng.estimate_flow_batched(im1s, im2s, norival.replace(cv_compact=8), device="cpu")
    assert torch.equal(got, ref)


def test_driver_zsad_interp2_matches_jax():
    im1s, im2s = _photometric_pairs(5, H // 2, W // 2)
    cfg = ZSAD.replace(interp_factor=2)
    want = np.asarray(jeng.estimate_flow_driver(im1s[1], im2s[1], cfg))
    got = teng.estimate_flow_driver(im1s[1], im2s[1], _port(cfg), device="cpu")
    assert tuple(got.shape) == (H // 2, W // 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spiral_argmin_orders_f32_costs():
    # costs a quarter apart: an integer key would tie them and hand the
    # win to the earlier spiral visit (the centre)
    shift, bs = 4, 4
    ext = spiral_extent(shift)
    side = 2 * ext + 1
    sad = torch.full((1, side * side, 1, 1), 10.5)
    sad[0, side * side - 1] = 10.25  # the corner delta (ext, ext)
    c = torch.full((1, 1, 1), 8, dtype=torch.int32)
    dy, dx = twin.spiral_argmin(sad, c, c, shift, bs, 32, 32)
    assert (int(dy), int(dx)) == (ext, ext)
    assert tuple(twin.spiral_argmin(sad.to(torch.int32), c, c, shift, bs, 32, 32)) == (0, 0)


def test_check_config_accepts_zsad():
    for cfg in (ZSAD, ZSAD.replace(regularizer="fourcolor"),
                MotionConfig(block_sizes=(256,), search_sizes=(1024,), cost="zsad")):
        teng.check_config(_port(cfg), "cuda")  # no kernel limit applies
        assert teng.cuda_refusals(_port(cfg)) == []
    assert teng.cuda_refusals(_port(ZSAD.replace(block_sizes=(256, 8), search_sizes=(288, 24),
                                                 cost="sad")))


def test_kernel_wrappers_refuse_zsad():
    rng = np.random.default_rng(0)
    im1 = torch.as_tensor(rng.integers(0, 256, size=(1, 16, 16), dtype=np.uint8))
    wins = torch.zeros((1, 4, 12, 12), dtype=torch.uint8)
    for fn, args in ((cv_diff.pooled_cvs, ()), (cv_diff.full_block_volume, ()),
                     (cv_diff.deep_pooled_cvs, (4,))):
        with pytest.raises(NotImplementedError, match="zsad"):
            fn(im1, wins, 8, 2, "zsad", *args)
    slots = torch.zeros((1, 1, 2, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="zsad"):
        cv_diff.compact_tables(im1, wins, slots, 8, 2, "zsad")
    c = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="zsad"):
        sad_search.sad_spiral_argmin(im1, wins, c, c, 8, 12, "zsad")
    # the stored colour steps' wrappers take u16/i32 volumes only
    grid = torch.zeros((1, 8, 8, 2), dtype=torch.int32)
    pm = torch.zeros((1, 2, 2, 2), dtype=torch.int32)
    vol = torch.zeros((1, 25, 8, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="uint16/int32"):
        rounds.color_round_stored(grid, vol, pm, cur=2, h=16, w=16, r=2, lam=1.0, sweeps=1)
    with pytest.raises(ValueError, match="uint16/int32"):
        rounds.color_step(grid, vol, pm, cur=2, h=16, w=16, r=2, ci=0, cj=0, lam_mult=1.0)
    # its plain round takes them: zsad's rounds
    rounds.color_round_stored_plain(grid, vol, pm, cur=2, h=16, w=16, r=2, lam=1.0, sweeps=1)
    with pytest.raises(NotImplementedError, match="zsad"):
        rounds.color_step_hybrid(grid, vol, pm, im1=im1, rwin=wins[:, :, :8, :8], rpm=pm,
                                     cur=2, h=16, w=16, r=2, r2=0, ci=0, cj=0, lam_mult=1.0,
                                     cost="zsad")


def test_spiral_argmin_plain_zsad_returns_int32_offsets():
    rng = np.random.default_rng(12)
    im1 = torch.as_tensor(rng.integers(0, 256, size=(1, 16, 16), dtype=np.uint8))
    wins = torch.as_tensor(rng.integers(0, 256, size=(1, 4, 16, 16), dtype=np.uint8))
    c = torch.full((1, 4), 4, dtype=torch.int32)
    for cost in ("sad", "zsad"):
        dy, dx = sad_search.sad_spiral_argmin_plain(im1, wins, c, c, 8, 16, cost)
        assert dy.dtype == dx.dtype == torch.int32, cost


# the default block size: 32 x 32 blocks, S = 16, two levels
ZSAD32 = MotionConfig(block_sizes=(32, 32), search_sizes=(64, 64), interp_factor=1, cost="zsad")
# MVs that may differ from JAX's a pair at 32 x 32 (the last place of a
# 1024-term f32 sum may round another way): none, on these pairs
MV_DIFF_BOUND = 0


@pytest.mark.parametrize(
    "cfg",
    [ZSAD32, ZSAD32.replace(regularizer="fourcolor"), ZSAD32.replace(window_center="search")],
    ids=["dense-rival", "fourcolor", "search-rival"],
)
def test_engine_zsad_32px_blocks_matches_jax(cfg):
    # ROADMAP Queue 3 item 1: zsad at the default 32 px blocks, where the
    # costs are held only within rtol; the flows are counted pixel by pixel
    im1s, im2s = _photometric_pairs(13, 128, 192)
    want, _ = jeng.estimate_flow_batched(im1s, im2s, cfg)
    got, _ = teng.estimate_flow_batched(im1s, im2s, _port(cfg), device="cpu")
    differ = (got.numpy() != np.asarray(want)).any(-1).sum(axis=(1, 2))
    assert differ.tolist() == [MV_DIFF_BOUND] * 2, differ
