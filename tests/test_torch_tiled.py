"""The port's row tiling (``parallel/tiled.py``) against the JAX package.

The planning helpers (``mv_bound``, ``im2_halo``, ``plan_tiling``,
``derive_mv_cap``) and ``compute_padding(row_tiles=)`` equal JAX's; the
search-then-regularize schedules on row strips (the in-process transport,
8 strips on the CPU) equal JAX's UNTILED engine bit for bit, as
``tests/test_tiled.py`` holds JAX's tiled engine to its untiled one:
fourcolor and jacobi, a coarse level too small to tile, strips of an odd
number of block rows, and batches over the batch axis.  ``exact`` raises,
and the three entry points with ``axis_x`` run 2-D tiles (the 2-D cases
are in ``tests/test_torch_tiled_2d.py``); a mesh on which no level shards
warns.  Pairs made from a seed with numpy; the port runs on CPU tensors
(the kernels' plain versions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu.models import engine as jeng
from blockbasedmotionestimation_tpu.ops import pad as jpad
from blockbasedmotionestimation_tpu.parallel import tiled as jtiled
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import engine as teng
from blockbasedmotionestimation_tpu_torch.ops import pad as tpad
from blockbasedmotionestimation_tpu_torch.parallel import tiled


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


def _pair(rng, h, w, dy=2, dx=-3, margin=16):
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin : margin + h, margin : margin + w]
    im2 = base[margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _rows(t=8):
    return tiled.Mesh((t,), ("ty",))


def _tiled_vs_jax(cfg, im1, im2, t=8):
    got = tiled.estimate_flow_padded_tiled(im1, im2, _port(cfg), _rows(t), device="cpu")
    want = np.asarray(jeng.estimate_flow_padded(im1, im2, cfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


PLAN_CFGS = [
    MotionConfig(regularizer="fourcolor"),
    MotionConfig(),
    MotionConfig(interp_factor=1, regularizer="windowed", mv_cap=64),
    MotionConfig(block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), reg_radius=3),
    MotionConfig(block_sizes=(8, 16), search_sizes=(24, 40), regularizer="jacobi", mv_cap=30),
]


@pytest.mark.parametrize("cfg", PLAN_CFGS, ids=["fourcolor", "default", "cap64", "reg3", "jacobi"])
def test_mv_bound_and_halo_equal_jax(cfg):
    # mirrors tests/test_tiled.py::test_mv_bound_recursion over more configs
    tc = _port(cfg)
    for level in range(cfg.num_levels):
        assert tiled.mv_bound(tc, level) == jtiled.mv_bound(cfg, level)
        assert tiled.im2_halo(tc, level) == jtiled.im2_halo(cfg, level)
    if cfg == MotionConfig():
        assert [tiled.mv_bound(tc, lv) for lv in (3, 2, 1, 0)] == [16, 80, 208, 464]


@pytest.mark.parametrize("cfg", PLAN_CFGS, ids=["fourcolor", "default", "cap64", "reg3", "jacobi"])
@pytest.mark.parametrize("h,w,t,tx", [(1280, 2048, 8, 1), (1280, 2048, 2, 1), (96, 64, 8, 1),
                                      (256, 64, 8, 1), (1280, 2048, 2, 4)])
def test_plan_tiling_equals_jax(cfg, h, w, t, tx):
    assert tiled.plan_tiling(_port(cfg), h, w, t, tx) == jtiled.plan_tiling(cfg, h, w, t, tx)


@pytest.mark.parametrize("h,w,t", [(1080, 1920, 8), (1080, 1920, 4), (1080, 1920, 2),
                                   (1080, 1920, 1), (250, 64, 8), (388, 584, 3)])
def test_derive_mv_cap_equals_jax(h, w, t):
    # mirrors tests/test_tiled.py::test_derive_mv_cap_properties
    for cfg in (MotionConfig(interp_factor=1), MotionConfig(
            block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1)):
        try:
            want = jtiled.derive_mv_cap(cfg, h, w, t)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)[:20]):
                tiled.derive_mv_cap(_port(cfg), h, w, t)
            continue
        assert tiled.derive_mv_cap(_port(cfg), h, w, t) == want
    with pytest.raises(ValueError, match="cannot shard"):
        tiled.derive_mv_cap(_port(MotionConfig(interp_factor=1)), 256, 256, 8)


@pytest.mark.parametrize("h,w", [(1080, 1920), (250, 64), (96, 80), (388, 584), (480, 640)])
@pytest.mark.parametrize("t", [1, 2, 3, 4, 8])
def test_compute_padding_row_tiles_equals_jax(h, w, t):
    for cfg in (MotionConfig(), MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6))):
        try:
            want = jpad.compute_padding(h, w, cfg, row_tiles=t)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)[:20]):
                tpad.compute_padding(h, w, _port(cfg), row_tiles=t)
            continue
        assert vars(tpad.compute_padding(h, w, _port(cfg), row_tiles=t)) == vars(want)


@pytest.mark.parametrize("mode", ["fourcolor", "jacobi"])
def test_tiled_equals_jax_untiled(rng, mode):
    # tests/test_tiled.py::test_tiled_equals_untiled: 128 rows over 8 strips,
    # 4 block rows a strip
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1, regularizer=mode)
    assert [e["rows_ok"] for e in tiled.plan_tiling(_port(cfg), 128, 64, 8)] == [True, True]
    _tiled_vs_jax(cfg, *_pair(rng, 128, 64, dy=1, dx=-1))


def test_tiled_coarse_fallback_equals_jax_untiled(rng):
    # tests/test_tiled.py::test_tiled_coarse_fallback_equals_untiled: the
    # coarser levels' halos (24 and 8 rows) swallow their 16- and 8-row
    # strips, so they run whole-frame; the capped level 0 (24 < 32) shards
    cfg = MotionConfig(block_sizes=(4, 4, 4), search_sizes=(20, 20, 20), interp_factor=1,
                       regularizer="fourcolor", mv_cap=16)
    plan = tiled.plan_tiling(_port(cfg), 256, 64, 8)
    assert [(e["rows_ok"], e["halo"]) for e in plan] == [(True, 24), (False, 24), (False, 8)]
    _tiled_vs_jax(cfg, *_pair(rng, 256, 64, dy=2, dx=1))


@pytest.mark.parametrize("order", ["spiral", "raster"])
def test_tiled_odd_block_rows_equals_jax_untiled(rng, order):
    # tests/test_tiled.py::test_tiled_odd_block_rows_equals_untiled (fourcolor):
    # 96 rows over 8 strips = 3 block rows a strip, so every other strip
    # starts on an odd block row; the raster search on strips too
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                       regularizer="fourcolor", search_order=order)
    _tiled_vs_jax(cfg, *_pair(rng, 96, 64, dy=1, dx=-1))


def test_tiled_ssd_near_the_halo_equals_jax_untiled(rng):
    # ssd costs, motion at the search's reach: the outermost halo rows decide
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(12, 12), interp_factor=1,
                       regularizer="fourcolor", cost="ssd", mv_cap=8)
    assert tiled.plan_tiling(_port(cfg), 192, 48, 4)[0]["rows_ok"]
    _tiled_vs_jax(cfg, *_pair(rng, 192, 48, dy=7, dx=-6), t=4)


def test_batch_tiled_schedules_equal_jax_untiled(rng):
    # frame pairs over the batch axis and rows over "ty" on one mesh
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                       regularizer="fourcolor")
    pairs = [_pair(rng, 64, 64, dy=d % 3, dx=-(d % 2)) for d in range(4)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    got = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, _port(cfg),
                                                 tiled.Mesh((2, 4)), device="cpu")
    for b in range(4):
        want = np.asarray(jeng.estimate_flow_padded(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_batch_sharded_matches_jax_driver(rng):
    # tests/test_tiled.py::test_batch_sharded_matches_single
    cfg = MotionConfig(block_sizes=(4,), search_sizes=(8,), interp_factor=1,
                       regularizer="fourcolor")
    pairs = [_pair(rng, 32, 48, dy=d % 3, dx=-(d % 2)) for d in range(8)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    got = tiled.estimate_flow_batch(im1s, im2s, _port(cfg), tiled.Mesh((8,), ("batch",)),
                                    device="cpu")
    for b in range(8):
        want = np.asarray(jeng.estimate_flow_driver(im1s[b], im2s[b], cfg))
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_exact_and_2d_are_refused(rng):
    # exact raises on any mesh; the 2-D entry points (axis_x) run and equal
    # JAX's untiled engine on the same inputs
    im1, im2 = _pair(rng, 64, 64)
    exact = _port(MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), regularizer="exact"))
    with pytest.raises(ValueError, match="raster sweep"):
        tiled.estimate_flow_padded_tiled(im1, im2, exact, _rows(), device="cpu")
    with pytest.raises(ValueError, match="raster sweep"):
        tiled.estimate_flow_padded_batch_tiled(im1[None], im2[None], exact, tiled.Mesh((1, 4)),
                                               device="cpu")
    fc = exact.replace(regularizer="fourcolor")
    jfc = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), regularizer="fourcolor")
    want = np.asarray(jeng.estimate_flow_padded(im1, im2, jfc))
    mesh2d = tiled.Mesh((2, 2), ("ty", "tx"))
    got = tiled.estimate_flow_padded_tiled(im1, im2, fc, mesh2d, axis_x="tx", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    got = tiled.estimate_flow_tiled_auto(im1, im2, fc, mesh2d, axis_x="tx", device="cpu")
    assert tiled.derive_mv_cap(fc, 64, 64, 2, 2) is None
    assert jpad.compute_padding(64, 64, jfc, row_tiles=2).padded_h == 64
    np.testing.assert_array_equal(got.numpy(), want)
    got = tiled.estimate_flow_padded_batch_tiled(im1[None], im2[None], fc, tiled.Mesh(
        (1, 2, 2), ("batch", "ty", "tx")), axis_x="tx", device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_tiled_warns_when_fully_replicated(rng):
    # tests/test_tiled.py::test_tiled_warns_when_fully_replicated
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(8, 8), interp_factor=1,
                       regularizer="windowed")
    plan = tiled.plan_tiling(_port(cfg), 32, 64, 8)
    assert not any(e["rows_ok"] or e["cols_ok"] for e in plan)
    im1, im2 = _pair(rng, 32, 64, dy=1, dx=-1)
    with pytest.warns(UserWarning, match="REPLICATED"):
        got = tiled.estimate_flow_padded_tiled(im1, im2, _port(cfg), _rows(), device="cpu")
    want = np.asarray(jeng.estimate_flow_padded(im1, im2, cfg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_in_process_exchanges(rng):
    # the in-process transport: entry b * t + i is strip i of frame b;
    # halos and ghost rows from the neighbouring strips of the same frame,
    # zeros (edge copies for the rival extension) at the frame's edges
    rows = tiled.LocalTiles(3)
    x = torch.as_tensor(rng.integers(0, 99, size=(2, 12, 5)), dtype=torch.int32)
    s = rows.split(x)
    assert s.shape == (6, 4, 5) and torch.equal(rows.join(s), x)
    buf = rows.exchange_rows(s, 2)
    padded = torch.nn.functional.pad(x, (0, 0, 2, 2))
    for b in range(2):
        for i in range(3):
            assert torch.equal(buf[3 * b + i], padded[b, 4 * i : 4 * i + 8])
    north, south = rows.cell_exchange(s[:, 0], s[:, -1])
    assert torch.equal(north[1], s[0, -1]) and torch.equal(south[1], s[2, 0])
    assert not north[3].any() and not south[5].any()
    edge = rows.exchange_rows_edge(s)
    assert torch.equal(edge[3, 0], s[3, 0]) and torch.equal(edge[5, -1], s[5, -1])
    assert torch.equal(edge[4, 0], s[3, -1]) and torch.equal(edge[4, -1], s[5, 0])
    # the rival ring on strips: rows from the neighbours, the edge columns replicated
    g = torch.as_tensor(rng.integers(0, 99, size=(2, 12, 5, 2)), dtype=torch.int32)
    ring = rows.rival_extend(rows.split(g))
    edge_g = g[:, torch.arange(-1, 13).clamp(0, 11)][:, :, torch.arange(-1, 6).clamp(0, 4)]
    for b in range(2):
        for i in range(3):
            assert torch.equal(ring[3 * b + i], edge_g[b, 4 * i : 4 * i + 6])
    assert torch.equal(rows.row0(6, 4, "cpu"), torch.tensor([0, 4, 8] * 2, dtype=torch.int32))


def test_port_tiling_equals_port_untiled_on_every_schedule(rng):
    # the port against itself on the configurations JAX's row tiling takes,
    # 2 strips of 128 rows: search-then-regularize, raster, the fused level
    base = teng.estimate_flow_padded
    im1, im2 = _pair(rng, 256, 96, dy=3, dx=-5)
    a, b = torch.as_tensor(im1)[None], torch.as_tensor(im2)[None]
    cfg = tconfig.MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                               mv_cap=16)
    for over in (dict(regularizer="jacobi", cost="ssd"), dict(window_center="search"),
                 dict(search_order="raster"), dict(reg_radius=4), dict(cost="zsad")):
        c = cfg.replace(**over)
        got = tiled.estimate_flow_padded_batch_tiled(a, b, c, tiled.Mesh((1, 2)))
        assert torch.equal(got, base(a, b, c)), over
