"""The port's 2-D (ty x tx) tiling (``parallel/tiled.py``) against JAX.

The in-process transport (``LocalTiles``: a frame's tiles stacked on the
batch axis, CPU tensors, the kernels' plain versions) on 2-D meshes: the
flow equals JAX's UNTILED engine bit for bit, as ``tests/test_tiled.py``
holds JAX's 2-D tiling to its untiled engine: fourcolor, windowed and
windowed with rival windows on 2 x 4 tiles of 5 block columns (odd column
parity); batch x ty x tx; the coarse levels' fallback (row strips, or
whole-frame where only the columns shard); the cell rounds plain, with
``cv_fused=4`` and with ``cv_store_radius=2`` on 4 x 2 tiles; and a
two-motion flow whose edges cross tile boundaries on both axes, so the
corner ghost cells carry live data.  One case also runs JAX's own
``estimate_flow_padded_tiled(axis_x="tx")`` on the suite's 8 CPU devices.
The planning helpers with tx > 1 and ``estimate_flow_tiled_auto`` with
``axis_x`` equal JAX's.  Pairs made from a seed with numpy.
"""

import jax
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
from blockbasedmotionestimation_tpu_torch.kernels import rounds
from blockbasedmotionestimation_tpu_torch.parallel import tiled
from blockbasedmotionestimation_tpu_torch.utils import synth


# JAX's untiled engine, compiled once per configuration and frame size (the
# eager call re-dispatches every op, seconds a call on the CPU)
_jax_flow = jax.jit(jeng.estimate_flow_padded, static_argnames=("cfg",))


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


def _pair(rng, h, w, dy=2, dx=-3, margin=16):
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin : margin + h, margin : margin + w]
    im2 = base[margin + dy : margin + dy + h, margin + dx : margin + dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


def _mesh(ty, tx):
    return tiled.Mesh((ty, tx), ("ty", "tx"))


def _tiled_2d_vs_jax(cfg, im1, im2, ty, tx, jax_cfg=None):
    """The port's 2-D tiled flow of ``cfg`` against JAX's untiled flow of
    ``jax_cfg`` (default: cfg)."""
    got = tiled.estimate_flow_padded_tiled(im1, im2, _port(cfg), _mesh(ty, tx), axis_x="tx",
                                           device="cpu")
    want = np.asarray(_jax_flow(im1, im2, cfg=jax_cfg or cfg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("mode,rival", [("fourcolor", False), ("windowed", False),
                                        ("windowed", True)])
def test_tiled_2d_equals_jax_untiled(rng, mode, rival):
    # tests/test_tiled.py::test_tiled_2d_equals_untiled: 96 x 80 on 2 x 4
    # tiles, 5 block columns a tile, so every other tile starts on an odd
    # block column; level 1 (40 columns) does not split into 4 columns of
    # whole pairs of blocks and runs on row strips
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                       regularizer=mode, rival_window=rival)
    plan = tiled.plan_tiling(_port(cfg), 96, 80, 2, 4)
    assert [(e["rows_ok"], e["cols_ok"], e["strip_w"]) for e in plan] == [
        (True, True, 20), (True, False, 10)]
    im1, im2 = _pair(rng, 96, 80, dy=1, dx=-2)
    want = _tiled_2d_vs_jax(cfg, im1, im2, 2, 4)
    if mode == "fourcolor":
        # JAX's own 2-D tiled engine on the suite's 8 CPU devices agrees
        from jax.sharding import Mesh

        jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("ty", "tx"))
        jt = jtiled.estimate_flow_padded_tiled(im1, im2, cfg, jmesh, axis_x="tx")
        np.testing.assert_array_equal(np.asarray(jt), want)


def test_batch_tiled_3axis_equals_jax_untiled(rng):
    # tests/test_tiled.py::test_batch_tiled_3axis_matches_untiled: batch x
    # rows x columns, at the frame size of the cases above (one JAX compile)
    cfg = MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                       regularizer="windowed", rival_window=True)
    plan = tiled.plan_tiling(_port(cfg), 96, 80, 2, 2)
    assert [(e["rows_ok"], e["cols_ok"]) for e in plan] == [(True, True), (True, True)]
    pairs = [_pair(rng, 96, 80, dy=d % 3, dx=-(d % 2)) for d in range(2)]
    im1s = np.stack([p[0] for p in pairs])
    im2s = np.stack([p[1] for p in pairs])
    mesh = tiled.Mesh((2, 2, 2), ("batch", "ty", "tx"))
    got = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, _port(cfg), mesh, "batch", "ty",
                                                 "tx", device="cpu")
    for b in range(2):
        want = np.asarray(_jax_flow(im1s[b], im2s[b], cfg=cfg))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("h,w,levels,dispatch", [
    (128, 96, 3, [(True, True)] * 3),
    (128, 104, 2, [(True, True), (True, False)]),
], ids=["capped", "rows-only-level"])
def test_tiled_2d_coarse_fallback_equals_jax_untiled(rng, h, w, levels, dispatch):
    # tests/test_tiled.py::test_tiled_2d_coarse_fallback (mv_cap=4, 4 x 2
    # tiles), and a frame whose level 1 (52 columns) does not split into 2
    # block-aligned columns: that level runs on row strips of the 2-D mesh
    cfg = MotionConfig(block_sizes=(4,) * levels, search_sizes=(8,) * levels,
                       interp_factor=1, regularizer="windowed", mv_cap=4)
    plan = tiled.plan_tiling(_port(cfg), h, w, 4, 2)
    assert [(e["rows_ok"], e["cols_ok"]) for e in plan] == dispatch
    _tiled_2d_vs_jax(cfg, *_pair(rng, h, w, dy=2, dx=1), 4, 2)


CELL_CFG = MotionConfig(block_sizes=(8, 8), search_sizes=(16, 16), interp_factor=1,
                        regularizer="windowed", rival_window=True)


def _spied(monkeypatch, step_name):
    """Spy on the single step of the round wrapper ``step_name``: records
    whether each call had 2-D tiles."""
    calls = []
    rnd = getattr(rounds, step_name)
    plain = rnd.step

    def spy(*a, **k):
        calls.append(k["strips"] is not None and k["strips"].col0_b is not None)
        return plain(*a, **k)

    monkeypatch.setattr(rnd, "step", spy)
    return calls


@pytest.mark.parametrize("override,step", [
    (dict(), "color_round_hybrid"),
    (dict(cv_fused=4), "color_round_fused_rival"),
    (dict(cv_store_radius=2), "color_round_hybrid_tail"),
], ids=["plain", "cv_fused", "rstore"])
def test_tiled_2d_cell_rounds_equal_jax_untiled(monkeypatch, override, step):
    # tests/test_tiled.py::test_tiled_2d_pallas_cell_rounds_equal_untiled
    # (tests/_isolated_worker.py "tiled2d_cell_rounds*"): 128 x 64 on 4 x 2
    # tiles, the hybrid form (E), cv_fused=4 (12) and the band (F) run step
    # by step with ghost rows and corner-extended ghost columns; JAX's
    # untiled XLA flow is the dense one every form equals (one compile)
    cfg = CELL_CFG.replace(**override)
    h, w = 128, 64
    assert tiled.im2_halo(_port(cfg), 0) < min(h // 4, w // 2)
    assert tiled.im2_halo(_port(cfg), 1) < min(h // 8, w // 4)
    rng = np.random.default_rng(1234)
    base = synth.textured_image(h + 32, w + 32, rng)
    im1 = np.ascontiguousarray(base[16 : 16 + h, 16 : 16 + w])
    im2 = np.ascontiguousarray(base[18 : 18 + h, 13 : 13 + w])
    calls = _spied(monkeypatch, step)
    _tiled_2d_vs_jax(cfg, im1, im2, 4, 2, CELL_CFG)
    assert calls and all(calls)


def _disc_flow(h, w, cy, cx, radius, inside, outside):
    yy, xx = np.mgrid[:h, :w]
    disc = (yy - cy) ** 2 + (xx - cx) ** 2 < radius ** 2
    return np.where(disc[..., None], np.float32(inside), np.float32(outside)).astype(np.float32)


def test_tiled_2d_motion_edges_across_corners_equal_jax_untiled(monkeypatch):
    # in place of tests/_isolated_worker.py "tiled2d_cell_rounds_urban"
    # (Middlebury ground truth, not in the repo): a disc moving against the
    # background, centred on the corner where four tiles meet, so its edges
    # cross tile boundaries on both axes and the rival windows, the band's
    # tail and the corner ghost cells see both motions
    cfg = CELL_CFG.replace(cv_store_radius=2)
    h, w = 128, 64
    gt = _disc_flow(h, w, 64, 32, 22, (6.0, -4.0), (-3.0, 2.0))
    im1, im2 = synth.pair_from_gt(gt, np.random.default_rng(9))
    calls = _spied(monkeypatch, "color_round_hybrid_tail")
    want = _tiled_2d_vs_jax(cfg, im1, im2, 4, 2, CELL_CFG)
    assert calls and all(calls)
    # both motions meet at the tiles' shared corner (row 64, column 32)
    near = want[48:80, 16:48].reshape(-1, 2)
    mvs = {tuple(v) for v in near.tolist()}
    assert (6.0, -4.0) in mvs and (-3.0, 2.0) in mvs


@pytest.mark.parametrize("h,w,t,tx", [(1280, 2048, 2, 2), (1280, 2048, 2, 4), (96, 80, 2, 4),
                                      (128, 104, 4, 2), (1280, 2048, 4, 8)])
def test_plan_tiling_2d_equals_jax(h, w, t, tx):
    for cfg in (MotionConfig(interp_factor=1), MotionConfig(regularizer="fourcolor"),
                MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), regularizer="windowed")):
        assert tiled.plan_tiling(_port(cfg), h, w, t, tx) == jtiled.plan_tiling(cfg, h, w, t,
                                                                                 tx)


@pytest.mark.parametrize("h,w,t,tx", [(1080, 1920, 2, 2), (1080, 1920, 2, 4),
                                      (1080, 1920, 4, 2), (1080, 1920, 1, 8), (250, 64, 2, 4)])
def test_derive_mv_cap_2d_equals_jax(h, w, t, tx):
    for cfg in (MotionConfig(interp_factor=1), MotionConfig(
            block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1)):
        try:
            want = jtiled.derive_mv_cap(cfg, h, w, t, tx)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)[:20]):
                tiled.derive_mv_cap(_port(cfg), h, w, t, tx)
            continue
        assert tiled.derive_mv_cap(_port(cfg), h, w, t, tx) == want


def test_estimate_flow_tiled_auto_2d_equals_jax(rng):
    # tests/test_tiled.py::test_estimate_flow_tiled_auto with a column axis:
    # the cap derived for the narrower of the strips and columns
    cfg = MotionConfig(block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1,
                       regularizer="windowed")
    h, w, t, tx = 90, 120, 2, 2
    cap = tiled.derive_mv_cap(_port(cfg), h, w, t, tx)
    assert cap is not None and cap == jtiled.derive_mv_cap(cfg, h, w, t, tx)
    run_cfg = cfg.replace(mv_cap=cap)
    p = jpad.compute_padding(h, w, run_cfg, row_tiles=t)
    e0 = tiled.plan_tiling(_port(run_cfg), p.padded_h, p.padded_w, t, tx)[0]
    assert e0["rows_ok"] and e0["cols_ok"]
    im1, im2 = _pair(rng, h, w, dy=2, dx=-1)
    got = tiled.estimate_flow_tiled_auto(im1, im2, _port(cfg), _mesh(t, tx), axis_x="tx",
                                         device="cpu")
    assert tuple(got.shape) == (h, w, 2)
    pad = ((p.pad_y,) * 2, (p.pad_x,) * 2)
    want = np.asarray(_jax_flow(np.pad(im1, pad), np.pad(im2, pad), cfg=run_cfg))
    np.testing.assert_array_equal(got.numpy(), want[p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w])


def test_in_process_exchanges_2d(rng):
    # entry b * 12 + i * 3 + j is tile (i, j) of frame b on a 4 x 3 grid:
    # halos rows then columns (corners from the diagonal tiles), the ghost
    # columns over rows -1 .. nby, and the rival ring, against the frame
    # padded with zeros (edge copies for the rival ring)
    tiles = tiled.LocalTiles(4, 3)
    x = torch.as_tensor(rng.integers(1, 99, size=(2, 12, 9, 2)), dtype=torch.int32)
    s = tiles.split(x)
    assert s.shape == (24, 3, 3, 2) and torch.equal(tiles.join(s), x)
    zero = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    edge = x[:, torch.arange(-1, 13).clamp(0, 11)][:, :, torch.arange(-1, 10).clamp(0, 8)]
    buf = tiles.exchange_cols(tiles.exchange_rows(s, 2), 2)
    north, south, west, east = tiles.cell_exchange_2d(s[:, 0], s[:, -1], s[:, :, 0],
                                                      s[:, :, -1])
    ring = tiles.rival_extend(s)
    for b in range(2):
        for i in range(4):
            for j in range(3):
                k = b * 12 + i * 3 + j
                r, c = 3 * i, 3 * j
                assert torch.equal(buf[k], zero[b, r : r + 7, c : c + 7])
                assert torch.equal(north[k], zero[b, r + 1, c + 2 : c + 5])
                assert torch.equal(south[k], zero[b, r + 5, c + 2 : c + 5])
                assert torch.equal(west[k], zero[b, r + 1 : r + 6, c + 1])
                assert torch.equal(east[k], zero[b, r + 1 : r + 6, c + 5])
                assert torch.equal(ring[k], edge[b, r : r + 5, c : c + 5])
    assert torch.equal(tiles.row0(24, 3, "cpu")[:12],
                       torch.tensor([0, 0, 0, 3, 3, 3, 6, 6, 6, 9, 9, 9], dtype=torch.int32))
    assert torch.equal(tiles.col0(24, 3, "cpu")[:4], torch.tensor([0, 3, 6, 0],
                                                                  dtype=torch.int32))
