"""The capped tiled paths and the other level forms on row strips, against JAX.

``mv_cap`` near the halo bound (the level shards only because of the cap),
``estimate_flow_tiled_auto`` (the derived cap and the tile-aware padding),
search-centred windows (``windowed_schedule``) on a batch over both mesh
axes, and the hybrid form's band (kernel F's plain version at cur 2) and
``cv_fused=4`` with rival windows (kernel 12's at cur 4 and 2) run step by
step on strips with ghost rows: each equals JAX's UNTILED engine bit for
bit (mirrors of ``tests/test_tiled.py``; JAX's XLA flow is the dense one
every form equals).  The in-process transport on the CPU, pairs made from
a seed with numpy.
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
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.kernels import rounds
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
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def test_mv_cap_tiled_equals_jax_untiled_near_bound(rng):
    # tests/test_tiled.py::test_mv_cap_tiled_equals_untiled_near_bound: the
    # motion sits at the cap, so edge strips read the outermost halo rows;
    # the level shards only because of the cap
    cfg = MotionConfig(block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1,
                       regularizer="windowed", mv_cap=8)
    h, t = 256, 8
    assert not tiled.im2_halo(_port(cfg.replace(mv_cap=None)), 0) < h // t
    assert tiled.im2_halo(_port(cfg), 0) < h // t
    want = _tiled_vs_jax(cfg, *_pair(rng, h, 64, dy=8, dx=-8, margin=16))
    assert (want[64:192, 24:40] == np.float32([8, -8])).all()


def test_estimate_flow_tiled_auto_equals_jax(rng):
    # tests/test_tiled.py::test_estimate_flow_tiled_auto: the derived cap and
    # the tile-aware padding, equal to JAX's untiled engine at that config
    cfg = MotionConfig(block_sizes=(4, 4, 4), search_sizes=(12, 12, 12), interp_factor=1,
                       regularizer="windowed")
    h, w, t = 250, 64, 8
    cap = tiled.derive_mv_cap(_port(cfg), h, w, t)
    assert cap is not None and cap == jtiled.derive_mv_cap(cfg, h, w, t)
    run_cfg = cfg.replace(mv_cap=cap)
    p = jpad.compute_padding(h, w, run_cfg, row_tiles=t)
    assert tiled.plan_tiling(_port(run_cfg), p.padded_h, p.padded_w, t)[0]["rows_ok"]
    im1, im2 = _pair(rng, h, w, dy=2, dx=-1)
    got = tiled.estimate_flow_tiled_auto(im1, im2, _port(cfg), _rows(t), device="cpu")
    assert tuple(got.shape) == (h, w, 2)
    want = np.asarray(jeng.estimate_flow_padded(
        np.pad(im1, ((p.pad_y,) * 2, (p.pad_x,) * 2)), np.pad(im2, ((p.pad_y,) * 2, (p.pad_x,) * 2)),
        run_cfg))[p.pad_y : p.pad_y + h, p.pad_x : p.pad_x + w]
    np.testing.assert_array_equal(got.numpy(), want)


def _two_motion(h, w, seed):
    """A pair whose halves move 20 px apart: the rival windows and the
    band's tail decide cells, strip edges included."""
    rng = np.random.default_rng(seed)
    tex = synth.textured_image(h + 64, w + 64, rng)
    a2 = tex[32 : 32 + h, 32 : 32 + w]
    left = tex[32 + 2 : 32 + 2 + h, 32 + 14 : 32 + 14 + w]
    right = tex[32 - 3 : 32 - 3 + h, 32 - 6 : 32 - 6 + w]
    a1 = np.where(np.arange(w)[None, :] < w // 2, left, right).astype(np.uint8)
    return np.ascontiguousarray(a1), np.ascontiguousarray(a2)


@pytest.mark.parametrize("override,step", [
    (dict(cv_store_radius=2), "color_round_hybrid_tail"),
    (dict(cv_fused=4), "color_round_fused_rival"),
], ids=["hybrid-band", "cv_fused"])
def test_capacity_forms_on_strips_equal_jax_untiled(monkeypatch, override, step):
    # the hybrid form with the stored band (F at cur 2) and cv_fused=4 with
    # rival windows (kernel 12 at cur 4 and 2) run on strips, their steps
    # on ghost rows; JAX's untiled XLA flow is the dense one both equal
    cfg = MotionConfig(block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
                       rival_radius=(4, None), **override)
    im1, im2 = _two_motion(128, 96, 5)
    calls = []
    rnd = getattr(rounds, step)
    plain = rnd.step

    def spy(*a, **k):
        calls.append(k["strips"] is not None)
        return plain(*a, **k)

    monkeypatch.setattr(rnd, "step", spy)
    assert [e["rows_ok"] for e in tiled.plan_tiling(_port(cfg), 128, 96, 2)] == [True, True]
    _tiled_vs_jax(cfg, im1, im2, t=2)
    assert calls and all(calls)


def test_batch_tiled_search_centred_equals_jax_untiled(rng):
    # tests/test_tiled.py::test_batch_tiled_combined_matches_untiled with
    # window_center="search": the search, then windowed_schedule, on strips
    from tests.test_torch_tiled_windowed import _batch_tiled_vs_jax

    _batch_tiled_vs_jax(rng, MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6),
                                          interp_factor=1, regularizer="windowed",
                                          window_center="search"))
