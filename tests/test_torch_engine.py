"""The port's entry points against the JAX engine, end to end on the CPU.

Tiny configurations (two 8px levels) on numpy pairs made from a seed;
exact equality of the flow fields.  The port gets its own ``MotionConfig``,
made from the JAX config's fields.  Also: the port never imports jax or the
JAX package, its config and spiral tables equal the JAX package's, numpy
frames go to CUDA by default, and the configurations that raised before
``cost="zsad"`` was ported now run (``tests/test_torch_zsad.py`` holds them
to JAX).  The capacity modes (``cv_fused``,
``cv_compact``) are held to JAX's dense flow, which JAX's own tests hold its
fused and (non-overflowing) compact paths to; their kernels are held to
JAX's interpret-mode kernels in ``tests/test_torch_capacity.py``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several pytest-xdist workers at once,
# and OpenMP threads that outnumber the cores slow every worker
torch.set_num_threads(1)

import dataclasses

from blockbasedmotionestimation_tpu import config as jconfig
from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu.models import engine as jeng
from blockbasedmotionestimation_tpu.ops import spiral as jspiral
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import engine as teng
from blockbasedmotionestimation_tpu_torch.ops import spiral as tspiral

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 80x112 frames: level 1 is 40x56, i.e. a 5x7 (odd) parent grid at bs 8
H, W = 80, 112
TINY = MotionConfig(
    block_sizes=(8, 8), search_sizes=(24, 24), interp_factor=1,
    rival_radius=(4, None),
)


def _pairs(rng, b, h, w):
    """b two-motion pairs (left/right halves move differently)."""
    im1s, im2s = [], []
    for k in range(b):
        tex = synth.textured_image(h + 64, w + 64, rng)
        (ul, vl), (ur, vr) = ((11, -3), (-4, 2)) if k % 2 == 0 else ((-2, 5), (9, 0))
        a = tex[32 + vl : 32 + vl + h, 32 + ul : 32 + ul + w]
        c = tex[32 + vr : 32 + vr + h, 32 + ur : 32 + ur + w]
        im1s.append(np.where(np.arange(w)[None, :] < w // 2, a, c).astype(np.uint8))
        im2s.append(tex[32 : 32 + h, 32 : 32 + w])
    return np.stack(im1s), np.stack(im2s)


def _port(cfg: MotionConfig) -> tconfig.MotionConfig:
    return tconfig.MotionConfig.from_fields(vars(cfg))


@pytest.mark.parametrize(
    "cfg",
    [
        TINY,
        TINY.replace(cost="ssd", mv_cap=16, rival_window=False),
        # the hybrid form with the stored band: C, E and F's plain versions
        jconfig.tiny_config(block_sizes=(8, 8), search_sizes=(24, 24), cv_store_radius=2),
        # search then regularize: kernel 7's plain version, then a schedule
        TINY.replace(regularizer="fourcolor"),
        TINY.replace(window_center="search"),
        TINY.replace(search_order="raster"),
        TINY.replace(reg_radius=4),
    ],
    ids=["sad-rival", "ssd-mv_cap-norival", "hybrid-band", "fourcolor", "search-rival",
         "raster-windowed", "pred-reg_radius4"],
)
def test_estimate_flow_batched_matches_jax(rng, cfg):
    im1s, im2s = _pairs(rng, 2, H, W)
    want, pw = jeng.estimate_flow_batched(im1s, im2s, cfg.replace(search_impl="xla"))
    got, pg = teng.estimate_flow_batched(im1s, im2s, _port(cfg), device="cpu")
    assert pg == teng.pad_ops.Padding(**vars(pw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# each port configuration against the JAX configuration of the test above
# whose program it shares (jax.jit hits its cache): JAX's XLA path ignores
# the capacity modes and gives the dense flow
NORIVAL = TINY.replace(cost="ssd", mv_cap=16, rival_window=False)


@pytest.mark.parametrize(
    "jax_cfg,override",
    [
        (TINY, dict(cv_fused=4)),
        (NORIVAL, dict(cv_fused=4)),
        (NORIVAL, dict(cv_compact=64)),
        (TINY, dict(cv_compact=8)),  # rival windows: compact does nothing
        (TINY.replace(window_center="search"), dict(cv_fused=4)),  # search first: ignored
    ],
    ids=["fused-rival", "fused-norival", "compact64-norival", "compact8-rival-ignored",
         "fused-search-ignored"],
)
def test_capacity_modes_match_jax_dense(rng, monkeypatch, jax_cfg, override):
    from blockbasedmotionestimation_tpu_torch.ops import compact
    from blockbasedmotionestimation_tpu_torch.ops import windowed as tw

    overflow = []
    slots = tw.chunk_delta_slots

    def spy(winners, base, r, k, ring):
        overflow.append(compact.overflow_fraction(winners, base, r, k, ring))
        return slots(winners, base, r, k, ring)

    monkeypatch.setattr(tw, "chunk_delta_slots", spy)
    im1s, im2s = _pairs(rng, 2, H, W)
    want, _ = jeng.estimate_flow_batched(im1s, im2s, jax_cfg.replace(search_impl="xla"))
    got, _ = teng.estimate_flow_batched(im1s, im2s, _port(jax_cfg).replace(**override),
                                        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    compacts = "cv_compact" in override and not jax_cfg.rival_window
    assert len(overflow) == (2 if compacts else 0)  # both levels, when it applies
    assert all(float(o.max()) == 0.0 for o in overflow)


def test_estimate_flow_driver_interp2_matches_jax(rng):
    cfg = TINY.replace(interp_factor=2)
    im1s, im2s = _pairs(rng, 1, H // 2, W // 2)
    want = np.asarray(jeng.estimate_flow_driver(im1s[0], im2s[0], cfg))
    got = teng.estimate_flow_driver(torch.as_tensor(im1s[0]), torch.as_tensor(im2s[0]), _port(cfg))
    assert tuple(got.shape) == (H // 2, W // 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-pair entry is the batched one at B = 1
    flow, _ = teng.estimate_flow(im1s[0], im2s[0], _port(TINY), device="cpu")
    batched, _ = teng.estimate_flow_batched(im1s[:1], im2s[:1], _port(TINY), device="cpu")
    assert torch.equal(flow, batched[0])


@pytest.mark.parametrize(
    "override",
    [
        dict(cost="zsad", regularizer="fourcolor"),
        dict(cost="zsad", window_center="search"),
        dict(cost="zsad", search_order="raster"),
        dict(cost="zsad", reg_radius=4),
        dict(cost="zsad"),
        dict(cost="zsad", regularizer="exact"),
        dict(cost="zsad", cv_fused=4),
    ],
)
def test_configs_outside_the_slice_raise(override):
    # no configuration is outside the port any more: each of these raised
    # before zsad was ported, and now runs (on the plain versions, on any
    # device, so no kernel limit refuses it on the card); equal frames of
    # one grey level cost 0 at every delta, so the flow is 0
    cfg = _port(TINY).replace(**override)
    teng.check_config(cfg, "cuda")
    frames = np.full((1, 16, 16), 90, np.uint8)
    flow, _ = teng.estimate_flow_batched(frames, frames, cfg, device="cpu")
    assert flow.dtype == torch.float32 and not flow.any()


_BIG = dict(interp_factor=1, block_sizes=(128,), search_sizes=(160,))


@pytest.mark.parametrize(
    "fields,refused",
    [
        (dict(interp_factor=1), None),  # the default, every level
        (_BIG, None),  # bs 128: the volume kernel's bs-128 instance
        (dict(_BIG, search_sizes=(128 + 2 * 105,)), None),  # its widest window
        (dict(_BIG, search_sizes=(128 + 2 * 106,)), "the volume kernel needs"),
        (dict(_BIG, block_sizes=(256,), search_sizes=(288,)), "built for bs 2 .. 128"),
        (dict(_BIG, search_sizes=(128 + 2 * 168,), regularizer="fourcolor"), None),
        (dict(_BIG, search_sizes=(128 + 2 * 170,), regularizer="fourcolor"), "kernel 7's window"),
        (dict(_BIG, search_sizes=(128 + 2 * 170,), regularizer="fourcolor",
              search_order="raster"), None),  # the raster search is plain torch
        (dict(_BIG, block_sizes=(64,), search_sizes=(64 + 416,), cv_compact=64,
              rival_window=False), None),  # kernel 14's widest window at bs 64 (S 208)
        (dict(_BIG, block_sizes=(64,), search_sizes=(64 + 418,), cv_compact=64,
              rival_window=False), "kernel 14 needs"),
        (dict(_BIG, block_sizes=(64,), search_sizes=(64 + 420,), cv_compact=64,
              rival_window=False, search_impl="xla"), None),  # xla: no compact tables
    ],
    ids=["default", "bs128", "bs128-widest", "bs128-too-wide", "bs256", "k7-widest", "k7-too-wide",
         "raster", "k14-widest", "k14-too-wide", "k14-xla"],
)
def test_cuda_refusals_name_the_shapes_no_kernel_takes(fields, refused):
    # check_config refuses, before any work and only on a CUDA device, the
    # level shapes no kernel can take; the CPU's plain versions take any
    cfg = tconfig.MotionConfig(**fields)
    out = teng.cuda_refusals(cfg)
    teng.check_config(cfg, "cpu")
    if refused is None:
        assert out == []
        teng.check_config(cfg, "cuda")
        return
    assert len(out) == 1 and refused in out[0] and out[0].startswith("level 0 (bs=")
    with pytest.raises(ValueError, match="no CUDA kernel of the port takes level 0"):
        teng.check_config(cfg, torch.device("cuda", 0))


def test_numpy_frames_need_a_device():
    # numpy frames without device= go to CUDA: here, with no CUDA, that
    # raises; it never runs on the CPU and returns
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = np.zeros((1, 16, 16), np.uint8)
    for entry in (teng.estimate_flow_batched, teng.estimate_flow_driver_batched):
        with pytest.raises((RuntimeError, AssertionError)):
            entry(frames, frames, _port(TINY))
    with pytest.raises((RuntimeError, AssertionError)):
        teng.estimate_flow(frames[0], frames[0], _port(TINY))
    # a tensor keeps its own device
    flow, _ = teng.estimate_flow_batched(torch.as_tensor(frames), torch.as_tensor(frames), _port(TINY))
    assert flow.device.type == "cpu"


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        teng.estimate_flow_batched(frames, frames, _port(TINY), device="cuda")


def test_config_matches_jax_config():
    # the port's own copy: same fields, same defaults, same checks
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.MotionConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.MotionConfig)]
    assert tf == jf
    for name in ("middlebury_config", "tiny_config"):
        assert vars(getattr(tconfig, name)()) == vars(getattr(jconfig, name)())
    cfg = jconfig.MotionConfig(block_sizes=(16, 8), search_sizes=(48, 24), rival_radius=4)
    port = _port(cfg)
    assert vars(port) == vars(cfg)
    for level in range(2):
        assert port.rival_radius_at(level) == cfg.rival_radius_at(level)
        assert port.shift(level) == cfg.shift(level)
    assert port.uses_fused_windowed == cfg.uses_fused_windowed
    with pytest.raises(ValueError, match="unknown"):
        tconfig.MotionConfig.from_fields({"block_size": 8})


@pytest.mark.parametrize(
    "bad",
    [
        dict(block_sizes=(8,), search_sizes=(16, 16)),
        dict(block_sizes=(), search_sizes=()),
        dict(block_sizes=(6,), search_sizes=(16,)),
        dict(block_sizes=(16,), search_sizes=(8,)),
        dict(interp_factor=0),
        dict(rival_radius=()),
        dict(rival_radius=(4, -1)),
        dict(rival_radius=-2),
        dict(cv_store_radius=-1),
        dict(cv_fused=1),
        dict(cv_fused=4, cv_compact=8),
        dict(mv_cap=3),
    ],
)
def test_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as want:
        jconfig.MotionConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfig.MotionConfig(**bad)
    assert str(got.value) == str(want.value)


def test_spiral_tables_match_jax():
    for shift in range(1, 49):
        dys, dxs, ext = tspiral.spiral_offsets(shift)
        jdys, jdxs, jext = jspiral.spiral_offsets(shift)
        assert ext == jext == tspiral.spiral_extent(shift)
        np.testing.assert_array_equal(dys, jdys)
        np.testing.assert_array_equal(dxs, jdxs)
        np.testing.assert_array_equal(tspiral.spiral_rank(shift), jspiral.spiral_rank(shift))
        assert tspiral.spiral_visits(shift) == jspiral.spiral_visits(shift)


def test_port_never_imports_jax():
    # a fresh interpreter: import the port and run its tiny main path
    code = textwrap.dedent(
        """
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import blockbasedmotionestimation_tpu_torch as port
        # every module of the port, and the GPU smoke script
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(mod.name)
        importlib.import_module("chip_smoke")
        from blockbasedmotionestimation_tpu_torch.models import engine
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, size=(1, 48, 64), dtype=np.uint8)
        cfg = port.tiny_config(rival_radius=2)
        flow, _ = engine.estimate_flow_batched(a, np.roll(a, 2, axis=2), cfg, device="cpu")
        assert flow.shape == (1, 48, 64, 2)
        # the row tiling and the multi-process runtime, run too
        from blockbasedmotionestimation_tpu_torch.parallel import multihost, tiled
        assert multihost.describe()["process_count"] == 1
        assert multihost.make_mesh().shape == {"batch": 1, "ty": 1}
        b = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
        rows = tiled.estimate_flow_padded_tiled(b, np.roll(b, 1, axis=0), cfg,
                                                tiled.Mesh((1, 2)), device="cpu")
        assert rows.shape == (64, 64, 2)
        # the oracle and the work models, run too
        from blockbasedmotionestimation_tpu_torch.models import oracle
        from blockbasedmotionestimation_tpu_torch.utils import profiling
        ex = port.MotionConfig(block_sizes=(4,), search_sizes=(8,), interp_factor=1,
                               regularizer="exact")
        o = oracle.calc_motion_block_matching(b[:16, :16].copy(), b[1:17, :16].copy(), ex)
        assert o.shape == (16, 16, 2)
        prev = profiling.spans(True)
        with profiling.span("model"):
            roof = profiling.windowed_pipeline_roofline(port.MotionConfig(), 1280, 2048)
        profiling.spans(prev)
        assert roof["total_floor_s"] > 0 and profiling.counters()["requests"] >= 2
        assert profiling.windowed_pipeline_floor(port.MotionConfig(), 1280, 2048)["floor_s"] > 0
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not bad, bad
        # nor any module of the JAX package, jax-free ones included
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "blockbasedmotionestimation_tpu")
        assert not ref, ref
        print("jax-free")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "jax-free" in out.stdout
