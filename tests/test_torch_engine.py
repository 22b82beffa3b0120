"""The port's entry points against the JAX engine, end to end on the CPU.

Tiny configurations (two 8px levels) on numpy pairs made from a seed;
exact equality of the flow fields.  Also: the port never imports jax, and
configurations outside the ported slice raise.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu.config import MotionConfig
from blockbasedmotionestimation_tpu.models import engine as jeng
from blockbasedmotionestimation_tpu.utils import synth
from blockbasedmotionestimation_tpu_torch.models import engine as teng

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


@pytest.mark.parametrize(
    "cfg",
    [TINY, TINY.replace(cost="ssd", mv_cap=16, rival_window=False)],
    ids=["sad-rival", "ssd-mv_cap-norival"],
)
def test_estimate_flow_batched_matches_jax(rng, cfg):
    im1s, im2s = _pairs(rng, 2, H, W)
    want, pw = jeng.estimate_flow_batched(im1s, im2s, cfg)
    got, pg = teng.estimate_flow_batched(im1s, im2s, cfg, device="cpu")
    assert pg == teng.pad_ops.Padding(**vars(pw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_estimate_flow_driver_interp2_matches_jax(rng):
    cfg = TINY.replace(interp_factor=2)
    im1s, im2s = _pairs(rng, 1, H // 2, W // 2)
    want = np.asarray(jeng.estimate_flow_driver(im1s[0], im2s[0], cfg))
    got = teng.estimate_flow_driver(torch.as_tensor(im1s[0]), torch.as_tensor(im2s[0]), cfg)
    assert tuple(got.shape) == (H // 2, W // 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-pair entry is the batched one at B = 1
    flow, _ = teng.estimate_flow(im1s[0], im2s[0], TINY, device="cpu")
    batched, _ = teng.estimate_flow_batched(im1s[:1], im2s[:1], TINY, device="cpu")
    assert torch.equal(flow, batched[0])


@pytest.mark.parametrize(
    "override",
    [
        dict(regularizer="fourcolor"),
        dict(window_center="search"),
        dict(search_order="raster"),
        dict(reg_radius=4),
        dict(cost="zsad"),
        dict(cv_fused=4),
        dict(cv_compact=8),
    ],
)
def test_configs_outside_the_slice_raise(override):
    frames = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.estimate_flow_batched(frames, frames, TINY.replace(**override), device="cpu")


def test_numpy_frames_need_a_device():
    frames = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="device"):
        teng.estimate_flow_batched(frames, frames, TINY)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises((RuntimeError, AssertionError)):
        teng.estimate_flow_batched(frames, frames, TINY, device="cuda")


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
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
        assert not bad, bad
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
