"""The port's ``utils`` (flowio, synth, visualize, native_io) against the JAX
package's, on the same seeded inputs: equal bytes, arrays and numbers."""

import os

import numpy as np
import pytest

from blockbasedmotionestimation_tpu.utils import flowio as jflowio
from blockbasedmotionestimation_tpu.utils import native_io as jnative
from blockbasedmotionestimation_tpu.utils import synth as jsynth
from blockbasedmotionestimation_tpu.utils import visualize as jvis
from blockbasedmotionestimation_tpu_torch.utils import flowio, native_io, synth, visualize


def _flow(rng, h=24, w=32):
    flow = (rng.standard_normal((h, w, 2)) * 6).astype(np.float32)
    flow[3, 4] = (1e10, 0.0)   # unknown: |u| > 1e9
    flow[5, 6, 1] = np.nan     # unknown: NaN
    return flow


def test_write_flo_bytes_equal_and_read_round_trips(tmp_path, rng):
    flow = _flow(rng)
    mine, theirs = tmp_path / "mine.flo", tmp_path / "theirs.flo"
    flowio.write_flo(mine, flow)
    jflowio.write_flo(theirs, flow)
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(flowio.read_flo(mine), flow)
    np.testing.assert_array_equal(flowio.read_flo(theirs), jflowio.read_flo(mine))
    bad = tmp_path / "bad.flo"
    bad.write_bytes(mine.read_bytes()[:-4])
    with pytest.raises(flowio.FlowIOError):
        flowio.read_flo(bad)


def test_colour_epe_and_masks_equal_jax(rng):
    flow, gt = _flow(rng), _flow(rng)
    np.testing.assert_array_equal(flowio.unknown_flow_mask(flow), jflowio.unknown_flow_mask(flow))
    assert flowio.unknown_flow_mask(flow).sum() == 2
    for kw in (dict(), dict(max_motion=4.0)):
        np.testing.assert_array_equal(flowio.flow_to_color(flow, **kw),
                                      jflowio.flow_to_color(flow, **kw))
    np.testing.assert_array_equal(flowio.make_colorwheel(), jflowio.make_colorwheel())
    for rng_px in (3, 10):
        np.testing.assert_array_equal(flowio.color_legend(rng_px), jflowio.color_legend(rng_px))
    assert flowio.average_epe(gt, flow) == jflowio.average_epe(gt, flow)
    assert flowio.calculate_mse is flowio.average_epe


def test_synth_equals_jax():
    def both(fn_name, *args, **kw):
        a = getattr(synth, fn_name)(*args, np.random.default_rng(9), **kw)
        b = getattr(jsynth, fn_name)(*args, np.random.default_rng(9), **kw)
        return a, b

    a, b = both("textured_image", 40, 56)
    np.testing.assert_array_equal(a, b)
    gt = _flow(np.random.default_rng(2), 40, 56)
    np.testing.assert_array_equal(synth.warp_backward(a, gt), jsynth.warp_backward(a, gt))
    for got, want in zip(*both("pair_from_gt", gt)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(*both("pair_from_gt_photometric", gt, gain=1.1, offset=12.0,
                               noise_sigma=2.0, occlusion_fill=True)):
        np.testing.assert_array_equal(got, want)
    got, want = both("perturb_photometric", a, gain=0.9, offset=-10.0, noise_sigma=1.5)
    np.testing.assert_array_equal(got, want)


def test_visualize_equals_jax(tmp_path, rng):
    im1 = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    im2 = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    flow = np.rint(rng.standard_normal((24, 32, 2)) * 3).astype(np.float32)
    visualize.dump_flow_text(flow, tmp_path / "mine.txt")
    jvis.dump_flow_text(flow, tmp_path / "theirs.txt")
    assert (tmp_path / "mine.txt").read_bytes() == (tmp_path / "theirs.txt").read_bytes()
    np.testing.assert_array_equal(visualize.draw_mv_overlay(im1, flow, 8),
                                  jvis.draw_mv_overlay(im1, flow, 8))
    np.testing.assert_array_equal(visualize.motion_compensate(im2, flow, 4),
                                  jvis.motion_compensate(im2, flow, 4))
    assert visualize.compensation_error(im1, im2, flow) == jvis.compensation_error(im1, im2, flow)


def test_image_io_equals_jax(tmp_path, rng):
    # read_gray / write_image through whichever codec this machine has
    # (OpenCV, else the native codec, else PIL), in both packages
    gray = rng.integers(0, 256, size=(20, 28), dtype=np.uint8)
    rgb = rng.integers(0, 256, size=(20, 28, 3), dtype=np.uint8)
    for name, img in (("g.png", gray), ("c.png", rgb), ("g.pgm", gray)):
        mine, theirs = tmp_path / f"mine_{name}", tmp_path / f"theirs_{name}"
        flowio.write_image(mine, img)
        jflowio.write_image(theirs, img)
        assert mine.read_bytes() == theirs.read_bytes(), name
        np.testing.assert_array_equal(flowio.read_gray(mine), jflowio.read_gray(theirs))
    np.testing.assert_array_equal(flowio.read_gray(tmp_path / "mine_g.png"), gray)


@pytest.fixture
def native():
    # the JAX package's tests/test_native_io.py skips exactly when its
    # library does not build; the port's must build wherever that one does
    if not jnative.available():
        pytest.skip("native library failed to build")
    assert native_io.available(), "the port's native library did not build"
    return native_io


def test_native_flo_and_pgm_equal_jax(tmp_path, rng, native):
    flow = _flow(rng)
    native.write_flo(tmp_path / "n.flo", flow)
    jnative.write_flo(tmp_path / "j.flo", flow)
    assert (tmp_path / "n.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(native.read_flo(tmp_path / "j.flo"), flow)
    paths = [tmp_path / "n.flo", tmp_path / "j.flo"]
    np.testing.assert_array_equal(native.read_flo_batch(paths, nthreads=2), np.stack([flow] * 2))
    with pytest.raises(native.NativeIOError):
        native.read_flo(tmp_path / "missing.flo")
    img = rng.integers(0, 256, size=(17, 23), dtype=np.uint8)
    native.write_pgm(tmp_path / "n.pgm", img)
    jnative.write_pgm(tmp_path / "j.pgm", img)
    assert (tmp_path / "n.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    np.testing.assert_array_equal(native.read_pgm(tmp_path / "j.pgm"), img)
    gt = _flow(rng)
    assert native.average_epe(gt, flow) == jnative.average_epe(gt, flow)


@pytest.mark.parametrize("shape", [(13, 21), (13, 21, 3), (13, 21, 4)])
def test_native_png_and_tga_equal_jax(tmp_path, rng, native, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    for ext, write, jwrite, read in (
        ("png", native.write_png, jnative.write_png, native.read_png),
        ("tga", native.write_tga, jnative.write_tga, native.read_tga),
    ):
        mine, theirs = tmp_path / f"n.{ext}", tmp_path / f"j.{ext}"
        write(mine, img)
        jwrite(theirs, img)
        assert mine.read_bytes() == theirs.read_bytes(), ext
        np.testing.assert_array_equal(read(theirs), img)
    assert native.png_dims(tmp_path / "n.png") == jnative.png_dims(tmp_path / "j.png")


def test_native_library_builds_beside_its_sources(native):
    here = os.path.dirname(os.path.dirname(native.__file__))
    assert os.path.dirname(native._SO_PATH) == os.path.join(here, "native")
    assert os.path.exists(native._SO_PATH)
    assert native.build()  # already built: nothing to do
