"""The plain reference: equal to the program's plain path at small sizes
on the CPU, and its control (energy in bfloat16) fails the check."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import gen, harness
from benchmark.reference import flow as reference

ROOT = Path(__file__).resolve().parents[2]


def _frames(h, w, seed, b=2):
    tr = harness.load_cell("default-interp4-640x480.clip-b8").traffic
    tr = dict(tr, batch=b, pool_requests=1, object_px=[h // 6, 2 * h // 5], pan_px=max(1, h // 30),
              object_motion_px=max(2, h // 14))
    f = gen.pool(tr, h, w, seed, "cpu")
    return f[:b], f[1:b + 1]


@pytest.mark.parametrize("over", [
    dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None), interp_factor=4,
         frame=(25, 37)),
    dict(block_sizes=(8, 8), search_sizes=(16, 24), window_center="search", interp_factor=3,
         frame=(28, 42)),
    dict(block_sizes=(16, 16, 16), search_sizes=(32, 32, 32)),
    dict(block_sizes=(16, 16, 16), search_sizes=(32, 32, 32), window_center="search"),
    dict(block_sizes=(8, 8), search_sizes=(16, 24), rival_radius=(2, None)),
    dict(block_sizes=(8, 16), search_sizes=(24, 40), cost="ssd", window_center="search",
         reg_radius=3),
    dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_window=False, mv_cap=8),
])
def test_reference_equals_the_programs_plain_path(over):
    from blockbasedmotionestimation_tpu_torch.config import MotionConfig
    from blockbasedmotionestimation_tpu_torch.models import engine

    over = dict(over)
    frame = over.pop("frame", (100, 150))
    cfg = MotionConfig(**dict(dict(interp_factor=1), **over))
    im1, im2 = _frames(*frame, 5)
    want = engine.estimate_flow_driver_batched(im1, im2, cfg, device="cpu")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    got = reference.estimate(im1, im2, fields)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert reference.mismatched_pixels(got, want) == 0
    assert torch.unique(want[..., 0]).numel() > 3  # the motion is not trivial


def test_the_devices_argument_changes_no_bit():
    """``devices`` (the cell's cards, handed by the harness) is accepted and
    does not change the reference's flow."""
    fields = harness.motion_fields(harness.load_cell("default-interp4-640x480.clip-b8").config)
    fields.update(block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None))
    im1, im2 = _frames(24, 32, 7)
    plain = reference.estimate(im1, im2, fields)
    for devices in ([torch.device("cpu")], [torch.device("cpu")] * 4):
        got = reference.estimate(im1, im2, fields, devices=devices)
        assert torch.equal(got, plain) and reference.mismatched_pixels(got, plain) == 0


@pytest.mark.parametrize("h,w,f", [(7, 9, 4), (24, 32, 4), (13, 5, 2), (30, 41, 3)])
def test_upscale_equals_the_programs_resize(h, w, f):
    from blockbasedmotionestimation_tpu_torch.ops import resample

    im = torch.randint(0, 256, (2, h, w), generator=torch.Generator().manual_seed(h * w),
                       dtype=torch.uint8)
    assert torch.equal(reference.upscale(im, f), resample.resize_scale_u8(im, f))


def test_reference_refuses_what_it_does_not_cover():
    fields = harness.motion_fields(harness.load_cell("default-interp4-640x480.clip-b8").config)
    for bad in (dict(cost="zsad"), dict(interp_factor=0), dict(regularizer="fourcolor"),
                dict(cv_compact=64)):
        with pytest.raises(ValueError):
            reference.Settings(dict(fields, **bad))


def test_mismatched_pixels_counts_nan_and_shape():
    a = torch.zeros(1, 4, 5, 2)
    b = a.clone()
    b[0, 1, 2, 0] = float("nan")
    b[0, 3, 3, 1] = 1.0
    assert reference.mismatched_pixels(a, a) == 0
    assert reference.mismatched_pixels(b, a) == 2
    assert reference.mismatched_pixels(a[:, :3], a) == 20


def test_control_fails_the_check(tiny_cell):
    """The control at a test's size: the reference with a bfloat16 energy
    differs from the float32 reference on every seed."""
    from benchmark import control

    cell = tiny_cell("default-interp4-640x480.clip-b8", check_fields=4)
    cell.config["motion_config"].update(block_sizes=[16, 16], search_sizes=[32, 32])
    cell.config["frame"] = {"height": 32, "width": 48}
    rows = control.readings(cell, [31, 32, 33], "cpu")
    assert [r["fields"] for r in rows] == [4, 4, 4]
    assert all(r["mismatched_px"] > 0 for r in rows), rows


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.flow; "
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', "
            "'flax', 'blockbasedmotionestimation_tpu', 'blockbasedmotionestimation_tpu_torch'));"
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
