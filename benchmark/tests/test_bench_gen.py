"""The traffic generator: deterministic per seed, different across seeds,
the same sizes for every seed."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import gen

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("mix", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_pool_is_a_function_of_the_seed(mix):
    tr = dict(json.loads((TRAFFIC / f"{mix}.json").read_text()), pool_requests=2)
    seed = 2**40 + 12345  # wider than 32 signed bits
    a = gen.pool(tr, 72, 96, seed, "cpu")
    b = gen.pool(tr, 72, 96, seed, "cpu")
    c = gen.pool(tr, 72, 96, seed + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2 * tr["batch"] + 1, 72, 96)
    assert torch.equal(a, b)
    assert c.shape == a.shape and not torch.equal(a, c)
    # consecutive frames differ (motion and noise) and use the grey range
    assert not torch.equal(a[0], a[1])
    assert int(a.max()) - int(a.min()) > 128


def test_objects_move_against_the_background():
    tr = dict(json.loads((TRAFFIC / "clip-b8.json").read_text()), noise_sigma=0.0,
              objects=[1, 1], object_px=[24, 24], pan_px=0, object_motion_px=4)
    frames = gen.clip(tr, 64, 80, 6, 7, "cpu")
    moved = (frames[1:] != frames[:-1]).any(0)
    # a static background: only the object's old and new places change
    assert 0 < int(moved.sum()) < 64 * 80 // 2
