"""Shared fixtures of the benchmark's CPU tests: a cell cut to a size the
CPU runs in a second, with the configuration's settings otherwise kept."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a few threads a test process: the tests run in several processes at once
torch.set_num_threads(2)


def tiny(cell, **traffic):
    """The cell at 24x32 frames (96x128 once upscaled), two levels of 8 px
    blocks, 16 px search."""
    cell.config = dict(
        cell.config, frame={"height": 24, "width": 32},
        motion_config=dict(cell.config["motion_config"], block_sizes=[8, 8],
                           search_sizes=[16, 16], rival_radius=[2, None]))
    cell.traffic = dict(cell.traffic, pool_requests=2, object_px=[6, 12], pan_px=1,
                        object_motion_px=2, **traffic)
    if cell.traffic["batch"] > 2:
        cell.traffic["batch"] = 2
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark import harness

    def make(name="default-interp4-640x480.clip-b8", **traffic):
        return tiny(harness.load_cell(name), **traffic)
    return make
