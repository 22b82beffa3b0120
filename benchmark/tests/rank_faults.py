"""Entries for the rank tests (``test_bench_ranks.py``): the program's
data-parallel entry, ``parallel.tiled.estimate_flow_batch``, with a fault
planted on one rank (a field altered, a raise, a hang, a miscounted
launch), and its row-tiled entry with the exchanges between ranks left
out."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from blockbasedmotionestimation_tpu_torch.kernels import resample
from blockbasedmotionestimation_tpu_torch.models import engine
from blockbasedmotionestimation_tpu_torch.parallel import tiled

# the request on which a planted rank raises or hangs: the window's first
# (the cells' traffic warms up on two)
AT_CALL = 3
_calls = {"n": 0}


def _batch_with(fault, im1s, im2s, cfg, mesh, batch_axis="batch", device=None):
    """``estimate_flow_batch`` with ``fault(flow)`` applied to each chunk's
    flow where it is produced, before the gather."""
    driver = engine.estimate_flow_driver_batched

    def faulty(a, b, cfg, device=None):
        return fault(driver(a, b, cfg, device))
    engine.estimate_flow_driver_batched = faulty
    try:
        return tiled.estimate_flow_batch(im1s, im2s, cfg, mesh, batch_axis, device)
    finally:
        engine.estimate_flow_driver_batched = driver


def one_mv_moved_on_rank_2(im1s, im2s, cfg, mesh, batch_axis="batch", device=None):
    """One MV of the first field of rank 2's chunk moved by a quarter pixel."""
    def moved(flow):
        if dist.get_rank() == 2:
            flow[0, 10, 20, 0] += 0.25
        return flow
    return _batch_with(moved, im1s, im2s, cfg, mesh, batch_axis, device)


def _planted_on_rank_1(what: str):
    def entry(im1s, im2s, cfg, mesh, batch_axis="batch", device=None):
        _calls["n"] += 1
        if dist.get_rank() == 1 and _calls["n"] == AT_CALL:
            if what == "raises":
                raise RuntimeError("a fault planted on rank 1")
            time.sleep(3600)
        return tiled.estimate_flow_batch(im1s, im2s, cfg, mesh, batch_axis, device)
    entry.__name__ = f"{what}_on_rank_1"
    return entry


raises_on_rank_1 = _planted_on_rank_1("raises")
hangs_on_rank_1 = _planted_on_rank_1("hangs")


def miscounted_on_rank_1(im1s, im2s, cfg, mesh, batch_axis="batch", device=None):
    """``estimate_flow_batch`` whose pyrDown wrapper counts one launch a
    request more than it made on rank 1: that rank breaks the launch rule."""
    if dist.get_rank() == 1:
        resample.pyrdown_u8.launches += 1
    return tiled.estimate_flow_batch(im1s, im2s, cfg, mesh, batch_axis, device)


def padded_tiled_without_exchange(im1s, im2s, cfg, mesh, batch_axis="batch", axis="ty",
                                  axis_x=None, device=None):
    """``estimate_flow_padded_batch_tiled`` with every exchange between
    neighbouring tiles left out: each receives zeros."""
    swap = tiled.DistTiles._swap

    def none(self, axis, first, last):
        return torch.zeros_like(last), torch.zeros_like(first)
    tiled.DistTiles._swap = none
    try:
        return tiled.estimate_flow_padded_batch_tiled(im1s, im2s, cfg, mesh, batch_axis, axis,
                                                      axis_x, device)
    finally:
        tiled.DistTiles._swap = swap
