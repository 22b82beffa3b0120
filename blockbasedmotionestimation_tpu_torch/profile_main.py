"""Where the time of the 1080p main path goes, on one CUDA card.

    python -m blockbasedmotionestimation_tpu_torch.profile_main

Runs ``estimate_flow_batched`` with ``MotionConfig(interp_factor=1)`` on
seeded-noise 1080p pairs (frame 2 = frame 1 moved by (-5, -9), made as
``chip_smoke.py`` makes them) and prints, beside the card's name and power
limit:

  - wall time per batch over 10 batches of 8 (min, median, max), fields/s
    at the median, and the peak device memory;
  - wall time per pyramid level, each level synchronised before and after;
  - device time by kernel over one more batch (``torch.profiler``), the
    device total, and the device's idle share of the median batch.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch import MotionConfig
from blockbasedmotionestimation_tpu_torch.models import engine

H, W, B = 1080, 1920, 8
REPS = 10
TOP = 12  # kernels listed by device time
SHIFT_Y, SHIFT_X = 5, 9


def _kernel_us(evt) -> float:
    """Device time of a kernel event; 0 for host-side ops (an aten op's own
    device time is that of the kernels it launched, listed on their own)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = MotionConfig(interp_factor=1)
    noise = np.random.default_rng(0).integers(0, 256, size=(B, H + 16, W + 16), dtype=np.uint8)
    im1 = torch.as_tensor(noise[:, :H, :W].copy(), device=dev)
    im2 = torch.as_tensor(noise[:, SHIFT_Y:SHIFT_Y + H, SHIFT_X:SHIFT_X + W].copy(), device=dev)
    print(f"[profile] card: {card}; 1080p, B={B}, MotionConfig(interp_factor=1)")

    engine.estimate_flow_batched(im1, im2, cfg)  # warm: builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.estimate_flow_batched(im1, im2, cfg)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    med = float(np.median(batch_s))
    print(f"[profile] {REPS} batches: min {min(batch_s) * 1e3:.3f}, median {med * 1e3:.3f}, "
          f"max {max(batch_s) * 1e3:.3f} ms; {B / med:.3f} fields/s at the median; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")

    level_ms = []
    level_fn = engine.windowed_level

    def timed_level(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = level_fn(*a, **k)
        torch.cuda.synchronize()
        level_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.windowed_level = timed_level
    try:
        engine.estimate_flow_batched(im1, im2, cfg)
    finally:
        engine.windowed_level = level_fn
    levels = range(cfg.num_levels - 1, -1, -1)  # the engine runs coarsest first
    print("[profile] per level (ms, synchronised): "
          + ", ".join(f"level {lv} {ms:.3f}" for lv, ms in sorted(zip(levels, level_ms))))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.estimate_flow_batched(im1, im2, cfg)
        torch.cuda.synchronize()
    rows = sorted(
        ((_kernel_us(e), e.count, e.key) for e in prof.key_averages() if _kernel_us(e) > 0),
        reverse=True,
    )
    total_us = sum(r[0] for r in rows)
    print(f"[profile] device time of one batch: {total_us / 1e3:.3f} ms over {len(rows)} kernel "
          f"kinds; idle share of the median batch {1 - total_us / 1e3 / (med * 1e3):.4f}")
    for us, count, key in rows[:TOP]:
        print(f"[profile]   {us / 1e3:9.3f} ms {100 * us / total_us:6.2f}% x{count:<5d} {key[:90]}")
    rest = rows[TOP:]
    if rest:
        rest_us = sum(r[0] for r in rest)
        print(f"[profile]   {rest_us / 1e3:9.3f} ms {100 * rest_us / total_us:6.2f}% "
              f"the other {len(rest)} kernel kinds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
