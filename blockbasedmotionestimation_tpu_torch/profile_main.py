"""Where the time of the 1080p main path goes, on one CUDA card.

    python -m blockbasedmotionestimation_tpu_torch.profile_main
    python -m blockbasedmotionestimation_tpu_torch.profile_main --regularizer fourcolor
    python -m blockbasedmotionestimation_tpu_torch.profile_main --window-center search
    python -m blockbasedmotionestimation_tpu_torch.profile_main --cv-fused 4
    python -m blockbasedmotionestimation_tpu_torch.profile_main --cv-compact 64 --no-rival
    python -m blockbasedmotionestimation_tpu_torch.profile_main --cost zsad
    python -m blockbasedmotionestimation_tpu_torch.profile_main --volume-launches
    python -m blockbasedmotionestimation_tpu_torch.profile_main --volume-stores
    python -m blockbasedmotionestimation_tpu_torch.profile_main --sass

Runs ``estimate_flow_batched`` with ``MotionConfig(interp_factor=1)`` (or
the regularizer / window centre / capacity mode / cost given; ``--no-rival``
sets ``rival_window=False``, which ``cv_compact`` needs to take effect) on
8 seeded-noise 1080p pairs (2 for zsad, whose dense f32 volumes take
about 6 GB a frame; frame 2
= frame 1 moved by (-5, -9), made as ``chip_smoke.py`` makes them) and
prints, beside the card's name and power limit:

  - wall time per batch over 10 batches (min, median, max), fields/s
    at the median, and the peak device memory;
  - wall time per pyramid level, each level synchronised before and after;
  - launches and device time of each kernel wrapper and of each stage of a
    level (the block search, the schedule) over one more batch (CUDA events
    around every call; B, C and 13 share one CUDA kernel, as do D, E, F,
    11 and 12, so only the wrappers tell them apart), and the host time per
    call of each (host clock around the call, which only enqueues);
  - device time by kernel over one more batch (``torch.profiler``), the
    device total, and the device's idle share of the median batch.

``--volume-launches`` instead times the volume kernel's calls at the 1080p
level-0 B=8 shapes (B with the band, C on the rival window, 13) at other
launch geometries than ``kernels/cv_diff.volume_geometry``'s: 1, 2, 4 or 8
parents a block with every delta row, and 1 parent at 3 or 1 rows.

``--volume-stores`` instead times B (``pooled_cvs``, one launch) at the
level-0 shapes of 640x480 frames upscaled 4x (B=8, 2048x2560, bs 32,
r 16) one emit set at a time: every size, {2}, {4}, {8}, {16, 32}, {2, 4},
{2, 8}, {2, 16, 32}, and the band (store_r 4), each beside the bytes it
writes and the sizes lane pairs store (``cv_diff.paired_curs``): the
sets with cur 2 share its diff loop, so their differences are the other
sizes' stores.

``--sass`` instead prints the instructions of kernel 7's innermost loop
(bs 32, sad and ssd: the loop over block rows, from a backward branch's
target to the branch) by opcode, from ``cuobjdump -sass`` of the built
library, and the pixel-deltas one pass of it scores.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch import MotionConfig
from blockbasedmotionestimation_tpu_torch.models import engine

H, W, B = 1080, 1920, 8
REPS = 10
TOP = 24  # kernels listed by device time
SHIFT_Y, SHIFT_X = 5, 9


def _kernel_us(evt) -> float:
    """Device time of a kernel event; 0 for host-side ops (an aten op's own
    device time is that of the kernels it launched, listed on their own)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0)))


@contextlib.contextmanager
def _timed_kernels(events: dict):
    """Wrap each kernel wrapper and each stage of a level so that every call
    records (start, end) CUDA events under the function's name."""
    from blockbasedmotionestimation_tpu_torch.kernels.rounds import FORMS
    from blockbasedmotionestimation_tpu_torch.ops import search, windowed

    names = {search: ["_gather", "_sad_argmin", "sad_spiral_argmin_plain"], windowed: [
        "pooled_cvs", "deep_pooled_cvs", "full_block_volume", "compact_tables",
        "chunk_delta_slots", "slot_map", *(f.round_name for f in FORMS.values()), "spiral_argmin",
        # zsad's plain volumes and rounds (no kernel computes zsad)
        "pooled_cvs_plain", "color_round_stored_plain"], engine: [
        "block_search_level", "run_schedule", "windowed_schedule", "windowed_level"]}
    saved = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}

    def timed(fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host_s = time.perf_counter() - t0
            end.record()
            events.setdefault(fn.__name__, []).append((start, end, host_s))
            return out
        call.per_round = getattr(fn, "per_round", False)
        call.form = getattr(fn, "form", fn.__name__)
        return call

    for (m, n), fn in saved.items():
        setattr(m, n, timed(fn))
    try:
        yield
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def _cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _volume_launches(cfg, dev, card: str) -> None:
    """--volume-launches: B (band), C (rival) and 13 at the level-0 shapes,
    each at the policy's launch and at fixed (parents, delta rows) ones."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff
    from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent

    pad = engine.pad_ops.compute_padding(H, W, cfg)
    bs = cfg.block_sizes[0]
    npy, npx = pad.padded_h // bs, pad.padded_w // bs
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 256, size=(B, pad.padded_h, pad.padded_w),
                                          dtype=np.uint8), device=dev)
    ext, r2 = spiral_extent(cfg.search_sizes[0] - bs), cfg.rival_radius_at(0)
    wins = {r: torch.as_tensor(rng.integers(0, 256, size=(B, npy * npx, bs + 2 * r, bs + 2 * r),
                                            dtype=np.uint8), device=dev) for r in (ext, r2)}
    calls = [
        ("B, band store_r=4", ext,
         lambda: cv_diff.pooled_cvs(frames, wins[ext], bs, ext, cfg.cost, store_r=4)),
        ("C, rival", r2, lambda: cv_diff.deep_pooled_cvs(frames, wins[r2], bs, r2, cfg.cost, 16)),
        ("13", ext, lambda: cv_diff.full_block_volume(frames, wins[ext], bs, ext, cfg.cost)),
    ]
    policy = cv_diff.volume_geometry
    for name, r, call in calls:
        side = 2 * r + 1
        times = [f"policy {_cuda_ms(call):.3f}"]
        for pp, dyg in ((1, side), (2, side), (4, side), (8, side), (1, 3), (1, 1)):
            cv_diff.volume_geometry = (
                lambda bs_, r_, b_, y_, x_, writes_fine, pp=pp, dyg=dyg:
                cv_diff.volume_launch(bs_, r_, b_, y_, x_, pp, dyg))
            try:
                times.append(f"({pp}, {dyg}) {_cuda_ms(call):.3f}")
            finally:
                cv_diff.volume_geometry = policy
        print(f"[volume] {name}, r={r}, B={B}, level 0: ms at (parents, delta rows) a block: "
              + "; ".join(times) + f" ({card})")


def _volume_stores(dev, card: str) -> None:
    """--volume-stores: B one emit set at a time at the level-0 shapes of
    640x480 frames upscaled 4x."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff

    b, h, w, bs, r = 8, 2048, 2560, 32, 16
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8), device=dev)
    wins = torch.as_tensor(rng.integers(0, 256, size=(b, (h // bs) * (w // bs), bs + 2 * r,
                                                      bs + 2 * r), dtype=np.uint8), device=dev)
    for emit, store_r in ((None, None), ([2], None), ([4], None), ([8], None), ([16, 32], None),
                          ([2, 4], None), ([2, 8], None), ([2, 16, 32], None), (None, 4)):
        out = cv_diff.pooled_cvs(frames, wins, bs, r, "sad", store_r=store_r, emit=emit)
        pp = cv_diff.volume_geometry(bs, r, b, h // bs, w // bs,
                                     bool({2, 4} & set(out))).parents_per_block
        gb = sum(t.nbytes for t in out.values()) / 1e9
        del out
        ms = _cuda_ms(lambda: cv_diff.pooled_cvs(frames, wins, bs, r, "sad", store_r=store_r,
                                                 emit=emit), reps=5)
        print(f"[stores] emit {emit or 'all'}, store_r {store_r}: {ms:.4f} ms, {gb:.3f} GB "
              f"written ({gb / 3.35:.4f} ms at 3.35 TB/s), {pp} parents a block, pairs store "
              f"{cv_diff.paired_curs(bs, 'sad', emit or cv_diff._curs(bs), pp)} ({card})")


def _sass_loops() -> None:
    """--sass: kernel 7's innermost loop (bs 32) by opcode, from cuobjdump;
    functions are matched on their names demangled by cu++filt.  Raises if
    either cost's kernel, or a loop of VABSDIFF4 in it, is not found."""
    from blockbasedmotionestimation_tpu_torch.kernels import _build

    bin_dir = Path(_build.nvcc_path()).parent
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    funcs = sass.split("Function : ")[1:]
    names = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(f.split()[0] for f in funcs),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    found = {}
    for name, text in zip(names, funcs):
        # cu++filt writes the arguments as <(int)32, (bool)1>, c++filt as <32, true>
        m = re.search(r"\bsad_spiral_argmin_kernel<(?:\(int\))?32, (?:\(bool\))?(true|false|1|0)>",
                      name)
        if m is not None:
            found["ssd" if m.group(1) in ("true", "1") else "sad"] = text
    if sorted(found) != ["sad", "ssd"]:
        seen = [n for n in names if "sad_spiral_argmin_kernel" in n]
        raise RuntimeError(f"--sass: sad_spiral_argmin_kernel<32, false/true> not found in "
                           f"the library (found {sorted(found)}; kernel 7's names: {seen})")
    for cost, text in sorted(found.items()):
        ins = [(int(a, 16), op, rest) for a, op, rest in
               re.findall(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", text)]
        loops = []  # (first, last) address of each backward branch's loop
        for at, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target is not None and int(target.group(1), 16) < at:
                loops.append((int(target.group(1), 16), at))
        bodies = [[o for a, o, _ in ins if lo <= a <= hi] for lo, hi in loops]
        bodies = [b for b in bodies if any(o.startswith("VABSDIFF4") for o in b)]
        if not bodies:
            raise RuntimeError(f"--sass: no loop of VABSDIFF4 in the {cost} kernel's "
                               f"{len(ins)} instructions")
        body = min(bodies, key=len)
        # a VABSDIFF4 (sad; with an IDP for ssd) scores 4 pixels of one dx
        n = 4 * sum(o.startswith("VABSDIFF4") for o in body)
        print(f"[sass] {cost}: {len(body)} instructions a pass, {n} pixel-deltas, "
              f"{len(body) / n:.3f} a pixel-delta: {dict(collections.Counter(body).most_common())}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # exact loops over wavefronts of blocks in Python: for small frames, not for 1080p
    ap.add_argument("--regularizer", default="windowed",
                    choices=["windowed", "fourcolor", "jacobi"])
    ap.add_argument("--window-center", default="pred", choices=["pred", "search"])
    ap.add_argument("--cv-fused", type=int, default=None, metavar="N")
    ap.add_argument("--cv-compact", type=int, default=None, metavar="K")
    ap.add_argument("--no-rival", action="store_true")
    ap.add_argument("--cost", default="sad", choices=["sad", "ssd", "zsad"])
    ap.add_argument("--volume-launches", action="store_true")
    ap.add_argument("--volume-stores", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = MotionConfig(interp_factor=1, regularizer=args.regularizer,
                       window_center=args.window_center, cv_fused=args.cv_fused,
                       cv_compact=args.cv_compact, rival_window=not args.no_rival,
                       cost=args.cost)
    b = 2 if args.cost == "zsad" else B
    noise = np.random.default_rng(0).integers(0, 256, size=(b, H + 16, W + 16), dtype=np.uint8)
    im1 = torch.as_tensor(noise[:, :H, :W].copy(), device=dev)
    im2 = torch.as_tensor(noise[:, SHIFT_Y:SHIFT_Y + H, SHIFT_X:SHIFT_X + W].copy(), device=dev)
    if args.volume_launches:
        _volume_launches(cfg, dev, card)
        return 0
    if args.volume_stores:
        _volume_stores(dev, card)
        return 0
    if args.sass:
        _sass_loops()
        return 0
    print(f"[profile] card: {card}; 1080p, B={b}, MotionConfig(interp_factor=1, "
          f"regularizer={cfg.regularizer!r}, window_center={cfg.window_center!r}, "
          f"rival_window={cfg.rival_window}, cv_fused={cfg.cv_fused}, "
          f"cv_compact={cfg.cv_compact}, cost={cfg.cost!r})")

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
          f"max {max(batch_s) * 1e3:.3f} ms; {b / med:.3f} fields/s at the median; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")

    level_ms = []
    level_fn = engine._run_level

    def timed_level(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = level_fn(*a, **k)
        torch.cuda.synchronize()
        level_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine._run_level = timed_level
    try:
        engine.estimate_flow_batched(im1, im2, cfg)
    finally:
        engine._run_level = level_fn
    levels = range(cfg.num_levels - 1, -1, -1)  # the engine runs coarsest first
    print("[profile] per level (ms, synchronised): "
          + ", ".join(f"level {lv} {ms:.3f}" for lv, ms in sorted(zip(levels, level_ms))))

    events: dict = {}
    with _timed_kernels(events):
        engine.estimate_flow_batched(im1, im2, cfg)
    torch.cuda.synchronize()
    for name, evs in events.items():
        ms = sum(s.elapsed_time(e) for s, e, _ in evs)
        host_us = sum(h for _, _, h in evs) / len(evs) * 1e6
        print(f"[profile] {name}: {len(evs)} calls, {ms:.3f} ms (CUDA events, one batch); "
              f"host {host_us:.1f} us per call")

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
