"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels compiled from ``csrc/`` with nvcc, one process
     per source, all at once;
  3. each kernel against its plain PyTorch version on the same CUDA inputs,
     at the shapes of the 1080p level 0 at B=8, exact equality, with the
     kernel's and the plain version's times and the kernel's bound: A (main
     and rival windows, beside its yardstick, one PyTorch indexing call),
     B (the stored band at store_r 4, then the dense
     volumes of the dense-rival form), C (rival; main at cv_fused=4), 13
     (cur = bs alone), D, D', 8 and 9 (the round kernel's stored form with
     and without rival, cur 32 and 2), E (cur 4 and 16) and F (cur 2), 11
     and 12 (cur 2 and 4), on
     random candidates within +-20 of the window centres, each as one colour
     step and as a whole round (one cooperative launch: 2 sweeps x 4
     colours, against the plain step loop); 14 and 10 (cur 2
     and 16, a colour step and a whole round, the round kernel's compact
     form) at K=64 on slot lists with unused (-1) slots and candidates
     within +-3, many of which miss every slot (14 with sad and ssd);
     kernel 7 (the spiral search's argmin, sad and ssd) around predictions
     within +-48 px; the volume kernel (B, C) over a sweep of shapes (bs
     8/16/32, r 0/3/12/16, sad and ssd, band on and off, C's sizes) and
     kernel 14 over another (bs 4..128, r 4/5, K 1/8/64/side^2, sad and
     ssd); then B and C timed at every level's shapes of the default path
     (its calls recorded on one batch), and 14 at every level's shapes of
     the cv_compact=64 path beside its bound, with their per-batch sums, A's
     8 calls of that batch each timed
     alone beside its yardstick, and D's, E's and F's rounds of that batch
     (candidates from real search winners) against the plain step loop, each
     round timed alone, with their per-batch sums and level-0 single steps;
     then the resample kernels (the upscale and pyrDown, which replace no
     TPU kernel) against their plain versions: the 4x upscale of B=8 1080p
     and 640x480 frames and each pyrDown of their padded pyramids, timed
     beside the plain version and the bound, and summed a batch;
  4. the main path: ``estimate_flow_batched`` with ``MotionConfig(
     interp_factor=1)`` on 8 seeded-noise 1080p pairs, counting every
     kernel's launches (7, 11-14 and 10: none) and checking the known
     translation; fields/s and peak memory; every frame also through the
     plain versions;
  4b. a two-motion B=8 batch at 1080p: the rival windows decide pixels, the
     band (cv_store_radius=4) gives the flow of cv_store_radius=None, the
     hybrid form the flow of the dense-rival form and cv_fused=4 the flow of
     the default, and every frame equals the plain path on the card;
  4c. the same pairs as 4 through ``regularizer="fourcolor"``: the spiral
     search (A, kernel 7), then the plain colour steps; level 3 is a 5x8
     grid, so the odd-grid schedule runs at full width;
  4d. the same pairs through ``window_center="search"``: the search, then
     windows around its winners (A), their dense volumes (B) and the rounds
     on them (D, rival on);
  4e. the same pairs through ``cv_fused=4`` (C for both windows, D, kernel
     12): the default's flow;
  4f. ``cv_fused=4, rival_window=False`` (C, D as 8 and 9, kernel 11): the
     rival-off default's flow;
  4g. ``cv_compact=64, rival_window=False`` (13, 14, D as 8, kernel 10, a
     launch a round each):
     overflow_fraction per level, and the rival-off default's flow where no
     chunk overflows; then ``cv_compact=1089`` (every delta of the window:
     no chunk overflows) at ring 3, and with a ring spanning the frame,
     which must give that flow;
  5. CUDA equals the CPU (plain) path bit for bit on a two-motion pair at
     the default configuration and at the search-then-regularize ones
     (fourcolor, jacobi, fourcolor with ssd, search-centred windows with
     reg_radius 8, raster search under fourcolor and under windowed; exact
     on a 64x96 pair) and the capacity modes (cv_fused=4 with and without
     rival windows, cv_compact=64 and cv_compact=4 without, the last with
     overflowing chunks);
  6. ``estimate_flow_driver`` with ``interp_factor=4`` at 388x584.
  7. ``cost="zsad"`` (``MotionConfig(interp_factor=1, cost="zsad")``) at
     1080p, B=2, on seeded texture pairs moved by (5, 9), frame 1 through
     a gain of 1.1 and an offset of 12: zsad has no kernel, so the gathers
     (A, 8 a batch) must be the only launches; the interior recovers the
     known flow; the median of 3 batches in fields/s and the peak memory;
     then CUDA equals the CPU on a two-motion 256x384 pair for the
     default, fourcolor and search-centred zsad configurations;
  8. the sequence runner and the CLI on six seeded 1080p frames of a
     texture moving by (5, 9) a frame, ``MotionConfig(interp_factor=1)``,
     in a temporary directory: ``run_sequence`` at batch 1 and at batch 4
     with ``out_stride=2`` and f16 downloads, each ``.flo`` equal to
     ``estimate_flow_driver`` on its pair (strided), a second run resuming
     every pair, pairs/s beside phase 4's fields/s and beside the engine
     alone; then ``cli.main``'s ``estimate`` on two PNG frames equals the
     driver, and ``evaluate`` returns 0; the runner and the CLI launch A-F
     as phase 4 does, a batch's worth a call (counted from 0 around each);
  9. the row tiling (``parallel.tiled``, the in-process transport: a
     frame's strips stacked on the batch axis, every colour step of a tiled
     round one launch for all strips, the ghost rows exchanged between
     steps) at 1080x1920: the default config on phase 4's B=8 pairs on 2
     row tiles (levels 0-2 shard, level 3 runs whole-frame; each level's
     rows_ok printed) equals the untiled flow bit for bit, with its launches
     counted from 0 (D, E and F as single steps: 8 a round) beside the
     untiled batch's, and its fields/s and idle share (torch.profiler device
     time over the median batch) beside the untiled batch's and phase 4's;
     the two-motion pairs of 4b on 2 tiles; ``estimate_flow_tiled_auto`` on
     4 row tiles (a derived ``mv_cap``) equal to the untiled engine at that
     cap (2 pairs); fourcolor, search-centred and cv_fused=4 on 2 tiles at
     B=2 (``B9``) equal to untiled, launches counted, each timed beside its
     untiled batch (and the auto pair beside its untiled run); then one colour step
     of D, E and F and kernel 7 on those strips (strips starting on odd
     frame rows) against their plain versions, timed beside them.  Then the
     2-D tiling on a (ty=2, tx=2) mesh (the ghost rows and the ghost
     columns with their corners exchanged between steps): the default on
     phase 4's B=8 pairs (levels 0-2 on 2-D tiles, level 3 whole-frame; each
     level's rows_ok / cols_ok printed) equal to untiled, its launches
     counted from 0 as written down before the run (8 single steps a round
     on the 3 tiled levels), its fields/s and idle share beside the untiled
     batch's; the two-motion pairs; ``estimate_flow_tiled_auto`` with
     ``axis_x`` (2 pairs, no cap needed); fourcolor, search-centred and
     cv_fused=4 at B=2, each equal to untiled with its launches counted;
     and one colour step of D, E, F and 12 and kernel 7 on 2-D tiles whose
     first row and column are odd, against their plain versions, timed
     beside them (rows D, E, F, 12 and 7 of the JSON line gain
     ``tiles2d_*`` keys);
 10. (a) the CUDA engine against the port's own NumPy/OpenCV oracle
     (``models/oracle.py``, a sequential re-derivation of the reference
     program that shares no code with the engine), bit for bit:
     ``regularizer="exact"`` at the four configurations of
     ``tests/test_engine.py``'s engine-vs-oracle test and its raster one on
     32x48 pairs (``estimate_flow_padded``), the driver at interp 2 on a
     20x26 pair, and the reference's structure (4 levels of 32 px blocks,
     64 px search, interp 2) on 192x224 frames, padded to 512x512, the
     least size at which level 3 keeps a 2x2 block grid; the oracle runs in
     worker processes while the engine runs on the card, each case's oracle
     and port seconds printed, its launches counted from 0 (every spiral
     case must launch A and kernel 7); (b) the JAX package's work model of
     the windowed pipeline (``utils/profiling.py``, at the H100's rates)
     for phase 4's batch, term by term beside the time of the port's
     stages that do that work (each stage's calls of one batch replayed
     under CUDA events, queued behind a sleep), every term above its stage
     marked (work the port does not do), and the model's floor beside the
     batch's device time (torch.profiler): a record, not a check.
The line before the last is a JSON object with one entry per TPU kernel
row (A, B, C, D, D', E, F, 8, 9, 7, 11, 12, 13, 14, 10; ``launches`` from
the default path, else from the first path that runs the row); the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing either.

A kernel's ``bound_ms`` is the larger of its bytes (each input read once,
each output written once; for the colour steps only the cost entries and
window pixels this run's candidates need) over the H100's 3.35 TB/s and its
integer operations over 67 T/s, the card's CUDA-core (non-tensor) peak in
its data sheet.  Kernel 7 does its work in packed instructions (a
VABSDIFF4 scores four pixel-deltas; SSD adds a dp4a), so its operations are
those instructions over the card's issue rate, 33.5 T thread-instructions
a second (the 67 T float32 rate counts an FMA as two); its scalar count,
3 operations a pixel-delta over 67 T/s, is printed beside it as
``bound_scalar_ms``.  ``library_ms`` is A's yardstick, the advanced-indexing
call ``im2p[bidx, rows[..., None], cols[..., None, :]]`` on frames padded
beforehand (the port never calls it), and null for every other row: no
single PyTorch call computes a pooled SAD volume, a table of SADs at
per-chunk deltas, a colour step or a per-block SAD argmin over
data-dependent windows.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np

# the card's peaks, kept in one place
from blockbasedmotionestimation_tpu_torch.utils.profiling import (
    CORE_OPS_PER_S,
    HBM_BYTES_PER_S,
    INSTR_PER_S,
)

H, W, B = 1080, 1920, 8
SHIFT_Y, SHIFT_X = 5, 9  # frame 2 = frame 1 moved by (-5, -9): flow (u, v) = (-9, -5)
FUSE = 4          # cv_fused of phases 4e, 4f
COMPACT_K = 64    # cv_compact of phase 4g (ring 3): DESIGN.md's quality-viable point
# per-batch launches of MotionConfig(interp_factor=1): 4 levels of bs 32,
# 2 sweeps x 4 colours per round, a launch per round: D at cur 32, E at
# 16/8/4 and F at 2
WANT_LAUNCHES = {"gather_windows": 8, "pooled_cvs": 4, "deep_pooled_cvs": 4,
                 "color_step": 0, "color_round_stored": 4, "color_step_hybrid": 0,
                 "color_step_hybrid_tail": 0, "color_round_hybrid": 12, "color_round_hybrid_tail": 4,
                 "sad_spiral_argmin": 0, "color_step_fused": 0, "color_step_fused_rival": 0,
                 "color_round_fused": 0, "color_round_fused_rival": 0,
                 "full_block_volume": 0, "compact_tables": 0, "color_step_compact": 0,
                 "color_round_compact": 0}
NONE = dict.fromkeys(WANT_LAUNCHES, 0)
# regularizer="fourcolor": per level one search gather (A) and kernel 7; the
# colour steps are plain torch
WANT_FOURCOLOR = NONE | {"gather_windows": 4, "sad_spiral_argmin": 4}
# window_center="search" (rival on): per level the search (A, 7), the main
# and rival windows (A twice) and their dense volumes (B twice), and 5
# rounds of D/D', a launch a round
WANT_SEARCH = NONE | {"gather_windows": 12, "sad_spiral_argmin": 4, "pooled_cvs": 8,
                      "color_round_stored": 20}
# cv_fused=4: per level C for the main and the rival window, D in rounds
# 32/16/8, kernel 12 in rounds 4/2, a launch a round (8/9 and 11 without
# rival windows)
WANT_FUSED = NONE | {"gather_windows": 8, "deep_pooled_cvs": 8, "color_round_stored": 12,
                     "color_round_fused_rival": 8}
WANT_FUSED_NORIVAL = NONE | {"gather_windows": 4, "deep_pooled_cvs": 4, "color_round_stored": 12,
                             "color_round_fused": 8}
# cv_compact=64, rival off: per level 13 and 14, D (row 8) in round 32 (a
# launch), kernel 10 in rounds 16/8/4/2 (a launch a round)
WANT_COMPACT = NONE | {"gather_windows": 4, "full_block_volume": 4, "compact_tables": 4,
                       "color_round_stored": 4, "color_round_compact": 16}


def _cmd_line(cmd: list[str], pick=None) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if pick is not None:
        lines = [ln for ln in lines if pick in ln] or lines
    return lines[0]


def _main_pairs(torch, dev):
    """Phase 4's B=8 pairs at 1080p, made as bench.py makes them: seeded
    noise, frame 2 = frame 1 moved by (-5, -9)."""
    noise = np.random.default_rng(0).integers(0, 256, size=(B, H + 16, W + 16), dtype=np.uint8)
    im1 = torch.as_tensor(noise[:, :H, :W].copy(), device=dev)
    im2 = torch.as_tensor(noise[:, SHIFT_Y:SHIFT_Y + H, SHIFT_X:SHIFT_X + W].copy(), device=dev)
    return im1, im2


def _texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Smooth multi-octave value noise, uint8 (matchable at every level)."""
    img = np.zeros((h, w))
    for o, amp in enumerate((1.0, 0.6, 0.36, 0.22)):
        step = 1 << (4 - o)
        g = rng.standard_normal((h // step + 2, w // step + 2))
        ys, xs = np.arange(h) / step, np.arange(w) / step
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        img += amp * (
            g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx) + g[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + g[np.ix_(y0, x0 + 1)] * (1 - fy) * fx + g[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
    img -= img.min()
    return (img * (255.0 / img.max())).astype(np.uint8)


def _cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean time of fn on the card, CUDA events around `reps` calls, warmed
    up.  ``queued``: the calls wait on the card behind a ~2.5 ms sleep, so
    the host has issued them all before the first starts and the events
    time the card's work, not the host's calls (for calls shorter than
    their wrapper's host time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _gather_indexing(torch, im2, by, bx, bs: int, ext: int):
    """Kernel A's yardstick: one PyTorch call on the frames zero-padded
    beforehand, ``im2p[bidx, rows[..., None], cols[..., None, :]]`` (the
    port never calls it); returns the call, its index tensors built."""
    win = bs + 2 * ext
    im2p = torch.nn.functional.pad(im2, (ext, ext, ext, ext))
    ar = torch.arange(win, device=im2.device)
    rows = by.long()[..., None] + ar
    cols = bx.long()[..., None] + ar
    bidx = torch.arange(im2.shape[0], device=im2.device)[:, None, None, None]
    return lambda: im2p[bidx, rows[..., None], cols[..., None, :]]


def _max_abs_err(torch, a, b) -> int:
    """Largest |a - b| of two integer tensors of one dtype and shape (costs
    and MVs fit int32; computed in place to bound memory)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"kernel {a.dtype} {tuple(a.shape)} vs plain {b.dtype} {tuple(b.shape)}")
    d = a.to(torch.int32)
    d.sub_(b.to(torch.int32)).abs_()
    return int(d.max())


@contextlib.contextmanager
def _swapped(module, **fns):
    """Replace functions of a module for the duration of the block."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


@contextlib.contextmanager
def _plain_kernels():
    """Route the main path through the kernels' plain versions (also on CUDA)."""
    from blockbasedmotionestimation_tpu_torch.kernels import (
        cv_diff,
        fused_step,
        gather,
        reg_step,
        sad_search,
    )
    from blockbasedmotionestimation_tpu_torch.kernels import resample as kres
    from blockbasedmotionestimation_tpu_torch.ops import resample, search, windowed

    with _swapped(resample, pyrdown_u8=kres.pyrdown_u8_plain,
                  resize_linear_u8=kres.resize_linear_u8_plain), _swapped(
        search, _gather=gather.gather_windows_plain,
        _sad_argmin=sad_search.sad_spiral_argmin_plain), _swapped(
        windowed,
        pooled_cvs=cv_diff.pooled_cvs_plain,
        deep_pooled_cvs=cv_diff.deep_pooled_cvs_plain,
        full_block_volume=cv_diff.full_block_volume_plain,
        compact_tables=cv_diff.compact_tables_plain,
        color_round_stored=reg_step.color_round_stored_plain,
        color_round_compact=reg_step.color_round_compact_plain,
        color_round_hybrid=fused_step.color_round_hybrid_plain,
        color_round_hybrid_tail=fused_step.color_round_hybrid_tail_plain,
        color_round_fused=fused_step.color_round_fused_plain,
        color_round_fused_rival=fused_step.color_round_fused_rival_plain,
    ):
        yield


def _dense_rival_form():
    """Run every level in the dense-rival form (every size of both windows
    stored, D/D' in every round), as levels with bs % 8 != 0 run."""
    from blockbasedmotionestimation_tpu_torch.ops import windowed

    return _swapped(windowed, hybrid_form=lambda bs, rival: False)


def _kernel_counters() -> dict:
    """Every kernel wrapper by name; each counts its own launches
    (``.launches``)."""
    from blockbasedmotionestimation_tpu_torch.kernels import (
        cv_diff,
        fused_step,
        gather,
        reg_step,
        sad_search,
    )

    counters = {f.__name__: f for f in (
        gather.gather_windows, cv_diff.pooled_cvs, cv_diff.deep_pooled_cvs, reg_step.color_step,
        reg_step.color_round_stored, fused_step.color_step_hybrid, fused_step.color_step_hybrid_tail,
        fused_step.color_round_hybrid, fused_step.color_round_hybrid_tail,
        sad_search.sad_spiral_argmin, fused_step.color_step_fused,
        fused_step.color_step_fused_rival, fused_step.color_round_fused,
        fused_step.color_round_fused_rival, cv_diff.full_block_volume, cv_diff.compact_tables,
        reg_step.color_step_compact, reg_step.color_round_compact)}
    if sorted(counters) != sorted(WANT_LAUNCHES):
        raise AssertionError(f"kernel wrappers {sorted(counters)} vs {sorted(WANT_LAUNCHES)}")
    return counters


def _two_motion(h: int, w: int, b: int, rng: np.random.Generator):
    """b seeded-noise pairs, each with two translations split by a vertical
    line: (im1, im2) (b, h, w) uint8 and the known (b, h, w, 2) flow (u, v).
    The motions differ by more than the level-0 window radius, so a parent
    window at the split sees only one of them."""
    im1 = np.empty((b, h, w), np.uint8)
    im2 = np.empty((b, h, w), np.uint8)
    flow = np.empty((b, h, w, 2), np.float32)
    for bi in range(b):
        tex = rng.integers(0, 256, size=(h + 64, w + 64), dtype=np.uint8)
        split = w // 3 + 97 * bi
        (ul, vl), (ur, vr) = (7, -3 + bi % 3), (-12 - bi % 4, 5)
        im2[bi] = tex[32:32 + h, 32:32 + w]
        left = tex[32 + vl:32 + vl + h, 32 + ul:32 + ul + w]
        right = tex[32 + vr:32 + vr + h, 32 + ur:32 + ur + w]
        im1[bi] = np.where(np.arange(w)[None, :] < split, left, right)
        flow[bi] = np.where((np.arange(w) < split)[None, :, None], (ul, vl), (ur, vr))
    return im1, im2, flow


def _same_as_plain(torch, engine, cfg, im1, im2, flow, tag: str) -> None:
    """Every frame of a kernel-path batch equals the plain path on the card."""
    for bi in range(im1.shape[0]):
        with _plain_kernels():
            plain, _ = engine.estimate_flow_batched(im1[bi:bi + 1], im2[bi:bi + 1], cfg)
        if not torch.equal(plain[0], flow[bi]):
            diff = int((plain[0] != flow[bi]).any(-1).sum())
            raise AssertionError(f"[{tag}] frame {bi}: plain path differs at {diff} pixels")
    print(f"[{tag}] all {im1.shape[0]} frames through the plain versions on the card == kernel path")


def _bound(nbytes: float, ops: float, rate: float = CORE_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) the card could take, and what bounds it; ``ops`` at
    ``rate`` a second."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _diff_ops(b: int, n_p: int, side: int, bs: int) -> int:
    """Integer operations of a pooled volume: a difference, an absolute value
    (or square) and an add for each pixel of each delta."""
    return 3 * b * n_p * side * side * bs * bs


def _tables_work(frames, wins, slots, tables) -> tuple[int, int]:
    """(bytes, ops) of one kernel-14 call on these inputs: frames, windows
    and slot lists read once, the tables written once; a diff, an absolute
    value (or square) and an add per pixel of each (parent, used slot)
    pair."""
    from blockbasedmotionestimation_tpu_torch.ops.compact import CHUNK

    n_p = wins.shape[1]
    bs = 2 << len(tables)  # the tables hold cur = 2 .. bs/2
    used = (slots[..., 0] >= 0).sum(-1).repeat_interleave(CHUNK, dim=1)[:, :n_p]
    return _nbytes(frames, wins, slots, *tables.values()), 3 * int(used.sum()) * bs * bs


def _step_work(torch, g, pm, rpm, *, kind, cur, h, w, r, r2, ci, cj, store_r=None,
               cost_bytes=(2, 4)):
    """(bytes, ops) one colour step needs on these inputs: the grid read and
    its colour written, the window centres, and for each cell's distinct
    usable candidates a cost entry picked (D: main or rival volume; E: main
    volume; F: band; fused, 11/12: none) or a recompute (cur^2 window bytes,
    once cur^2 frame-1 bytes per cell) with its operations, plus the
    smoothness terms."""
    from blockbasedmotionestimation_tpu_torch.kernels import reg_step as rs
    from blockbasedmotionestimation_tpu_torch.ops import regularize

    cands, _, present, in_img = regularize.step_candidates(g, cur, h, w, ci, cj)
    f = g.shape[1] // pm.shape[1]
    _, ddx, in_win = rs.window_deltas(cands, pm, f, ci, cj, r)
    in_riv = torch.zeros_like(in_win)
    if rpm is not None:
        in_riv = rs.window_deltas(cands, rpm, f, ci, cj, r2)[2] & ~in_win
    usable = present & in_img & (in_win | in_riv)
    first = _first_distinct(torch, cands, usable)
    if kind == "fused":
        store_r = -1  # nothing stored: every main-window candidate is recomputed
    band = ddx.abs() <= (r if store_r is None else store_r)
    pick_main = first & in_win & band
    tail = first & in_win & ~band
    riv = first & in_riv
    if kind == "D":
        picked = int(pick_main.sum()) * cost_bytes[0] + int(riv.sum()) * cost_bytes[1]
        re = torch.zeros_like(first)
    else:
        picked = int(pick_main.sum()) * cost_bytes[0]
        re = riv | tail
    n_re = int(re.sum())
    cells = usable.shape[0] * usable.shape[1] * usable.shape[2]
    nbytes = (_nbytes(g, pm) + cells * 8 + (_nbytes(rpm) if rpm is not None else 0)
              + picked + n_re * cur * cur + int(re.any(-1).sum()) * cur * cur)
    ops = cells * 9 * 9 * 3 + n_re * cur * cur * 3
    return nbytes, ops


def _first_distinct(torch, cands, usable):
    """usable, minus candidates equal to an earlier usable one of the cell."""
    first = usable.clone()
    for k in range(1, 9):
        for j in range(k):
            same = (cands[..., j, :] == cands[..., k, :]).all(-1)
            first[..., k] &= ~(usable[..., j] & same)
    return first


def _compact_step_work(torch, g, pm, slots, table, *, cur, h, w, r, ci, cj):
    """(bytes, ops, sector bytes) of one compact colour step (kernel 10) on
    these inputs: the grid read and its colour written, the centres and the
    slot map (where each candidate finds its slot), a table entry for each
    cell's distinct usable covered candidate, and the smoothness terms; the
    sector bytes count each table entry's 32-byte sector instead, once per
    distinct sector (what a random read fetches)."""
    from blockbasedmotionestimation_tpu_torch.kernels import reg_step as rs
    from blockbasedmotionestimation_tpu_torch.ops import compact, regularize

    cands, _, present, in_img = regularize.step_candidates(g, cur, h, w, ci, cj)
    f = g.shape[1] // pm.shape[1]
    ddy, ddx, in_win = rs.window_deltas(cands, pm, f, ci, cj, r)
    b, m, n = cands.shape[:3]
    side = 2 * r + 1
    smap = compact.slot_map(slots, r)
    none = torch.full_like(smap[..., :1], compact.NO_SLOT, dtype=torch.int32)
    wide = torch.cat([smap.to(torch.int32), none], -1)  # key side^2: outside the window
    rows = torch.arange(ci, ci + 2 * m, 2, device=g.device)
    cols = torch.arange(cj, cj + 2 * n, 2, device=g.device)
    ch = ((rows[:, None] // f * pm.shape[2] + cols[None, :] // f) // compact.CHUNK)  # (m, n)
    key = torch.where(in_win, (ddy + r) * side + (ddx + r), side * side)
    slot = torch.gather(wide[:, ch.reshape(-1)].reshape(b, m, n, -1), 3, key.long())
    covered = slot != compact.NO_SLOT
    covered &= covered[..., :1]
    first = _first_distinct(torch, cands, present & in_img & covered)
    cells = b * m * n
    other = _nbytes(g, pm, smap) + cells * 8
    nbytes = other + int(first.sum()) * table.element_size()
    nby, nbx = g.shape[1:3]
    fb, fi, fj, fk = first.nonzero(as_tuple=True)
    addr = ((fb * slots.shape[2] + slot[fb, fi, fj, fk]) * nby + rows[fi]) * nbx + cols[fj]
    sectors = int(torch.unique(addr * table.element_size() // 32).numel())
    return nbytes, cells * 9 * 9 * 3, other + 32 * sectors


def _kernels_vs_plain(torch, dev, cfg, card: str, rng: np.random.Generator) -> dict:
    """Phase 3: each kernel against its plain version at the 1080p level-0
    shapes, B=8; returns the results per TPU kernel row (launches 0).  A
    row keeps the first shape's times and bound (the main path's shape) and
    the worst error of all its shapes.

    The volume and colour-step kernels run at B=8 as the main path launches
    them; their plain versions run frame by frame on the same inputs
    (bounded memory) and each frame's slice is compared, so offsets past
    2^31 entries are checked too."""
    from blockbasedmotionestimation_tpu_torch.kernels import (
        cv_diff,
        fused_step,
        gather,
        reg_step,
        sad_search,
    )
    from blockbasedmotionestimation_tpu_torch.ops import compact
    from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
    from blockbasedmotionestimation_tpu_torch.ops import search
    from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS
    from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent

    p = pad_ops.compute_padding(H, W, cfg)
    hp, wp, bs = p.padded_h, p.padded_w, cfg.block_sizes[0]
    npy, npx = hp // bs, wp // bs
    n_p = npy * npx
    ext = (cfg.search_sizes[0] - bs) // 2
    r2 = cfg.rival_radius_at(0)
    store_r = cfg.cv_store_radius
    fuse_max = min(16, bs // 2)
    frames = torch.as_tensor(rng.integers(0, 256, size=(B, hp, wp), dtype=np.uint8), device=dev)
    results = {}

    def record(row, name, source, replaces, err, ms, plain_ms, work, what, also=None,
               rate=CORE_OPS_PER_S, scalar_ops=None):
        """work: (bytes, ops), or (bytes, ops, bytes counting whole 32-byte
        sectors of random reads), which adds a second bound; ops at
        ``rate`` a second.  scalar_ops: the same work in scalar operations
        at CORE_OPS_PER_S, a second figure for packed work."""
        bound_ms, bound_by = _bound(*work[:2], rate)
        also_bound = "" if len(work) < 3 else (
            f"; {_bound(work[2], 0)[0]:.4f} ms counting whole sectors ({work[2]} B)")
        if scalar_ops is not None:
            also_bound = (f"; {_bound(work[0], scalar_ops)[0]:.4f} ms counting {scalar_ops} "
                          f"scalar ops")
        print(f"[kernel] {row} {name} {what}: max_abs_err {err}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {work[0]} B, {work[1]} "
              f"ops at {rate:.3g}/s{also_bound}) ({card})")
        if row in results:
            results[row]["max_abs_err"] = max(err, results[row]["max_abs_err"])
            return
        results[row] = {
            "name": name, "row": row, "route": "cuda",
            "source": f"blockbasedmotionestimation_tpu_torch/csrc/{source}",
            "replaces": f"blockbasedmotionestimation_tpu/kernels/{replaces}",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
        if also:
            results[row]["also_replaces"] = [f"blockbasedmotionestimation_tpu/kernels/{a}" for a in also]
        if len(work) > 2:
            results[row]["bound_sectors_ms"] = _bound(work[2], 0)[0]
        if scalar_ops is not None:
            results[row]["bound_scalar_ms"] = _bound(work[0], scalar_ops)[0]

    def per_frame(fn):
        for bi in range(B):
            fn(bi)

    # A: the gather, main then rival windows; its yardstick, one PyTorch
    # advanced-indexing call on the frames padded beforehand
    offs = {}
    for tag, e in (("main", ext), ("rival", r2)):
        by = torch.as_tensor(rng.integers(0, hp - bs + 1, size=(B, n_p)), dtype=torch.int32, device=dev)
        bx = torch.as_tensor(rng.integers(0, wp - bs + 1, size=(B, n_p)), dtype=torch.int32, device=dev)
        k = gather.gather_windows(frames, by, bx, bs, e)
        err = _max_abs_err(torch, k, gather.gather_windows_plain(frames, by, bx, bs, e))
        ms = _cuda_ms(torch, lambda: gather.gather_windows(frames, by, bx, bs, e), 20)
        pms = _cuda_ms(torch, lambda: gather.gather_windows_plain(frames, by, bx, bs, e), 5)
        index = _gather_indexing(torch, frames, by, bx, bs, e)
        err = max(err, _max_abs_err(torch, k, index()))
        lms = _cuda_ms(torch, index, 20)
        print(f"[kernel] A library: im2p[bidx, rows, cols] on the padded frames, {tag}: "
              f"{lms:.4f} ms ({card})")
        record("A", "gather_windows", "gather.cu", "gather.py:58", err, ms, pms,
               (_nbytes(frames, by, bx, k), 0), f"{tag} (win {bs + 2 * e}, B={B})",
               also=["gather.py:101"])
        if results["A"]["library_ms"] is None:  # the main window's, the first shape
            results["A"]["library_ms"] = lms
        offs[tag] = (k, by, bx)
    wins, rwins = offs["main"][0], offs["rival"][0]

    # B: the main path's call (the stored band), then the dense volumes of
    # the dense-rival form; C: the rival window's volumes; 13: the cur = bs
    # volume alone
    def volumes(row, name, source, replaces, fn, plain, win, e, what, also=None):
        k = fn(frames, win, bs, e, cfg.cost)
        err = 0
        for bi in range(B):
            ref = plain(frames[bi:bi + 1], win[bi:bi + 1], bs, e, cfg.cost)
            if sorted(ref) != sorted(k):
                raise AssertionError(f"{name}: kernel sizes {sorted(k)}, plain {sorted(ref)}")
            err = max([err] + [_max_abs_err(torch, k[c][bi:bi + 1], ref[c]) for c in k])
            del ref
        ms = _cuda_ms(torch, lambda: fn(frames, win, bs, e, cfg.cost), 3)
        pms = _cuda_ms(torch, lambda: per_frame(
            lambda bi: plain(frames[bi:bi + 1], win[bi:bi + 1], bs, e, cfg.cost)), 1)
        work = (_nbytes(frames, win, *k.values()), _diff_ops(B, n_p, 2 * e + 1, bs))
        record(row, name, source, replaces, err, ms, pms, work,
               f"{what}: r={e}, B={B} (plain: {B} frames one by one), sizes "
               f"{ {c: tuple(v.shape[1:]) for c, v in k.items()} }", also)
        return k

    def band_of(fn):
        return lambda im1, win, bs_, e, cost: fn(im1, win, bs_, e, cost, store_r=store_r)

    vols = volumes("B", "pooled_cvs", "cv_diff.cu", "cv_diff.py:672",
                   band_of(cv_diff.pooled_cvs), band_of(cv_diff.pooled_cvs_plain), wins, ext,
                   f"main, stored band store_r={store_r}", also=["cv_diff.py:771", "cv_diff.py:826",
                                                                 "cv_diff.py:885"])
    dense = volumes("B", "pooled_cvs", "cv_diff.cu", "cv_diff.py:672", cv_diff.pooled_cvs,
                    cv_diff.pooled_cvs_plain, wins, ext, "main, dense")
    rdense = volumes("B", "pooled_cvs", "cv_diff.cu", "cv_diff.py:672", cv_diff.pooled_cvs,
                     cv_diff.pooled_cvs_plain, rwins, r2, "rival, dense")

    def deep(fn, fm):
        return lambda im1, win, bs_, e, cost: fn(im1, win, bs_, e, cost, fm)

    rdeep = volumes("C", "deep_pooled_cvs", "cv_diff.cu", "cv_diff.py:448",
                    deep(cv_diff.deep_pooled_cvs, fuse_max),
                    deep(cv_diff.deep_pooled_cvs_plain, fuse_max), rwins, r2,
                    f"rival, cur > {fuse_max} and cur = {bs}", also=["cv_diff.py:511"])
    volumes("C", "deep_pooled_cvs", "cv_diff.cu", "cv_diff.py:448",
            deep(cv_diff.deep_pooled_cvs, FUSE), deep(cv_diff.deep_pooled_cvs_plain, FUSE), wins,
            ext, f"main, cv_fused={FUSE}: cur > {FUSE} and cur = {bs}")
    full = volumes("13", "full_block_volume", "cv_diff.cu", "cv_diff.py:322",
                   cv_diff.full_block_volume, cv_diff.full_block_volume_plain, wins, ext,
                   f"main, cur = {bs} only (cv_compact)", also=["cv_diff.py:354"])
    if not torch.equal(rdeep[bs], rdense[bs]) or not torch.equal(full[bs], dense[bs]):
        raise AssertionError("kernel C's or kernel 13's cur=bs volume differs from kernel B's")
    del full

    origin = torch.stack(
        torch.meshgrid(torch.arange(npx, device=dev) * bs, torch.arange(npy, device=dev) * bs,
                       indexing="xy"), -1)[None].to(torch.int32)
    base = (torch.stack([offs["main"][2], offs["main"][1]], -1).reshape(B, npy, npx, 2)
            - origin).contiguous()
    rbase = (base + torch.as_tensor(rng.integers(-16, 17, size=base.shape), dtype=torch.int32,
                                    device=dev)).contiguous()
    del offs

    def steps(row, name, source, replaces, kernel, plain, cur, vol_of, kw_of, kind, what,
              also=None, spread=20, work_of=None, round_kernel=None, round_plain=None):
        """All four colours against the plain version; one colour timed.
        Candidates within +-spread of the window centres."""
        f = bs // cur
        pmf = base.repeat_interleave(f, 1).repeat_interleave(f, 2)
        g0 = (pmf + torch.as_tensor(rng.integers(-spread, spread + 1, size=pmf.shape),
                                    dtype=torch.int32, device=dev)).contiguous()
        common = dict(cur=cur, h=hp, w=wp, r=ext, lam_mult=16.0 * bs / cur)
        vol = vol_of(cur)
        gk = g0.clone()
        for ci, cj in COLORS:
            kernel(gk, vol, base, ci=ci, cj=cj, **common, **kw_of(slice(None)))
        err = 0
        for bi in range(B):
            gp = g0[bi:bi + 1].clone()
            sl = slice(bi, bi + 1)
            for ci, cj in COLORS:
                plain(gp, None if vol is None else vol[sl], base[sl], ci=ci, cj=cj, **common,
                      **kw_of(sl))
            err = max(err, _max_abs_err(torch, gk[sl], gp))
        if torch.equal(gk, g0):
            raise AssertionError(f"{name} at cur={cur} changed no cell")
        kw = kw_of(slice(None))
        gt = g0.clone()  # timed in place, colour (1, 0)
        ms = _cuda_ms(torch, lambda: kernel(gt, vol, base, ci=1, cj=0, **common, **kw), 20)
        pms = _cuda_ms(torch, lambda: per_frame(lambda bi: plain(
            g0[bi:bi + 1].clone(), None if vol is None else vol[bi:bi + 1], base[bi:bi + 1],
            ci=1, cj=0, **common, **kw_of(slice(bi, bi + 1)))), 1)
        def work_at(g, ci, cj):  # the work of colour (ci, cj) on grid g
            if work_of is not None:
                return work_of(g, vol, kw, ci, cj)
            rcv = kw.get("rcv")
            return _step_work(torch, g, base, kw.get("rpm"), kind=kind, cur=cur, h=hp, w=wp,
                              r=ext, r2=r2, ci=ci, cj=cj, store_r=kw.get("store_r"),
                              cost_bytes=(vol.element_size() if vol is not None else 0,
                                          rcv.element_size() if rcv is not None else 0))

        record(row, name, source, replaces, err, ms, pms, work_at(g0, 1, 0),
               f"{what} at cur={cur} (f={f}): four colours compared, (1, 0) timed; B={B}, "
               f"grid {tuple(g0.shape[1:3])}", also)
        if round_kernel is not None:
            rounds(row, name, round_kernel, round_plain, plain, g0, vol, kw_of, work_at, cur, what)

    def rounds(row, name, kernel, plain, step_plain, g0, vol, kw_of, work_at, cur, what):
        """A whole round (the main path's lambda at cur, its sweeps) in one
        launch against the plain step loop, frame by frame; the round timed
        in place; its bound is the sum of its steps' (``work_at``) on the
        states they meet (the plain loop replayed at B=8)."""
        rkw = dict(cur=cur, h=hp, w=wp, r=ext, lam=16.0 * bs / cur, sweeps=cfg.sweeps_per_round)
        kw = kw_of(slice(None))
        gk = g0.clone()
        kernel(gk, vol, base, **rkw, **kw)
        err = 0
        for bi in range(B):
            sl = slice(bi, bi + 1)
            gp = g0[sl].clone()
            plain(gp, None if vol is None else vol[sl], base[sl], **rkw, **kw_of(sl))
            err = max(err, _max_abs_err(torch, gk[sl], gp))
        gt = g0.clone()
        ms = _cuda_ms(torch, lambda: kernel(gt, vol, base, **rkw, **kw), 10)
        pms = _cuda_ms(torch, lambda: per_frame(lambda bi: plain(
            g0[bi:bi + 1].clone(), None if vol is None else vol[bi:bi + 1], base[bi:bi + 1],
            **rkw, **kw_of(slice(bi, bi + 1)))), 1)
        work = None
        gw = g0.clone()
        for mult in fused_step.sweep_lams(rkw["lam"], rkw["sweeps"]):
            for ci, cj in COLORS:
                step = work_at(gw, ci, cj)
                work = step if work is None else tuple(a + b for a, b in zip(work, step))
                step_plain(gw, vol, base, ci=ci, cj=cj, cur=cur, h=hp, w=wp, r=ext,
                           lam_mult=mult, **kw)
        bound_ms, bound_by = _bound(*work[:2])
        res = results[row]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        out = {"cur": cur, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err}
        sectors = ""
        if len(work) > 2:
            out["bound_sectors_ms"] = _bound(work[2], 0)[0]
            sectors = f"; {out['bound_sectors_ms']:.4f} ms counting whole sectors ({work[2]} B)"
        print(f"[kernel] {row} {name} round {what} at cur={cur}: {rkw['sweeps']} sweeps x 4 "
              f"colours in one launch, max_abs_err {err}, kernel {ms:.4f} ms, plain step loop "
              f"{pms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; {work[0]} B, {work[1]} ops"
              f"{sectors}) ({card})")
        res.setdefault("round", []).append(out)

    def rival_kw(rcv):
        if rcv is None:
            return lambda sl: {}
        return lambda sl: dict(rcv=rcv[sl], rpm=rbase[sl], r2=r2)

    # D: the main path's f=1 round on C's volume; D': the dense-rival form's
    # cur=2 round; 8 and 9: both without rival windows.  The stored form of
    # the round kernel, each one colour step and one round; the rows are
    # named after the round wrapper, which the paths launch
    for row, replaces, cur, rv in (("D", "reg_step.py:773", bs, rdeep),
                                   ("D'", "reg_step.py:680", 2, rdense),
                                   ("8", "reg_step.py:303", bs, None),
                                   ("9", "reg_step.py:213", 2, None)):
        pcall = {"D": "reg_step.py:835", "D'": "reg_step.py:750", "8": "reg_step.py:358",
                 "9": "reg_step.py:283"}[row]
        steps(row, f"color_round_stored[{row}]", "fused_step.cu", replaces, reg_step.color_step,
              reg_step.color_step_plain, cur, lambda c: dense[c],
              rival_kw(None if rv is None else rv[cur]), "D",
              "rival" if rv is not None else "no rival", also=[pcall],
              round_kernel=reg_step.color_round_stored,
              round_plain=reg_step.color_round_stored_plain)

    def hybrid_kw(sl):
        return dict(im1=frames[sl], rwin=rwins[sl], rpm=rbase[sl], r2=r2, cost=cfg.cost)

    # E at cur 4 and 16 on the dense main volume; F at cur 2 on the band;
    # each one colour step and one round.  The rows are named after the
    # round wrappers, which the main path launches
    for cur in (4, 16):
        steps("E", "color_round_hybrid", "fused_step.cu", "fused_step.py:870",
              fused_step.color_step_hybrid, fused_step.color_step_hybrid_plain, cur,
              lambda c: dense[c], hybrid_kw, "E", "main volume + rival recompute",
              also=["fused_step.py:937"], round_kernel=fused_step.color_round_hybrid,
              round_plain=fused_step.color_round_hybrid_plain)
    steps("F", "color_round_hybrid_tail", "fused_step.cu", "fused_step.py:772",
          fused_step.color_step_hybrid_tail, fused_step.color_step_hybrid_tail_plain, 2,
          lambda c: vols[c], lambda sl: dict(hybrid_kw(sl), win=wins[sl], store_r=store_r), "F",
          f"band store_r={store_r} + main-tail and rival recompute", also=["fused_step.py:848"],
          round_kernel=fused_step.color_round_hybrid_tail,
          round_plain=fused_step.color_round_hybrid_tail_plain)
    del vols, dense, rdense, rdeep

    # 11 and 12: cv_fused's rounds cur <= 4, every candidate recomputed from
    # the main (and rival) windows
    def no_volume(fn):
        return lambda g, vol, pm, **kw: fn(g, pm, **kw)

    def fused_kw(rival):
        def kw_of(sl):
            kw = dict(im1=frames[sl], win=wins[sl], cost=cfg.cost)
            if rival:
                kw.update(rwin=rwins[sl], rpm=rbase[sl], r2=r2)
            return kw
        return kw_of

    for cur in (2, 4):
        steps("11", "color_round_fused", "fused_step.cu", "fused_step.py:401",
              no_volume(fused_step.color_step_fused), no_volume(fused_step.color_step_fused_plain),
              cur, lambda c: None, fused_kw(False), "fused", "main window recompute",
              also=["fused_step.py:466"], round_kernel=no_volume(fused_step.color_round_fused),
              round_plain=no_volume(fused_step.color_round_fused_plain))
        steps("12", "color_round_fused_rival", "fused_step.cu", "fused_step.py:488",
              no_volume(fused_step.color_step_fused_rival),
              no_volume(fused_step.color_step_fused_rival_plain), cur, lambda c: None,
              fused_kw(True), "fused", "main and rival window recompute",
              also=["fused_step.py:557"],
              round_kernel=no_volume(fused_step.color_round_fused_rival),
              round_plain=no_volume(fused_step.color_round_fused_rival_plain))

    # 14 and 10: cv_compact at K = COMPACT_K, the slot lists of winners within
    # +-2 of the centres (25 deltas: unused slots hold -1)
    winners = (base + torch.as_tensor(rng.integers(-2, 3, size=base.shape), dtype=torch.int32,
                                      device=dev)).contiguous()
    slots = compact.chunk_delta_slots(winners, base, ext, COMPACT_K)
    used = int((slots[..., 0] >= 0).sum())
    print(f"[kernel] compact slot lists: {tuple(slots.shape)}, {used} of {slots[..., 0].numel()} "
          f"slots used, overflow {compact.overflow_fraction(winners, base, ext, COMPACT_K).tolist()}")
    # the main path's cost first (its times and bound stay on the row), then
    # the other cost; 10 below reads the main path's tables
    for cost in (cfg.cost, "ssd" if cfg.cost == "sad" else "sad"):
        got = cv_diff.compact_tables(frames, wins, slots, bs, ext, cost)
        err = 0
        for bi in range(B):
            ref = cv_diff.compact_tables_plain(frames[bi:bi + 1], wins[bi:bi + 1],
                                               slots[bi:bi + 1], bs, ext, cost)
            err = max([err] + [_max_abs_err(torch, got[c][bi:bi + 1], ref[c]) for c in got])
            del ref
        ms = _cuda_ms(torch, lambda: cv_diff.compact_tables(frames, wins, slots, bs, ext, cost), 5)
        pms = _cuda_ms(torch, lambda: per_frame(lambda bi: cv_diff.compact_tables_plain(
            frames[bi:bi + 1], wins[bi:bi + 1], slots[bi:bi + 1], bs, ext, cost)), 1)
        record("14", "compact_tables", "cv_diff.cu", "cv_diff.py:584", err, ms, pms,
               _tables_work(frames, wins, slots, got),
               f"{cost}: K={COMPACT_K}, B={B} (plain: {B} frames one by one), sizes "
               f"{ {c: tuple(v.shape[1:]) for c, v in got.items()} }", also=["cv_diff.py:649"])
        if cost == cfg.cost:
            tables = got
        del got

    def compact_work(cur):
        return lambda g, vol, kw, ci, cj: _compact_step_work(
            torch, g, base, slots, vol, cur=cur, h=hp, w=wp, r=ext, ci=ci, cj=cj)

    # 10: the round kernel's compact form, a colour step (a span of one) and
    # a whole round, on the level's slot map (built once, as the level does)
    smap = compact.slot_map(slots, ext)

    def compact_step_plain(*args, smap, **kw):  # the plain step reads the slot lists only
        reg_step.color_step_compact_plain(*args, **kw)

    for cur in (2, 16):
        steps("10", "color_round_compact", "fused_step.cu", "reg_step.py:441",
              reg_step.color_step_compact, compact_step_plain, cur,
              lambda c: tables[c], lambda sl: dict(slots=slots[sl], smap=smap[sl]), "compact",
              f"K={COMPACT_K} slots, candidates within +-3 (many miss every slot)",
              also=["reg_step.py:500"], spread=3, work_of=compact_work(cur),
              round_kernel=reg_step.color_round_compact,
              round_plain=reg_step.color_round_compact_plain)
    del tables, slots, smap, winners

    # 7: the spiral search's argmin around the centres block_search_level
    # passes (origin + a prediction within +-48 px; the origin where that
    # block leaves the frame), on windows gathered by A.  Frame 2 is frame 1
    # moved by (-5, -9), and a constant 256 px corner makes every offset of
    # its blocks cost the same, so the spiral rank decides there.
    ss = cfg.search_sizes[0]
    s7 = spiral_extent(ss - bs)
    im1_7 = frames.clone()
    im1_7[:, :256, :256] = 9
    im2_7 = torch.roll(im1_7, shifts=(-SHIFT_Y, -SHIFT_X), dims=(1, 2))
    pred = torch.as_tensor(rng.integers(-48, 49, size=(B, npy, npx, 2)), dtype=torch.float32,
                           device=dev)
    oy, ox = search.block_origins(npy, npx, bs, dev)
    cy, cx = oy + pred[..., 1].to(torch.int32), ox + pred[..., 0].to(torch.int32)
    ok = (cy >= 0) & (cy <= hp - bs) & (cx >= 0) & (cx <= wp - bs)
    cy, cx = torch.where(ok, cy, oy), torch.where(ok, cx, ox)
    wins7 = search.gather_windows(im2_7, cy, cx, bs, s7)[0]
    cy, cx = cy.reshape(B, -1).contiguous(), cx.reshape(B, -1).contiguous()
    # the operations this run needs: the kernel sums only in-frame offsets
    rows = (cy + s7).clamp(max=hp - bs) - (cy - s7).clamp(min=0) + 1
    cols = (cx + s7).clamp(max=wp - bs) - (cx - s7).clamp(min=0) + 1
    pairs = int((rows.to(torch.int64) * cols).sum())
    rank = sad_search._rank_on(ss - bs, dev)
    args = (im1_7, wins7, cy, cx, bs, ss)
    for cost in ("sad", "ssd"):
        got = sad_search.sad_spiral_argmin(*args, cost)
        want = sad_search.sad_spiral_argmin_plain(*args, cost)
        err = max(_max_abs_err(torch, got[0], want[0]), _max_abs_err(torch, got[1], want[1]))
        ms = _cuda_ms(torch, lambda: sad_search.sad_spiral_argmin(*args, cost), 5)
        pms = _cuda_ms(torch, lambda: sad_search.sad_spiral_argmin_plain(*args, cost), 1)
        # a VABSDIFF4 a word of 4 pixel-deltas (sad), and a dp4a more (ssd)
        packed = pairs * bs * bs // 4 * (2 if cost == "ssd" else 1)
        work = (_nbytes(im1_7, wins7, cy, cx, rank, *got), packed)
        record("7", "sad_spiral_argmin", "sad_search.cu", "sad_search.py:105", err, ms, pms, work,
               f"{cost}: S={s7}, {B * npy * npx} blocks, win {bs + 2 * s7}, centres within "
               f"+-48 px ({int((~ok).sum())} left the frame: origin), {pairs} in-frame "
               f"(block, offset) pairs of {B * npy * npx * (2 * s7 + 1) ** 2}",
               also=["sad_search.py:149"], rate=INSTR_PER_S, scalar_ops=3 * pairs * bs * bs)
    bad = [row for row, r in results.items() if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results


# the resample kernels' shapes: (source frame, factor, padded upscale) of the
# full-HD driver and of the 640x480 driver
RESAMPLE_SHAPES = (((H, W), 4, (4352, 7680)), ((480, 640), 4, (2048, 2560)))


def _resample_vs_plain(torch, dev, card: str, rng: np.random.Generator) -> None:
    """Phase 3 (end): the resample kernels (``csrc/resample.cu``, no TPU
    kernel) against their plain versions at B=8: the 4x upscale of 1080p
    frames (the full-HD driver's) and of 640x480 ones, and pyrDown at each
    level of their padded pyramids (4 levels), exact equality; CUDA-event
    times of the kernel and of the plain version, the bound (input read and
    output written once, over 3.35 TB/s), and per batch (both frames of a
    pair: 2 upscales and 6 pyrDowns)."""
    from blockbasedmotionestimation_tpu_torch.kernels import resample as kres

    bad = []
    for (h, w), f, (hp, wp) in RESAMPLE_SHAPES:
        frames = torch.as_tensor(rng.integers(0, 256, size=(B, h, w), dtype=np.uint8), device=dev)
        up = kres.resize_linear_u8(frames, h * f, w * f)
        err = _max_abs_err(torch, up, kres.resize_linear_u8_plain(frames, h * f, w * f))
        ms = _cuda_ms(torch, lambda: kres.resize_linear_u8(frames, h * f, w * f), 20)
        pms = _cuda_ms(torch, lambda: kres.resize_linear_u8_plain(frames, h * f, w * f), 3)
        bound = _bound(_nbytes(frames, up), 0)[0]
        print(f"[kernel] resample resize_linear_u8 x{f} {B}x{h}x{w} -> {h * f}x{w * f}: "
              f"max_abs_err {err}, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bound:.4f} ms "
              f"(bytes; {_nbytes(frames, up)} B) ({card})")
        batch = [2 * ms, 2 * pms, 2 * bound]
        if err:
            bad.append(f"upscale {h}x{w}")
        oy, ox = (hp - h * f) // 2, (wp - w * f) // 2
        level = torch.nn.functional.pad(up, (ox, wp - w * f - ox, oy, hp - h * f - oy))
        del up
        for k in range(1, 4):
            nxt = kres.pyrdown_u8(level)
            err = max(_max_abs_err(torch, nxt[i], kres.pyrdown_u8_plain(level[i]))
                      for i in range(B))
            ms = _cuda_ms(torch, lambda: kres.pyrdown_u8(level), 20)
            pms = _cuda_ms(torch, lambda: kres.pyrdown_u8_plain(level), 3)
            bound = _bound(_nbytes(level, nxt), 0)[0]
            print(f"[kernel] resample pyrdown_u8 level {k - 1} -> {k}, {B}x{hp >> (k - 1)}x"
                  f"{wp >> (k - 1)}: max_abs_err {err}, kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {bound:.4f} ms (bytes; {_nbytes(level, nxt)} B) ({card})")
            batch = [t + 2 * x for t, x in zip(batch, (ms, pms, bound))]
            if err:
                bad.append(f"pyrdown {hp}x{wp} level {k}")
            level = nxt
        print(f"[kernel] resample per batch of {B} pairs at {h}x{w} x{f} (2 upscales, 6 pyrDowns):"
              f" kernels {batch[0]:.4f} ms, plain {batch[1]:.4f} ms, bound {batch[2]:.4f} ms, "
              f"8 launches ({card})")
        del level, frames
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"[kernel] the resample kernels differ from plain: {bad}")


def _volume_sweep(torch, dev, card: str, rng: np.random.Generator) -> None:
    """Phase 3: the volume kernel (B, C) against its plain version over a
    sweep of shapes: bs 8/16/32, r 0/3/12/16, sad and ssd, the band
    (store_r = min(4, r)) on and off, C's sizes; B=2 frames of 6x10 parents,
    so delta rows split into groups and the last group is short."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff

    worst, calls = 0, 0
    for bs in (8, 16, 32):
        for r in (0, 3, 12, 16):
            b, npy, npx, wc = 2, 6, 10, bs + 2 * r
            im1 = torch.as_tensor(rng.integers(0, 256, size=(b, npy * bs, npx * bs), dtype=np.uint8),
                                  device=dev)
            win = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, wc, wc), dtype=np.uint8),
                                  device=dev)
            for cost in ("sad", "ssd"):
                for kw in (dict(store_r=None), dict(store_r=min(4, r)),
                           dict(emit=cv_diff.deep_curs(bs, min(16, bs // 2)))):
                    k = cv_diff.pooled_cvs(im1, win, bs, r, cost, **kw)
                    p = cv_diff.pooled_cvs_plain(im1, win, bs, r, cost, **kw)
                    if sorted(k) != sorted(p):
                        raise AssertionError(f"volume sweep: sizes {sorted(k)} vs {sorted(p)}")
                    worst = max([worst] + [_max_abs_err(torch, k[c], p[c]) for c in k])
                    calls += 1
    print(f"[kernel] volume sweep: {calls} calls (bs 8/16/32, r 0/3/12/16, sad and ssd, band on "
          f"and off, C's sizes) against the plain version: max_abs_err {worst} ({card})")
    if worst:
        raise AssertionError("the volume kernel disagrees with its plain version in the sweep")


def _tables_sweep(torch, dev, card: str, rng: np.random.Generator) -> None:
    """Phase 3: kernel 14 against its plain version over a sweep of shapes:
    bs 4 .. 128, r 4 and 5 (ws a multiple of 4 and not), K 1, 8, 64 and
    side^2 with every fifth slot unused, sad and ssd; B=2 frames of 11x13
    parents, so a parent row straddles the two chunks and the last chunk is
    ragged."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff

    worst, calls = 0, 0
    b, npy, npx = 2, 11, 13
    for bs in (4, 8, 16, 32, 64, 128):
        im1 = torch.as_tensor(rng.integers(0, 256, size=(b, npy * bs, npx * bs), dtype=np.uint8),
                              device=dev)
        for r in (4, 5):
            side, ws = 2 * r + 1, bs + 2 * r
            win = torch.as_tensor(
                rng.integers(0, 256, size=(b, npy * npx, ws, ws), dtype=np.uint8), device=dev)
            for k_slots in (1, 8, 64, side * side):
                keys = np.stack([np.stack([rng.permutation(side * side)[:k_slots]
                                           for _ in range(2)]) for _ in range(b)])
                sl = np.stack([keys // side, keys % side], -1).astype(np.int32)
                sl[:, :, 2::5] = -1
                slots = torch.as_tensor(sl, device=dev)
                for cost in ("sad", "ssd"):
                    k = cv_diff.compact_tables(im1, win, slots, bs, r, cost)
                    p = cv_diff.compact_tables_plain(im1, win, slots, bs, r, cost)
                    if sorted(k) != sorted(p):
                        raise AssertionError(f"tables sweep: sizes {sorted(k)} vs {sorted(p)}")
                    worst = max([worst] + [_max_abs_err(torch, k[c], p[c]) for c in k])
                    calls += 1
    print(f"[kernel] 14 sweep: {calls} calls (bs 4..128, r 4/5, K 1/8/64/side^2 with unused "
          f"slots, sad and ssd, 11x13 parents in two chunks) against the plain version: "
          f"max_abs_err {worst} ({card})")
    if worst:
        raise AssertionError("kernel 14 disagrees with its plain version in the sweep")


def _volume_levels(torch, engine, cfg, im1, im2, card: str,
                   rows=(("B", "pooled_cvs"), ("C", "deep_pooled_cvs")), work_of=None,
                   queued: bool = False) -> dict:
    """The calls of ``rows`` (TPU kernel row, ``ops.windowed`` wrapper; B
    and C by default) at every level's shapes of the path ``cfg``: each
    call one batch makes (recorded by a spy), timed alone with CUDA events
    (``queued``: behind a sleep, see ``_cuda_ms``); ``work_of`` (row ->
    (args, out) -> (bytes, ops)) adds each call's bound.  Returns the times
    (and bounds) by call and their per-batch sums by row."""
    from blockbasedmotionestimation_tpu_torch.ops import windowed

    calls = []

    def spy(row, fn):
        def call(*args, **kw):
            calls.append((row, fn, args, kw))
            return fn(*args, **kw)
        return call

    with _swapped(windowed, **{name: spy(row, getattr(windowed, name)) for row, name in rows}):
        engine.estimate_flow_batched(im1, im2, cfg)
    work_of = work_of or {}
    out = {row: {"ms_by_call": [], "per_batch_ms": 0.0} for row, _ in rows}
    for row, fn, args, kw in calls:
        ms = _cuda_ms(torch, lambda: fn(*args, **kw), 10 if queued else 3, queued)
        shapes = ", ".join(str(tuple(a.shape)) if hasattr(a, "shape") else repr(a)
                           for a in args)
        more = f", {kw}" if kw else ""
        bound = ""
        if row in work_of:
            bound_ms, by = _bound(*work_of[row](args, fn(*args, **kw)))
            out[row].setdefault("bound_ms_by_call", []).append(bound_ms)
            out[row]["bound_per_batch_ms"] = out[row].get("bound_per_batch_ms", 0.0) + bound_ms
            bound = f", bound {bound_ms:.4f} ms ({by})"
        print(f"[levels] {row}: {shapes}{more}: {ms:.4f} ms{' queued' if queued else ''}{bound} "
              f"({card})")
        out[row]["ms_by_call"].append(ms)
        out[row]["per_batch_ms"] += ms
    del calls
    print(f"[levels] per batch of {B}: " + ", ".join(
        f"{row} {r['per_batch_ms']:.4f} ms over {len(r['ms_by_call'])} launches"
        for row, r in out.items()) + f" ({card})")
    return out


def _gather_levels(torch, engine, cfg, im1, im2, card: str) -> dict:
    """A at every level's shapes of the default path: each call one batch
    makes (recorded by a spy), timed alone with CUDA events, beside its
    yardstick (``_gather_indexing``) on the same inputs; returns the times
    by call and their per-batch sums."""
    from blockbasedmotionestimation_tpu_torch.ops import search

    calls = []

    def spy(*args):
        calls.append(args)
        return gather_fn(*args)

    gather_fn = search._gather
    with _swapped(search, _gather=spy):
        engine.estimate_flow_batched(im1, im2, cfg)
    out = {"ms_by_call": [], "per_batch_ms": 0.0, "library_per_batch_ms": 0.0}
    for args in calls:
        ms = _cuda_ms(torch, lambda: gather_fn(*args), 10)
        lms = _cuda_ms(torch, _gather_indexing(torch, *args), 10)
        frames, by, _, bs, ext = args
        print(f"[levels] A: level {tuple(frames.shape)}, {tuple(by.shape)} windows of "
              f"{bs + 2 * ext}^2: {ms:.4f} ms, library {lms:.4f} ms ({card})")
        out["ms_by_call"].append(ms)
        out["per_batch_ms"] += ms
        out["library_per_batch_ms"] += lms
    del calls
    print(f"[levels] per batch of {B}: A {out['per_batch_ms']:.4f} ms over "
          f"{len(out['ms_by_call'])} launches (library {out['library_per_batch_ms']:.4f} ms) "
          f"({card})")
    return out


def _round_levels(torch, engine, cfg, im1, im2, card: str) -> dict:
    """D, E and F on the default path's own rounds: each round one batch makes
    (recorded by a spy with the grid it met, so the candidates come from
    real search winners) against the plain step loop, and timed alone with
    CUDA events; at level 0 also one colour step, (1, 0) at the round's
    first multiplier, timed the same way.  Returns, by row, the round times
    by call and their per-batch sum, the level-0 steps and the worst error."""
    from blockbasedmotionestimation_tpu_torch.kernels import fused_step, reg_step
    from blockbasedmotionestimation_tpu_torch.ops import windowed

    calls = []

    def spy(row, fn, plain, step, step_plain):
        def call(grid, *args, **kw):
            calls.append((row, fn, plain, step, step_plain, grid.clone(), args, kw))
            return fn(grid, *args, **kw)
        call.per_round = True
        return call

    fs, rs = fused_step, reg_step
    with _swapped(windowed,
                  color_round_stored=spy("D", rs.color_round_stored, rs.color_round_stored_plain,
                                         rs.color_step, rs.color_step_plain),
                  color_round_hybrid=spy("E", fs.color_round_hybrid, fs.color_round_hybrid_plain,
                                         fs.color_step_hybrid, fs.color_step_hybrid_plain),
                  color_round_hybrid_tail=spy("F", fs.color_round_hybrid_tail,
                                              fs.color_round_hybrid_tail_plain,
                                              fs.color_step_hybrid_tail,
                                              fs.color_step_hybrid_tail_plain)):
        engine.estimate_flow_batched(im1, im2, cfg)
    h0 = max(kw["h"] for *_, kw in calls)
    out = {row: {"ms_by_call": [], "per_batch_ms": 0.0, "level0_steps": [], "max_abs_err": 0}
           for row in ("D", "E", "F")}
    for row, fn, plain, step, step_plain, g0, args, kw in calls:
        gk, gp = g0.clone(), g0.clone()
        fn(gk, *args, **kw)
        plain(gp, *args, **kw)
        err = _max_abs_err(torch, gk, gp)
        gt = g0.clone()
        ms = _cuda_ms(torch, lambda: fn(gt, *args, **kw), 5)
        moved = int((gk != g0).any(-1).sum())
        print(f"[levels] {row} round at h={kw['h']}, cur={kw['cur']}, grid {tuple(g0.shape)}, "
              f"search-winner candidates ({moved} cells moved): max_abs_err {err} against the "
              f"plain step loop, {ms:.4f} ms ({card})")
        res = out[row]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["ms_by_call"].append(ms)
        res["per_batch_ms"] += ms
        if kw["h"] != h0:
            continue
        skw = {k: v for k, v in kw.items() if k not in ("lam", "sweeps")}
        gs, gsp = g0.clone(), g0.clone()
        step(gs, *args, ci=1, cj=0, lam_mult=kw["lam"], **skw)
        step_plain(gsp, *args, ci=1, cj=0, lam_mult=kw["lam"], **skw)
        serr = _max_abs_err(torch, gs, gsp)
        res["max_abs_err"] = max(res["max_abs_err"], serr)
        gt = g0.clone()
        sms = _cuda_ms(torch, lambda: step(gt, *args, ci=1, cj=0, lam_mult=kw["lam"], **skw), 20)
        print(f"[levels] {row} level-0 step (1, 0) at cur={kw['cur']} on search-winner "
              f"candidates: max_abs_err {serr}, {sms:.4f} ms ({card})")
        res["level0_steps"].append({"cur": kw["cur"], "step_ms": sms, "round_ms": ms})
    del calls
    print(f"[levels] per batch of {B}: " + ", ".join(
        f"{row} {r['per_batch_ms']:.4f} ms over {len(r['ms_by_call'])} rounds"
        for row, r in out.items()) + f" ({card})")
    bad = [row for row, r in out.items() if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"rounds on search winners disagree with the plain loop: {bad}")
    return out


def _drive(torch, engine, cfg, im1, im2, counters: dict, want: dict, tag: str, card: str,
           reps: int = 10) -> dict:
    """Drive one path through ``estimate_flow_batched`` on the B=8 batch of
    known translation: every count is set to 0 just before the run and read
    just after, and must equal ``want`` (each kernel the path needs launched
    at least once); the interior must hold the known flow and every frame
    must equal the plain path on the card.  Prints the launches, the median
    of ``reps`` batches in fields/s and the peak memory; returns the
    launches by wrapper, the stored form's launches by TPU kernel row (D,
    D', 8, 9; rounds and single steps) and the flow."""
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    by_row = [counters[name].row_launches for name in ("color_round_stored", "color_step")]
    for rows in by_row:
        for row in rows:
            rows[row] = 0
    t0 = time.time()
    flow, pad = engine.estimate_flow_batched(im1, im2, cfg)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    rows = {row: sum(r[row] for r in by_row) for row in by_row[0]}
    print(f"[{tag}] launches: {launches} (expected {want}); the stored form by row {rows}")
    if any(launches[name] == 0 for name, n in want.items() if n):
        raise AssertionError(f"[{tag}] a kernel of the path was never launched")
    if launches != want:
        raise AssertionError(f"[{tag}] the path did not launch its kernels as expected")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(flow.shape) != (B, pad.padded_h, pad.padded_w, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"[{tag}] bad output {tuple(flow.shape)}")
    m = 64
    inner = flow[:, pad.pad_y + m : pad.pad_y + H - m, pad.pad_x + m : pad.pad_x + W - m]
    known = torch.tensor([-SHIFT_X, -SHIFT_Y], dtype=torch.float32, device=flow.device)
    wrong = ~(inner == known).all(-1)
    print(f"[{tag}] interior pixels off the known flow {(-SHIFT_X, -SHIFT_Y)}: "
          f"{int(wrong.sum())} of {wrong.numel()}, per frame {wrong.sum(dim=(1, 2)).tolist()}")
    for bi, y, x in wrong.nonzero()[:8].tolist():
        print(f"[{tag}]   frame {bi} at ({y + m}, {x + m}): {inner[bi, y, x].tolist()}")
    batch_s = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        engine.estimate_flow_batched(im1, im2, cfg)
        torch.cuda.synchronize()
        batch_s.append(time.time() - t0)
    med = float(np.median(batch_s))
    print(f"[{tag}] first call {first_s:.3f} s; {reps} batches of {B}: min {min(batch_s):.4f}, "
          f"median {med:.4f}, max {max(batch_s):.4f} s; {B / med:.3f} fields/s at the median; "
          f"peak {peak_gb:.2f} GB ({card})")
    _same_as_plain(torch, engine, cfg, im1, im2, flow, tag)
    if float(wrong.float().mean()) > 1e-3:
        raise AssertionError(f"[{tag}] the path did not recover the known translation")
    return launches, rows, flow, B / med


def _equal_flows(torch, a, b, what: str, tag: str) -> None:
    if not torch.equal(a, b):
        diff = int((a != b).any(-1).sum())
        raise AssertionError(f"[{tag}] the flow differs from {what} at {diff} pixels")
    print(f"[{tag}] flow == {what}, all {a.shape[0]} frames")


@contextlib.contextmanager
def _overflow_log(log: list):
    """Record ops.compact.overflow_fraction of each level's slot lists."""
    from blockbasedmotionestimation_tpu_torch.ops import compact, windowed

    slots = windowed.chunk_delta_slots

    def spy(winners, base, r, k, ring):
        log.append(compact.overflow_fraction(winners, base, r, k, ring).tolist())
        return slots(winners, base, r, k, ring)

    with _swapped(windowed, chunk_delta_slots=spy):
        yield


B7 = 2  # phase 7's batch: zsad's dense f32 volumes take about 6 GB a frame at 1080p
# phase 7 (zsad, rival on): per level the main and the rival window (A
# twice); no kernel computes zsad, so no other wrapper launches
WANT_ZSAD = NONE | {"gather_windows": 8}


def _zsad_phase(torch, engine, cfg, counters: dict, dev, card: str) -> None:
    """Phase 7: ``cost="zsad"`` at 1080p, B=2, on seeded texture pairs
    moved by (5, 9) with frame 1 through a gain of 1.1 and an offset of 12;
    only the gathers (A) may launch; the interior must hold the known
    flow; then CUDA == CPU at 256x384 (default, fourcolor, search-centred)."""
    from blockbasedmotionestimation_tpu_torch.utils import synth

    rng = np.random.default_rng(70)
    im1s, im2s = [], []
    for _ in range(B7):
        tex = synth.textured_image(H + SHIFT_Y, W + SHIFT_X, rng)
        im1s.append(synth.perturb_photometric(tex[:H, :W], rng, gain=1.1, offset=12.0))
        im2s.append(tex[SHIFT_Y:, SHIFT_X:])
    im1 = torch.as_tensor(np.stack(im1s), device=dev)
    im2 = torch.as_tensor(np.stack(im2s), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    flow, pad = engine.estimate_flow_batched(im1, im2, cfg)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[zsad] launches: {launches} (expected {WANT_ZSAD})")
    if launches != WANT_ZSAD:
        raise AssertionError("[zsad] a kernel other than the gather launched, or A did not")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(flow.shape) != (B7, pad.padded_h, pad.padded_w, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"[zsad] bad output {tuple(flow.shape)}")
    m = 64
    inner = flow[:, pad.pad_y + m : pad.pad_y + H - m, pad.pad_x + m : pad.pad_x + W - m]
    known = torch.tensor([-SHIFT_X, -SHIFT_Y], dtype=torch.float32, device=dev)
    wrong = ~(inner == known).all(-1)
    print(f"[zsad] interior pixels off the known flow {(-SHIFT_X, -SHIFT_Y)} under gain 1.1, "
          f"offset 12: {int(wrong.sum())} of {wrong.numel()}, per frame "
          f"{wrong.sum(dim=(1, 2)).tolist()}")
    if float(wrong.float().mean()) > 1e-3:
        raise AssertionError("[zsad] the path did not recover the known translation")
    batch_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        engine.estimate_flow_batched(im1, im2, cfg)
        torch.cuda.synchronize()
        batch_s.append(time.time() - t0)
    med = float(np.median(batch_s))
    print(f"[zsad] first call {first_s:.3f} s; 3 batches of {B7}: {[round(t, 4) for t in batch_s]} s, "
          f"median {med:.4f} s; {B7 / med:.3f} fields/s at the median; peak {peak_gb:.2f} GB "
          f"({card})")
    del flow, inner, im1, im2
    torch.cuda.empty_cache()

    # CUDA == CPU on a two-motion pair (the plain versions on both: exact)
    h5, w5 = 256, 384
    tex = synth.textured_image(h5 + 64, w5 + 64, rng)
    a2 = tex[32:32 + h5, 32:32 + w5]
    left = tex[32 - 3:32 - 3 + h5, 32 + 7:32 + 7 + w5]
    right = tex[32 + 5:32 + 5 + h5, 32 - 12:32 - 12 + w5]
    a1 = np.where(np.arange(w5)[None, :] < w5 // 2, left, right).astype(np.uint8)
    a1 = synth.perturb_photometric(a1, rng, gain=1.1, offset=12.0)
    for what, c in (("default", cfg), ("fourcolor", cfg.replace(regularizer="fourcolor")),
                    ("window_center=search", cfg.replace(window_center="search"))):
        t0 = time.time()
        on_gpu, _ = engine.estimate_flow_batched(a1[None], a2[None], c, device=dev)
        on_cpu, _ = engine.estimate_flow_batched(a1[None], a2[None], c, device="cpu")
        diff = int((on_gpu.cpu() != on_cpu).any(-1).sum())
        print(f"[zsad] CUDA vs CPU, {what}, {h5}x{w5}: MVs that differ {diff} of "
              f"{h5 * w5} ({time.time() - t0:.1f} s)")
        if diff:
            raise AssertionError(f"[zsad] {what}: CUDA and CPU flows differ at {diff} pixels")


TILES = 2       # phase 9's row tiles (the auto case: AUTO_TILES)
AUTO_TILES = 4
B9 = 2          # phase 9's batch for the other configurations
# a round wrapper and the single step the rounds on row strips launch
STEP_OF = {"color_round_stored": "color_step", "color_round_hybrid": "color_step_hybrid",
           "color_round_hybrid_tail": "color_step_hybrid_tail",
           "color_round_fused": "color_step_fused",
           "color_round_fused_rival": "color_step_fused_rival"}


def _want_tiled(want: dict, levels: int, tiled: int, sweeps: int) -> dict:
    """The launches of a path whose levels each launch ``want`` / levels
    (every level alike: bs 32 throughout), when ``tiled`` of its levels run
    on row strips: there each round is 4 * sweeps single steps, one launch
    each, for all strips at once; the other launches do not change."""
    out = dict(want)
    for rnd, step in STEP_OF.items():
        per_level = want[rnd] // levels
        out[rnd] = per_level * (levels - tiled)
        out[step] = want[step] + per_level * tiled * 4 * sweeps
    return out


def _device_ms(torch, run) -> float:
    """Device time (ms) of the kernels ``run()`` launches, from
    torch.profiler."""
    from blockbasedmotionestimation_tpu_torch.profile_main import _kernel_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    return sum(_kernel_us(e) for e in prof.key_averages()) / 1e3


def _median_s(torch, run, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.median(times))


def _tiled_kernels(torch, dev, cfg, im1, im2, card: str, results: dict, mesh, axis_x=None,
                   key: str = "tiled") -> None:
    """Phase 9's kernel checks on ``mesh``'s tiles (row strips, or 2-D
    tiles with ``axis_x``): one colour step of D, E and F on the tiles of
    the tiled default path (the calls recorded on the main path's B pairs,
    so on as many tiles as it runs; D at level 2, E and F at level 0), 12
    on those of the cv_fused=4 path on 2-D tiles and kernel 7 on those of
    the tiled fourcolor path (level 0; both recorded on the B9 pairs those
    paths run), each against its plain version on the same CUDA inputs,
    timed beside it.
    Row strips: E and F moved one row down the frame, so their strips start
    on odd rows (D's 5-row strips at level 2 alternate); 2-D tiles: every
    step moved one row down and one column right, so the first tile's first
    row and column are odd.  The results go to the rows' ``key``_* entries."""
    from blockbasedmotionestimation_tpu_torch.kernels import fused_step, reg_step, sad_search
    from blockbasedmotionestimation_tpu_torch.ops import regularize, search, windowed
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    calls = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.setdefault(name, []).append((a, k))
            return fn(*a, **k)
        return wrapped

    def run(c, n):
        tiled.estimate_flow_padded_batch_tiled(im1[:n], im2[:n], c, mesh, axis_x=axis_x)

    # the rounds call each round wrapper's .step on tiles: spy on those
    names = ["color_round_stored", "color_round_hybrid", "color_round_hybrid_tail"]
    if axis_x:
        names.append("color_round_fused_rival")
    rounds = {n: getattr(windowed, n) for n in names}
    saved = {n: fn.step for n, fn in rounds.items()}
    for n, fn in rounds.items():
        fn.step = spy(STEP_OF[n], saved[n])
    try:
        run(cfg, B)
        if axis_x:
            run(cfg.replace(cv_fused=FUSE), B9)
    finally:
        for n, fn in rounds.items():
            fn.step = saved[n]
    # kernel 7 on the fourcolor path's tiles
    with _swapped(search, _sad_argmin=spy("sad_spiral_argmin", search._sad_argmin)):
        run(cfg.replace(regularizer="fourcolor"), B9)
    torch.cuda.synchronize()

    def shifted(st, cur):
        """The tiles moved one row down (and on 2-D tiles one column right)
        a frame one row (column) larger: odd first rows (columns)."""
        if st.col0_b is None:
            return regularize.Strips(st.row0_b + 1, st.full_h + cur, st.ghost)
        return regularize.Strips(st.row0_b + 1, st.full_h + cur, st.ghost, st.col0_b + 1,
                                 st.full_w + cur, st.ghost_cols)

    checks = [
        ("D", "color_step", reg_step.color_step, reg_step.color_step_plain,
         lambda ks: [k for k in ks if k[1]["cur"] == 32 and k[0][0].shape[1] % 2][0],
         bool(axis_x)),
        ("E", "color_step_hybrid", fused_step.color_step_hybrid,
         fused_step.color_step_hybrid_plain, lambda ks: [k for k in ks if k[1]["cur"] == 4][-4],
         True),
        ("F", "color_step_hybrid_tail", fused_step.color_step_hybrid_tail,
         fused_step.color_step_hybrid_tail_plain, lambda ks: ks[-4], True),
    ]
    if axis_x:
        checks.append(("12", "color_step_fused_rival", fused_step.color_step_fused_rival,
                       fused_step.color_step_fused_rival_plain,
                       lambda ks: [k for k in ks if k[1]["cur"] == 4][-4], True))
    for row, name, kernel, plain, pick, shift in checks:
        a, k = pick(calls[name])
        k = dict(k)
        if shift:
            k["strips"] = shifted(k["strips"], k["cur"])
        st = k["strips"]
        odd = int((st.row0_b % 2).sum())
        odd_c = 0 if st.col0_b is None else int((st.col0_b % 2).sum())
        g0 = a[0].clone()
        gk, gp = g0.clone(), g0.clone()
        kernel(gk, *a[1:], **k)
        kw = {n: v for n, v in k.items() if n != "strips"}
        regularize.on_strips(plain, gp, *a[1:], strips=st, **kw)
        err = _max_abs_err(torch, gk, gp)
        ms = _cuda_ms(torch, lambda: kernel(g0.clone(), *a[1:], **k), 5)
        pms = _cuda_ms(torch, lambda: regularize.on_strips(plain, g0.clone(), *a[1:], strips=st,
                                                           **kw), 1)
        print(f"[{key}] {row} on {g0.shape[0]} tiles of {g0.shape[1]}x{g0.shape[2]} cells at "
              f"cur={k['cur']}, colour ({k['ci']}, {k['cj']}), {odd} tiles starting on odd "
              f"rows, {odd_c} on odd columns: max_abs_err {err}; {ms:.4f} ms, plain "
              f"{pms:.4f} ms ({card})")
        results[row].update({f"{key}_max_abs_err": err, f"{key}_step_ms": ms,
                             f"{key}_step_plain_ms": pms})
        if err:
            raise AssertionError(f"[{key}] {row} on tiles differs from its plain version")
    a, k = calls["sad_spiral_argmin"][-1]
    full_h, full_w = a[-2], a[-1]
    got = sad_search.sad_spiral_argmin(*a, **k)
    want = sad_search.sad_spiral_argmin_plain(*a, **k)
    err = max(_max_abs_err(torch, got[0], want[0]), _max_abs_err(torch, got[1], want[1]))
    ms = _cuda_ms(torch, lambda: sad_search.sad_spiral_argmin(*a, **k), 5)
    pms = _cuda_ms(torch, lambda: sad_search.sad_spiral_argmin_plain(*a, **k), 1)
    print(f"[{key}] 7 on {a[0].shape[0]} tiles of {a[0].shape[1]}x{a[0].shape[2]} (frame "
          f"{full_h}x{full_w}): max_abs_err {err}; {ms:.4f} ms, plain {pms:.4f} ms ({card})")
    results["7"].update({f"{key}_max_abs_err": err, f"{key}_ms": ms, f"{key}_plain_ms": pms})
    if err:
        raise AssertionError(f"[{key}] kernel 7 on tiles differs from its plain version")


def _tiling_phase(torch, engine, cfg, counters: dict, dev, card: str, main_rate: float,
                  results: dict) -> None:
    """Phase 9: the row tiling on the in-process transport (one card), at
    1080x1920 on phase 4's pairs and phase 4b's two-motion pairs."""
    from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    noise = np.random.default_rng(0).integers(0, 256, size=(B, H + 16, W + 16), dtype=np.uint8)
    im1 = torch.as_tensor(noise[:, :H, :W].copy(), device=dev)
    im2 = torch.as_tensor(noise[:, SHIFT_Y:SHIFT_Y + H, SHIFT_X:SHIFT_X + W].copy(), device=dev)
    p = pad_ops.compute_padding(H, W, cfg, row_tiles=TILES)
    if p != pad_ops.compute_padding(H, W, cfg):
        raise AssertionError("the tile-aware padding differs from the untiled one")
    a, b = pad_ops.pad_frame(im1, p), pad_ops.pad_frame(im2, p)
    mesh = tiled.Mesh((1, TILES))
    plan = tiled.plan_tiling(cfg, p.padded_h, p.padded_w, TILES)
    print(f"[tiled] default, {TILES} row tiles, {p.padded_h}x{p.padded_w}: "
          + ", ".join(f"level {e['level']} rows_ok {e['rows_ok']} (halo {e['halo']}, strip "
                      f"{e['strip_h']})" for e in plan))
    if [e["rows_ok"] for e in plan] != [True, True, True, False]:
        raise AssertionError("levels 0-2 should shard and level 3 replicate")
    n_tiled = sum(e["rows_ok"] for e in plan)
    want = _want_tiled(WANT_LAUNCHES, cfg.num_levels, n_tiled, cfg.sweeps_per_round)

    def run():
        return tiled.estimate_flow_padded_batch_tiled(a, b, cfg, mesh)

    got = _counted(counters, want, "tiled", run)
    untiled = _counted(counters, WANT_LAUNCHES, "tiled: the untiled batch",
                       lambda: engine.estimate_flow_padded(a, b, cfg))
    _equal_flows(torch, got, untiled, f"the untiled flow ({TILES} row tiles, default)", "tiled")
    launches = {n: c for n, c in want.items() if c}
    print(f"[tiled] launches a batch of {B}, tiled {launches}; untiled "
          f"{ {n: c for n, c in WANT_LAUNCHES.items() if c} }")
    tiled_s = _median_s(torch, run, 5)
    untiled_s = _median_s(torch, lambda: engine.estimate_flow_padded(a, b, cfg), 5)
    dev_t = _device_ms(torch, run)
    dev_u = _device_ms(torch, lambda: engine.estimate_flow_padded(a, b, cfg))
    print(f"[tiled] B={B}: tiled {B / tiled_s:.3f} fields/s (median of 5, {tiled_s * 1e3:.3f} "
          f"ms), device {dev_t:.3f} ms, idle share {1 - dev_t / (tiled_s * 1e3):.4f}; untiled "
          f"{B / untiled_s:.3f} fields/s ({untiled_s * 1e3:.3f} ms), device {dev_u:.3f} ms, idle "
          f"share {1 - dev_u / (untiled_s * 1e3):.4f}; phase 4 {main_rate:.3f} fields/s ({card})")
    del got, untiled
    torch.cuda.empty_cache()

    # the two-motion pairs: the rival windows decide cells at strip edges too
    tm1, tm2, _ = _two_motion(H, W, B, np.random.default_rng(1))
    t1 = pad_ops.pad_frame(torch.as_tensor(tm1, device=dev), p)
    t2 = pad_ops.pad_frame(torch.as_tensor(tm2, device=dev), p)
    _equal_flows(torch, tiled.estimate_flow_padded_batch_tiled(t1, t2, cfg, mesh),
                 engine.estimate_flow_padded(t1, t2, cfg), "the untiled flow (two motions)",
                 "tiled")
    del t1, t2
    torch.cuda.empty_cache()

    # estimate_flow_tiled_auto on 4 row tiles: the uncapped level-0 halo
    # swallows a 320-row strip, so a cap is derived; equal to the untiled
    # engine at that cap on the same tile-aware padding
    cap = tiled.derive_mv_cap(cfg, H, W, AUTO_TILES)
    capped = cfg.replace(mv_cap=cap)
    pa = pad_ops.compute_padding(H, W, capped, row_tiles=AUTO_TILES)
    auto_plan = tiled.plan_tiling(capped, pa.padded_h, pa.padded_w, AUTO_TILES)
    print(f"[tiled] auto, {AUTO_TILES} row tiles: uncapped level-0 halo "
          f"{tiled.im2_halo(cfg, 0)} rows against {pa.padded_h // AUTO_TILES}-row strips; "
          f"derived mv_cap {cap}; rows_ok per level {[e['rows_ok'] for e in auto_plan]}")
    if cap is None or not auto_plan[0]["rows_ok"]:
        raise AssertionError("the auto path should derive a cap and shard level 0")
    auto_mesh = tiled.Mesh((1, AUTO_TILES))
    for bi in range(B9):
        got = tiled.estimate_flow_tiled_auto(im1[bi], im2[bi], cfg, auto_mesh)
        want_f = engine.estimate_flow_padded(pad_ops.pad_frame(im1[bi:bi + 1], pa),
                                             pad_ops.pad_frame(im2[bi:bi + 1], pa), capped)
        _equal_flows(torch, got[None], want_f[:, pa.pad_y:pa.pad_y + H, pa.pad_x:pa.pad_x + W],
                     f"the untiled flow at mv_cap={cap} (pair {bi})", "tiled auto")
    auto_s = _median_s(torch, lambda: tiled.estimate_flow_tiled_auto(im1[0], im2[0], cfg,
                                                                     auto_mesh), 3)
    plain_s = _median_s(torch, lambda: engine.estimate_flow_padded(
        pad_ops.pad_frame(im1[:1], pa), pad_ops.pad_frame(im2[:1], pa), capped), 3)
    print(f"[tiled auto] one pair: {auto_s * 1e3:.3f} ms on {AUTO_TILES} tiles, untiled at the "
          f"same cap {plain_s * 1e3:.3f} ms (medians of 3; {card})")

    # the search-then-regularize and capacity configurations on 2 tiles, B=2
    for tag, c, w0 in (("fourcolor", cfg.replace(regularizer="fourcolor"), WANT_FOURCOLOR),
                       ("search", cfg.replace(window_center="search"), WANT_SEARCH),
                       ("fused", cfg.replace(cv_fused=FUSE), WANT_FUSED)):
        cplan = tiled.plan_tiling(c, p.padded_h, p.padded_w, TILES)
        n_c = sum(e["rows_ok"] for e in cplan)
        want_c = _want_tiled(w0, c.num_levels, n_c, c.sweeps_per_round)
        t0 = time.time()
        got = _counted(counters, want_c, f"tiled {tag}",
                       lambda: tiled.estimate_flow_padded_batch_tiled(a[:B9], b[:B9], c, mesh))
        _equal_flows(torch, got, engine.estimate_flow_padded(a[:B9], b[:B9], c),
                     f"the untiled flow ({TILES} row tiles, rows_ok "
                     f"{[e['rows_ok'] for e in cplan]}, B={B9})", f"tiled {tag}")
        ts = _median_s(torch, lambda: tiled.estimate_flow_padded_batch_tiled(a[:B9], b[:B9], c,
                                                                            mesh), 3)
        us = _median_s(torch, lambda: engine.estimate_flow_padded(a[:B9], b[:B9], c), 3)
        print(f"[tiled {tag}] B={B9}: tiled {B9 / ts:.3f} fields/s ({ts * 1e3:.3f} ms), untiled "
              f"{B9 / us:.3f} ({us * 1e3:.3f} ms), medians of 3 ({card}); "
              f"{time.time() - t0:.1f} s")
    del got
    torch.cuda.empty_cache()
    _tiled_kernels(torch, dev, cfg, a, b, card, results, mesh)
    torch.cuda.empty_cache()
    _tiles_2d(torch, engine, cfg, counters, card, results, a, b, p, main_rate)


TY2, TX2 = 2, 2  # phase 9's 2-D mesh


def _tiles_2d(torch, engine, cfg, counters: dict, card: str, results: dict, a, b, p,
              main_rate: float) -> None:
    """Phase 9, 2-D part: the (ty=2, tx=2) tiling on the in-process
    transport at 1080x1920 (padded a, b: phase 4's B=8 pairs)."""
    from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    t0 = time.time()
    mesh = tiled.Mesh((1, TY2, TX2), ("batch", "ty", "tx"))
    plan = tiled.plan_tiling(cfg, p.padded_h, p.padded_w, TY2, TX2)
    print(f"[tiled 2d] default, {TY2}x{TX2} tiles, {p.padded_h}x{p.padded_w}: "
          + ", ".join(f"level {e['level']} rows_ok {e['rows_ok']} cols_ok {e['cols_ok']} (halo "
                      f"{e['halo']}, tile {e['strip_h']}x{e['strip_w']})" for e in plan))
    if [(e["rows_ok"], e["cols_ok"]) for e in plan] != [(True, True)] * 3 + [(False, True)]:
        raise AssertionError("levels 0-2 should run on 2-D tiles and level 3 whole-frame")
    # levels 0-2 run as single steps (8 a round), on 2-D tiles; level 3's
    # rounds stay one launch each
    want = _want_tiled(WANT_LAUNCHES, cfg.num_levels, 3, cfg.sweeps_per_round)
    print(f"[tiled 2d] launches expected a batch of {B}: { {n: c for n, c in want.items() if c} }")

    def run():
        return tiled.estimate_flow_padded_batch_tiled(a, b, cfg, mesh, axis_x="tx")

    def untiled_run():
        return engine.estimate_flow_padded(a, b, cfg)

    got = _counted(counters, want, "tiled 2d", run)
    _equal_flows(torch, got, untiled_run(), f"the untiled flow ({TY2}x{TX2} tiles, default)",
                 "tiled 2d")
    del got
    tiled_s = _median_s(torch, run, 5)
    untiled_s = _median_s(torch, untiled_run, 5)
    dev_t = _device_ms(torch, run)
    dev_u = _device_ms(torch, untiled_run)
    print(f"[tiled 2d] B={B}: {TY2}x{TX2} tiles {B / tiled_s:.3f} fields/s (median of 5, "
          f"{tiled_s * 1e3:.3f} ms), device {dev_t:.3f} ms, idle share "
          f"{1 - dev_t / (tiled_s * 1e3):.4f}; untiled {B / untiled_s:.3f} fields/s "
          f"({untiled_s * 1e3:.3f} ms), device {dev_u:.3f} ms, idle share "
          f"{1 - dev_u / (untiled_s * 1e3):.4f}; phase 4 {main_rate:.3f} fields/s ({card})")
    torch.cuda.empty_cache()

    # the two-motion pairs: the rival windows decide cells at tile edges and
    # corners too
    tm1, tm2, _ = _two_motion(H, W, B, np.random.default_rng(1))
    t1 = pad_ops.pad_frame(torch.as_tensor(tm1, device=a.device), p)
    t2 = pad_ops.pad_frame(torch.as_tensor(tm2, device=a.device), p)
    _equal_flows(torch, tiled.estimate_flow_padded_batch_tiled(t1, t2, cfg, mesh, axis_x="tx"),
                 engine.estimate_flow_padded(t1, t2, cfg), "the untiled flow (two motions)",
                 "tiled 2d")
    del t1, t2
    torch.cuda.empty_cache()

    # estimate_flow_tiled_auto with axis_x on 2x2: at 1080p the uncapped
    # level-0 halo fits the 640 x 1024 tiles, so no cap is derived
    cap = tiled.derive_mv_cap(cfg, H, W, TY2, TX2)
    print(f"[tiled 2d auto] {TY2}x{TX2} tiles: derived mv_cap {cap}")
    if cap is not None:
        raise AssertionError("no cap should be needed on 2x2 tiles at 1080p")
    auto_mesh = tiled.Mesh((TY2, TX2), ("ty", "tx"))
    im1 = a[:, p.pad_y:p.pad_y + H, p.pad_x:p.pad_x + W]
    im2 = b[:, p.pad_y:p.pad_y + H, p.pad_x:p.pad_x + W]
    for bi in range(B9):
        got = tiled.estimate_flow_tiled_auto(im1[bi], im2[bi], cfg, auto_mesh, axis_x="tx")
        want_f = engine.estimate_flow_padded(a[bi:bi + 1], b[bi:bi + 1], cfg)
        _equal_flows(torch, got[None], want_f[:, p.pad_y:p.pad_y + H, p.pad_x:p.pad_x + W],
                     f"the untiled flow (pair {bi})", "tiled 2d auto")

    # the search-then-regularize and capacity configurations on 2x2, B=2
    for tag, c, w0 in (("fourcolor", cfg.replace(regularizer="fourcolor"), WANT_FOURCOLOR),
                       ("search", cfg.replace(window_center="search"), WANT_SEARCH),
                       ("fused", cfg.replace(cv_fused=FUSE), WANT_FUSED)):
        cplan = tiled.plan_tiling(c, p.padded_h, p.padded_w, TY2, TX2)
        # a level with rows_ok runs as single steps, on 2-D tiles or strips
        want_c = _want_tiled(w0, c.num_levels, sum(e["rows_ok"] for e in cplan),
                             c.sweeps_per_round)
        t1 = time.time()
        got = _counted(counters, want_c, f"tiled 2d {tag}",
                       lambda: tiled.estimate_flow_padded_batch_tiled(a[:B9], b[:B9], c, mesh,
                                                                      axis_x="tx"))
        _equal_flows(torch, got, engine.estimate_flow_padded(a[:B9], b[:B9], c),
                     f"the untiled flow ({TY2}x{TX2} tiles, rows_ok/cols_ok "
                     f"{[(e['rows_ok'], e['cols_ok']) for e in cplan]}, B={B9})",
                     f"tiled 2d {tag}")
        ts = _median_s(torch, lambda: tiled.estimate_flow_padded_batch_tiled(
            a[:B9], b[:B9], c, mesh, axis_x="tx"), 3)
        us = _median_s(torch, lambda: engine.estimate_flow_padded(a[:B9], b[:B9], c), 3)
        print(f"[tiled 2d {tag}] B={B9}: tiled {B9 / ts:.3f} fields/s ({ts * 1e3:.3f} ms), "
              f"untiled {B9 / us:.3f} ({us * 1e3:.3f} ms), medians of 3 ({card}); "
              f"{time.time() - t1:.1f} s")
    del got
    torch.cuda.empty_cache()
    _tiled_kernels(torch, a.device, cfg, a, b, card, results, mesh, axis_x="tx", key="tiles2d")
    print(f"[tiled 2d] took {time.time() - t0:.1f} s")


def _counted(counters: dict, want: dict, tag: str, run):
    """Run ``run()`` with every launch count set to 0 just before it; the
    counts read just after must equal ``want``."""
    for fn in counters.values():
        fn.launches = 0
    out = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[{tag}] launches: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"[{tag}] the path did not launch its kernels as expected")
    return out


def _sequence_phase(torch, engine, cfg, counters: dict, dev, card: str,
                    fields_per_s: float) -> None:
    """Phase 8: the sequence runner and the CLI on the card, on six seeded
    1080p frames of a texture moving by (5, 9) a frame: every .flo equals
    the driver's field on its pair (f32; strided f16 too), a second run
    resumes every pair, and the CLI's estimate equals the driver; the
    runner and the CLI launch the main path's kernels, as many times as
    phase 4's batch a call."""
    import tempfile

    from blockbasedmotionestimation_tpu_torch import cli
    from blockbasedmotionestimation_tpu_torch.models import sequence
    from blockbasedmotionestimation_tpu_torch.utils import flowio, synth

    n = 6
    tex = synth.textured_image(H + SHIFT_Y * n, W + SHIFT_X * n, np.random.default_rng(80))
    frames = [np.ascontiguousarray(tex[SHIFT_Y * (n - 1 - k):SHIFT_Y * (n - 1 - k) + H,
                                       SHIFT_X * (n - 1 - k):SHIFT_X * (n - 1 - k) + W])
              for k in range(n)]
    want = [engine.estimate_flow_driver(frames[i], frames[i + 1], cfg, device=dev).cpu().numpy()
            for i in range(n - 1)]
    with tempfile.TemporaryDirectory() as tmp:
        one, four = f"{tmp}/one", f"{tmp}/four"
        calls = {name: k * (n - 1) for name, k in WANT_LAUNCHES.items()}  # a call a pair
        res = _counted(counters, calls, "sequence, batch 1", lambda: sequence.run_sequence(
            frames, one, cfg, batch_size=1, device=dev))
        calls = {name: k * 2 for name, k in WANT_LAUNCHES.items()}  # batches of 4 and 1
        res4 = _counted(counters, calls, "sequence, batch 4", lambda: sequence.run_sequence(
            frames, four, cfg, batch_size=4, out_stride=2, transfer_dtype="f16", device=dev))
        for i in range(n - 1):
            got = flowio.read_flo(f"{one}/{sequence.flo_name(i)}")
            if not np.array_equal(got, want[i]):
                raise AssertionError(f"[sequence] pair {i}: the .flo differs from the driver's")
            got = flowio.read_flo(f"{four}/{sequence.flo_name(i)}")
            if not np.array_equal(got, want[i][::2, ::2]):
                raise AssertionError(f"[sequence] pair {i}: the strided f16 .flo differs")
        again = sequence.run_sequence(frames, one, cfg, device=dev)
        if not all(r.skipped for r in again) or len(again) != n - 1:
            raise AssertionError("[sequence] the second run did not resume every pair")
        rates = [len(r) / sum(x.seconds for x in r) for r in (res, res4)]
        print(f"[sequence] {n - 1} pairs at {H}x{W}: every .flo == estimate_flow_driver on its "
              f"pair; batch 1 {rates[0]:.3f} pairs/s, batch 4 (stride 2, f16) {rates[1]:.3f} "
              f"pairs/s, beside phase 4's {fields_per_s:.3f} fields/s; a second run resumed "
              f"{len(again)} pairs ({card})")
        # the engine alone on the same pairs, frames already on the card:
        # what the runner's uploads, downloads and writes add
        a = torch.as_tensor(np.stack(frames[:4]), device=dev)
        b = torch.as_tensor(np.stack(frames[1:5]), device=dev)
        alone = {}
        for nb in (1, 4):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.time()
                engine.estimate_flow_driver_batched(a[:nb], b[:nb], cfg)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
            alone[nb] = nb / float(np.median(times))
        print(f"[sequence] estimate_flow_driver_batched alone, median of 3: batch 1 "
              f"{alone[1]:.3f} pairs/s, batch 4 {alone[4]:.3f} pairs/s ({card})")
        paths = [f"{tmp}/f{k}.png" for k in (0, 1)]
        for path, f in zip(paths, frames):
            flowio.write_image(path, f)
            if not np.array_equal(flowio.read_gray(path), f):
                raise AssertionError(f"[cli] {path} does not read back as written")
        out = f"{tmp}/cli.flo"
        if _counted(counters, WANT_LAUNCHES, "cli estimate",
                    lambda: cli.main(["estimate", *paths, out, "--interp", "1"])) != 0:
            raise AssertionError("[cli] estimate failed")
        if not np.array_equal(flowio.read_flo(out), want[0]):
            raise AssertionError("[cli] the estimate's .flo differs from the driver's")
        if cli.main(["evaluate", out, f"{one}/{sequence.flo_name(0)}"]) != 0:
            raise AssertionError("[cli] evaluate failed")
        print("[cli] estimate on two PNG frames == estimate_flow_driver; evaluate returned 0")


PHASE10_S = 180  # phase 10's time budget
# phase 10(a): the exact configurations of tests/test_engine.py's
# engine-vs-oracle test (32x48, moved by (1, -2)), its raster one, its
# driver one (20x26, interp 2) and the reference's structure (4 levels of
# 32 px blocks, 64 px search, interp 2: 192x224 frames pad to 512x512, the
# least size at which level 3 keeps the 2x2 block grid the reference needs)
ORACLE_EXACT = [((4,), (8,)), ((4, 4), (8, 8)), ((4, 4), (12, 8)), ((2, 4, 4), (6, 8, 12))]
STRUCTURE = (192, 224)
# phase 10(b): the port's stages, in pipeline order: the work they do
# (what the line names), the functions that do it (module, name), each call
# of one batch replayed under CUDA events, and JAX's model terms that count
# that work
MODEL_STAGES = {
    "pyramid": ("the resample ops", [("resample", "build_pyramid")], ("pyramid",)),
    "gather": ("A", [("search", "_gather")], ("gather",)),
    "cv_build": ("B", [("windowed", "pooled_cvs")], ("cv_build",)),
    "rival_build": ("C", [("windowed", "deep_pooled_cvs")], ("rival_build",)),
    "search": ("the spiral argmin ops", [("windowed", "spiral_argmin")], ("search",)),
    "rounds": ("the rounds D, E, F", [("windowed", "color_round_stored"),
                                      ("windowed", "color_round_hybrid"),
                                      ("windowed", "color_round_hybrid_tail")],
               ("cv_stream", "rival", "step_operands", "step_compute")),
    "mv_bookkeeping": ("subdivide and transfer", [("windowed", "subdivide"),
                                                  ("engine", "transfer_mvs")],
                       ("mv_bookkeeping",)),
}


def _shifted_pair(rng: np.random.Generator, h: int, w: int, dy: int, dx: int, margin: int = 8):
    """A random base image and a crop pair moved by (dy, dx), as the JAX
    package's engine-vs-oracle tests make them (uint8)."""
    base = rng.integers(0, 256, size=(h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    im1 = base[margin:margin + h, margin:margin + w].copy()
    im2 = base[margin + dy:margin + dy + h, margin + dx:margin + dx + w].copy()
    return im1, im2


def _oracle_run(kind: str, cfg, im1: np.ndarray, im2: np.ndarray):
    """One case of the port's oracle (in a worker process): (flow, seconds)."""
    from blockbasedmotionestimation_tpu_torch.models import oracle

    fn = oracle.calc_motion_block_matching if kind == "padded" else oracle.estimate_flow_driver
    t0 = time.perf_counter()
    out = fn(im1, im2, cfg)
    return out, time.perf_counter() - t0


def _oracle_cases(MotionConfig, pad_ops) -> list:
    """(tag, kind, cfg, im1, im2, spiral) of phase 10(a), the longest first."""
    rng = np.random.default_rng(14)
    exact = MotionConfig(interp_factor=1, regularizer="exact")
    structure = exact.replace(block_sizes=(32,) * 4, search_sizes=(64,) * 4, interp_factor=2)
    cases = [(f"structure {STRUCTURE[0]}x{STRUCTURE[1]}", "driver", structure,
              *_shifted_pair(rng, *STRUCTURE, 2, -3), True)]
    configs = [(f"exact {bs}/{ss}", exact.replace(block_sizes=bs, search_sizes=ss), True)
               for bs, ss in ORACLE_EXACT]
    configs.append(("raster (4, 4)/(12, 12)", exact.replace(
        block_sizes=(4, 4), search_sizes=(12, 12), search_order="raster"), False))
    for tag, cfg, spiral in configs:
        a, b = _shifted_pair(rng, 32, 48, 1, -2)
        p = pad_ops.compute_padding(32, 48, cfg)
        pad = ((p.pad_y, p.pad_y), (p.pad_x, p.pad_x))
        cases.append((f"{tag} 32x48", "padded", cfg, np.pad(a, pad), np.pad(b, pad), spiral))
    cases.append(("driver (4, 4)/(8, 8) 20x26", "driver",
                  exact.replace(block_sizes=(4, 4), search_sizes=(8, 8), interp_factor=2),
                  *_shifted_pair(rng, 20, 26, 1, -1), True))
    return cases


def _oracle_phase(torch, engine, MotionConfig, counters: dict, dev, card: str) -> None:
    """10(a): the CUDA engine against the port's oracle, bit for bit.  The
    oracle runs in worker processes while the engine runs on the card; each
    case's launches of A and kernel 7 are counted from 0 around its engine
    run, and every spiral case must launch both."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cases = _oracle_cases(MotionConfig, engine.pad_ops)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=3, mp_context=ctx) as pool:
        pending = [pool.submit(_oracle_run, kind, cfg, a, b) for _, kind, cfg, a, b, _ in cases]
        ran = []
        for tag, kind, cfg, a, b, spiral in cases:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "padded":
                got = engine.estimate_flow_padded(torch.as_tensor(a, device=dev)[None],
                                                  torch.as_tensor(b, device=dev)[None], cfg)[0]
            else:
                got = engine.estimate_flow_driver(a, b, cfg, device=dev)
            torch.cuda.synchronize()
            port_s = time.perf_counter() - t0
            if got.device.type != "cuda":
                raise AssertionError(f"[oracle] {tag}: the engine ran on {got.device}")
            launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
            ran.append((got.cpu().numpy(), port_s, launches))
        bad = []
        for (tag, kind, cfg, a, b, spiral), fut, (got, port_s, launches) in zip(cases, pending, ran):
            want, oracle_s = fut.result()
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"[oracle] {tag}: engine {got.shape} vs oracle {want.shape}")
            err = float(np.abs(got - want).max())
            a_n, k7 = launches.get("gather_windows", 0), launches.get("sad_spiral_argmin", 0)
            print(f"[oracle] {tag}, {kind}, {tuple(a.shape)} frames: max_abs_err {err} "
                  f"({int((got != want).any(-1).sum())} pixels differ); oracle {oracle_s:.3f} s, "
                  f"port on the card {port_s:.3f} s; launches {launches} ({card})")
            if err != 0:
                bad.append(tag)
            if spiral and (a_n == 0 or k7 == 0):
                bad.append(f"{tag}: A {a_n}, kernel 7 {k7} launches")
    if bad:
        raise AssertionError(f"[oracle] the CUDA engine and the oracle disagree: {bad}")


def _stage_calls(torch, engine, cfg, im1, im2) -> list:
    """(term, fn, args, kwargs) of each call one batch makes to a stage of
    ``MODEL_STAGES``, the rounds with a copy of the grid they met."""
    from blockbasedmotionestimation_tpu_torch.ops import resample, search, windowed

    modules = {"resample": resample, "search": search, "windowed": windowed, "engine": engine}
    calls = []

    def spy(term, fn, in_place):
        def call(*args, **kw):
            rec = (args[0].clone(), *args[1:]) if in_place else args
            calls.append((term, fn, rec, kw))
            return fn(*args, **kw)
        call.per_round = getattr(fn, "per_round", False)
        return call

    with contextlib.ExitStack() as stack:
        for stage, (_, fns, _) in MODEL_STAGES.items():
            for mod, name in fns:
                fn = getattr(modules[mod], name)
                stack.enter_context(_swapped(modules[mod],
                                             **{name: spy(stage, fn, stage == "rounds")}))
        engine.estimate_flow_batched(im1, im2, cfg)
    return calls


def _work_model_phase(torch, engine, cfg, im1, im2, card: str) -> None:
    """10(b): JAX's work model of the windowed pipeline, term by term,
    beside the time of the port's stages that do that work on phase 4's
    batch (each stage's calls of one batch replayed, the rounds on copies
    of their grids, under CUDA events queued behind a sleep as ``_cuda_ms``
    times them: the card's time wherever the stage does not wait for the
    host; the plain stages, the pyramid, the spiral argmin and the
    transfer, read tables copied to the card once, so they do not wait), then
    the model's floor beside the batch's device time (torch.profiler).  A
    term whose model exceeds its measured time is marked: it counts work
    the port does not do.  A record: nothing raises on the marks."""
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    pad = engine.pad_ops.compute_padding(H, W, cfg)
    per_batch = 1e3 * B  # the models count one field, in seconds
    roof = profiling.windowed_pipeline_roofline(cfg, pad.padded_h, pad.padded_w)["components"]
    floor = profiling.windowed_pipeline_floor(cfg, pad.padded_h, pad.padded_w)
    calls = _stage_calls(torch, engine, cfg, im1, im2)
    print(f"[model] JAX's work model of the windowed pipeline (utils/profiling.py) at the H100's "
          f"rates ({profiling.HBM_BYTES_PER_S:.3g} B/s, {profiling.CORE_OPS_PER_S:.3g} ops/s), "
          f"{pad.padded_h}x{pad.padded_w}, B={B}, per batch; measured: CUDA events around each "
          f"stage's calls of one batch of phase 4's pairs, replayed behind a sleep ({card})")
    over, stages_ms = [], 0.0
    for stage, (work, _, terms) in MODEL_STAGES.items():
        mine = [(fn, args, kw) for t, fn, args, kw in calls if t == stage]

        def replay(mine=mine, in_place=stage == "rounds"):
            for fn, args, kw in mine:
                if in_place:
                    args = (args[0].clone(), *args[1:])
                fn(*args, **kw)

        ms = _cuda_ms(torch, replay, 3, queued=True)
        stages_ms += ms
        rows = [(t, roof[t]) for t in terms]
        if len(terms) > 1:
            rows.append((f"{stage} (sum)", {k: sum(roof[t][k] for t in terms)
                                            for k in ("hbm_bytes", "int_ops", "floor_s")}))
        for term, c in rows:
            model = c["floor_s"] * per_batch
            if model > ms:
                over.append(term)
            print(f"[model] {term:<15} model {model:8.4f} ms ({c['hbm_bytes'] * B / 1e9:.4f} GB, "
                  f"{c['int_ops'] * B / 1e9:.4f} G ops) | {work}: {ms:8.4f} ms over {len(mine)} "
                  f"calls | {'OVER' if model > ms else 'under'}, {model / ms:.2f}x ({card})")
    del calls
    batch_ms = _device_ms(torch, lambda: engine.estimate_flow_batched(im1, im2, cfg))
    if batch_ms <= 0:
        raise AssertionError("[model] the profiler saw no device time in the batch")
    total = sum(roof[t]["floor_s"] for t in roof) * per_batch
    fl = floor["floor_s"] * per_batch
    print(f"[model] roofline total {total:.4f} ms; windowed_pipeline_floor {fl:.4f} ms "
          f"({floor['hbm_bytes'] * B / 1e9:.4f} GB, {floor['int_ops'] * B / 1e9:.4f} G ops, "
          f"bound by {'bytes' if floor['hbm_s'] >= floor['ops_s'] else 'operations'}) | the batch's "
          f"device time {batch_ms:.4f} ms (the stages above {stages_ms:.4f}) | floor "
          f"{'OVER' if fl > batch_ms else 'under'} the batch, {fl / batch_ms:.2f}x ({card})")
    print(f"[model] terms above their measured stage (work the port does not do): {over}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from blockbasedmotionestimation_tpu_torch import MotionConfig
    from blockbasedmotionestimation_tpu_torch.kernels import _build
    from blockbasedmotionestimation_tpu_torch.models import engine

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _cmd_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])

    # 1. environment
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"triton {'present' if importlib.util.find_spec('triton') else 'absent'}")
    print(f"[env] nvcc: {_cmd_line([_build.nvcc_path(), '--version'], pick='release')}")

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {time.time() - t0:.1f} s -> {lib_path}")
    for ln in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(f"[build] {ln.strip()}")

    # 3. kernels against their plain versions at the 1080p level-0 shapes
    cfg = MotionConfig(interp_factor=1)
    rng = np.random.default_rng(0)
    results = _kernels_vs_plain(torch, dev, cfg, card, rng)
    _resample_vs_plain(torch, dev, card, rng)
    _volume_sweep(torch, dev, card, rng)
    _tables_sweep(torch, dev, card, rng)
    torch.cuda.empty_cache()

    # 4. the main path: default config, 8 pairs at 1080p, made as bench.py
    #    makes them (seeded noise; frame 2 = frame 1 moved by (-5, -9))
    im1, im2 = _main_pairs(torch, dev)
    # 3 (end). B and C at each level's shapes of this path, per-batch sums
    for row, timed in _volume_levels(torch, engine, cfg, im1, im2, card).items():
        results[row].update(timed)
    torch.cuda.empty_cache()
    # 14 at each level's shapes of the cv_compact path
    results["14"].update(_volume_levels(
        torch, engine, cfg.replace(cv_compact=COMPACT_K, rival_window=False), im1, im2, card,
        rows=(("14", "compact_tables"),),
        work_of={"14": lambda args, out: _tables_work(*args[:3], out)},
        queued=True,
    )["14"])
    torch.cuda.empty_cache()
    results["A"].update(_gather_levels(torch, engine, cfg, im1, im2, card))
    for row, timed in _round_levels(torch, engine, cfg, im1, im2, card).items():
        err = max(results[row]["max_abs_err"], timed.pop("max_abs_err"))
        results[row].update(timed, max_abs_err=err)
    torch.cuda.empty_cache()
    counters = _kernel_counters()
    by_path, by_row = {}, {}
    by_path["main"], by_row["main"], main_flow, main_rate = _drive(
        torch, engine, cfg, im1, im2, counters, WANT_LAUNCHES, "main", card)
    torch.cuda.empty_cache()

    # 4b. two motions per frame at 1080p, B=8: the rival windows decide cells
    #     (the rival-off run differs), the band and the hybrid form change no
    #     bit, and every frame equals the plain path
    tm1, tm2, tflow = _two_motion(H, W, B, np.random.default_rng(1))
    tm1, tm2 = torch.as_tensor(tm1, device=dev), torch.as_tensor(tm2, device=dev)
    flow, pad = engine.estimate_flow_batched(tm1, tm2, cfg)
    m = 64
    no_band, _ = engine.estimate_flow_batched(tm1, tm2, cfg.replace(cv_store_radius=None))
    with _dense_rival_form():
        dense_form, _ = engine.estimate_flow_batched(tm1, tm2, cfg)
    for other, what in ((no_band, "cv_store_radius=None"), (dense_form, "the dense-rival form")):
        if not torch.equal(flow, other):
            diff = int((flow != other).any(-1).sum())
            raise AssertionError(f"two-motion batch: {what} differs from the default at {diff} pixels")
    print(f"[two-motion] cv_store_radius=4 == cv_store_radius=None == the dense-rival form, "
          f"all {B} frames")
    fused, _ = engine.estimate_flow_batched(tm1, tm2, cfg.replace(cv_fused=FUSE))
    _equal_flows(torch, fused, flow, "the default's (kernel 12 decides the rival cells)",
                 "two-motion, cv_fused")
    del no_band, dense_form, fused
    no_rival, _ = engine.estimate_flow_batched(tm1, tm2, cfg.replace(rival_window=False))
    crop = (slice(None), slice(pad.pad_y, pad.pad_y + H), slice(pad.pad_x, pad.pad_x + W))
    decided = int((flow[crop] != no_rival[crop]).any(-1).sum())
    inner = (slice(None), slice(m, H - m), slice(m, W - m))
    at_known = (flow[crop][inner] == torch.as_tensor(tflow, device=dev)[inner]).all(-1)
    print(f"[two-motion] B={B} at {H}x{W}: pixels changed by the rival windows {decided}; "
          f"interior at the known flows {float(at_known.float().mean()):.6f}, per frame "
          f"{at_known.float().mean(dim=(1, 2)).tolist()}")
    _same_as_plain(torch, engine, cfg, tm1, tm2, flow, "two-motion")
    if decided == 0:
        raise AssertionError("the rival windows decided no pixel of the two-motion batch")
    if float(at_known.float().mean()) < 0.97:
        raise AssertionError("two-motion batch: fewer than 97% of interior pixels at the known flows")
    del tm1, tm2, flow, no_rival, at_known
    torch.cuda.empty_cache()

    # 4c, 4d. the search-then-regularize paths on the pairs of phase 4
    for tag, c, want in (("fourcolor", cfg.replace(regularizer="fourcolor"), WANT_FOURCOLOR),
                         ("search", cfg.replace(window_center="search"), WANT_SEARCH)):
        by_path[tag], by_row[tag], _, _ = _drive(torch, engine, c, im1, im2, counters, want, tag,
                                              card, reps=5)
        torch.cuda.empty_cache()

    # 4e, 4f, 4g. the capacity modes on the pairs of phase 4: cv_fused with
    # and without rival windows, cv_compact without (with rival windows it
    # does nothing); each flow equals the dense path's
    no_rival_cfg = cfg.replace(rival_window=False)
    no_rival_flow, _ = engine.estimate_flow_batched(im1, im2, no_rival_cfg)
    for tag, c, want, ref, what in (
        ("fused", cfg.replace(cv_fused=FUSE), WANT_FUSED, main_flow, "the default's"),
        ("fused-norival", no_rival_cfg.replace(cv_fused=FUSE), WANT_FUSED_NORIVAL, no_rival_flow,
         "the rival-off default's"),
        ("compact", no_rival_cfg.replace(cv_compact=COMPACT_K), WANT_COMPACT, no_rival_flow,
         "the rival-off default's"),
    ):
        by_path[tag], by_row[tag], out, _ = _drive(torch, engine, c, im1, im2, counters, want,
                                                tag, card, reps=5)
        overflow = []
        if tag == "compact":
            with _overflow_log(overflow):  # one more batch, untimed (the log syncs)
                engine.estimate_flow_batched(im1, im2, c)
            print(f"[{tag}] overflow_fraction per level, coarsest first, per frame: {overflow}")
        if all(max(o) == 0.0 for o in overflow):
            _equal_flows(torch, out, ref, what, tag)
        else:
            diff = int((out != ref).any(-1).sum())
            print(f"[{tag}] chunks overflow: the flow differs from {what} at {diff} pixels")
        del out
        torch.cuda.empty_cache()
    # K = side^2 slots hold every delta of the window, so no chunk overflows;
    # a slot list still holds only the winners within cv_compact_ring
    # parents, so a value that travels further in the rounds is excluded
    # (the reference's semantics).  With a ring spanning the whole frame
    # nothing is excluded, and the compact path (13, 14, 10) must give the
    # dense path's flow.
    from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent

    side = 2 * spiral_extent(cfg.search_sizes[0] - cfg.block_sizes[0]) + 1
    padded = engine.pad_ops.compute_padding(H, W, cfg)
    whole = max(padded.padded_h, padded.padded_w) // cfg.block_sizes[0]
    for ring in (no_rival_cfg.cv_compact_ring, whole):
        tag = f"compact K={side * side} ring={ring}"
        overflow = []
        with _overflow_log(overflow):
            out, _ = engine.estimate_flow_batched(
                im1, im2, no_rival_cfg.replace(cv_compact=side * side, cv_compact_ring=ring))
        assert all(max(o) == 0.0 for o in overflow), overflow
        if ring == whole:
            _equal_flows(torch, out, no_rival_flow, "the rival-off default's", tag)
        else:
            diff = int((out != no_rival_flow).any(-1).sum())
            print(f"[{tag}] no chunk overflows; the flow differs from the rival-off default's at "
                  f"{diff} pixels")
        del out
        torch.cuda.empty_cache()
    del im1, im2, main_flow, no_rival_flow

    # each TPU kernel row's launches: on the default path, else on the first
    # path that runs it
    paths = {"main": "MotionConfig(interp_factor=1)",
             "fused": f"MotionConfig(interp_factor=1, cv_fused={FUSE})",
             "fused-norival": f"MotionConfig(interp_factor=1, cv_fused={FUSE}, rival_window=False)",
             "compact": f"MotionConfig(interp_factor=1, cv_compact={COMPACT_K}, rival_window=False)",
             "fourcolor": "MotionConfig(interp_factor=1, regularizer='fourcolor')",
             "search": "MotionConfig(interp_factor=1, window_center='search')"}
    for row, res in results.items():
        counts = by_row if res["name"].startswith("color_round_stored[") else by_path
        key = row if counts is by_row else res["name"]
        res["launches_by_path"] = {tag: counts[tag][key] for tag in paths}
        tag = next((t for t in paths if res["launches_by_path"][t] > 0), None)
        if tag is None:
            raise AssertionError(f"kernel {row} ran on no path")
        res["launches"] = res["launches_by_path"][tag]
        res["launches_from"] = paths[tag]

    # 5. CUDA == CPU (plain) end to end on a two-motion pair, default config,
    #    then the search-then-regularize configurations
    h5, w5 = 256, 384
    tex = _texture(h5 + 64, w5 + 64, rng)
    a2 = tex[32:32 + h5, 32:32 + w5]
    left = tex[32 - 3:32 - 3 + h5, 32 + 7:32 + 7 + w5]    # flow (7, -3)
    right = tex[32 + 5:32 + 5 + h5, 32 - 12:32 - 12 + w5]  # flow (-12, 5)
    a1 = np.where(np.arange(w5)[None, :] < w5 // 2, left, right).astype(np.uint8)
    pair = (np.stack([a1, a2]), np.stack([a2, a1]))
    on_gpu, _ = engine.estimate_flow_batched(*pair, cfg)  # numpy frames go to CUDA
    if on_gpu.device.type != "cuda":
        raise AssertionError(f"numpy frames ran on {on_gpu.device}")
    on_cpu, _ = engine.estimate_flow_batched(*pair, cfg, device="cpu")
    if not torch.equal(on_gpu.cpu(), on_cpu):
        diff = int((on_gpu.cpu() != on_cpu).any(-1).sum())
        raise AssertionError(f"CUDA and CPU flows differ at {diff} pixels")
    print(f"[parity] CUDA == CPU on two {h5}x{w5} two-motion pairs (default config)")
    small = cfg.replace(regularizer="exact", block_sizes=(8, 8), search_sizes=(16, 16))
    for what, c, frames in (
        ("fourcolor", cfg.replace(regularizer="fourcolor"), pair),
        ("jacobi", cfg.replace(regularizer="jacobi"), pair),
        ("fourcolor, ssd", cfg.replace(regularizer="fourcolor", cost="ssd"), pair),
        ("window_center=search, reg_radius=8", cfg.replace(window_center="search", reg_radius=8),
         pair),
        ("raster, fourcolor", cfg.replace(search_order="raster", regularizer="fourcolor"), pair),
        ("raster, windowed", cfg.replace(search_order="raster"), pair),
        ("exact, 64x96, block_sizes (8, 8)", small,
         tuple(np.ascontiguousarray(f[:, 96:160, 144:240]) for f in pair)),
        (f"cv_fused={FUSE}", cfg.replace(cv_fused=FUSE), pair),
        (f"cv_fused={FUSE}, rival off", cfg.replace(cv_fused=FUSE, rival_window=False), pair),
        (f"cv_compact={COMPACT_K}, rival off",
         cfg.replace(cv_compact=COMPACT_K, rival_window=False), pair),
        ("cv_compact=4, rival off (chunks overflow)",
         cfg.replace(cv_compact=4, rival_window=False), pair),
    ):
        t0 = time.time()
        overflow = []
        with _overflow_log(overflow):
            on_gpu, _ = engine.estimate_flow_batched(*frames, c)
        on_cpu, _ = engine.estimate_flow_batched(*frames, c, device="cpu")
        if not torch.equal(on_gpu.cpu(), on_cpu):
            diff = int((on_gpu.cpu() != on_cpu).any(-1).sum())
            raise AssertionError(f"{what}: CUDA and CPU flows differ at {diff} pixels")
        more = f"; overflow_fraction per level, coarsest first: {overflow}" if overflow else ""
        print(f"[parity] CUDA == CPU, {what}: {tuple(on_cpu.shape)} ({time.time() - t0:.1f} s)"
              f"{more}")

    # 6. the reference driver at Middlebury geometry, interp_factor=4
    h6, w6 = 388, 584
    tex = _texture(h6 + 64, w6 + 64, rng)
    b2 = tex[32:32 + h6, 32:32 + w6]
    b1 = tex[32 - 2:32 - 2 + h6, 32 + 3:32 + 3 + w6]  # flow (3, -2)
    t0 = time.time()
    fl = engine.estimate_flow_driver(b1, b2, MotionConfig(), device=dev)
    torch.cuda.synchronize()
    core = fl[48:-48, 48:-48]
    ok6 = float((core == torch.tensor([3.0, -2.0], device=dev)).all(-1).float().mean())
    print(f"[driver] interp 4 at {h6}x{w6}: {time.time() - t0:.3f} s, shape {tuple(fl.shape)}, "
          f"interior at the known flow (3, -2): {ok6:.6f}")
    if tuple(fl.shape) != (h6, w6, 2) or not torch.isfinite(fl).all() or ok6 != 1.0:
        raise AssertionError("driver did not recover the known translation")
    del fl
    torch.cuda.empty_cache()

    # 7. cost="zsad" at 1080p, B=2: the plain versions on the card, the
    #    gathers the only kernel
    t0 = time.time()
    _zsad_phase(torch, engine, cfg.replace(cost="zsad"), counters, dev, card)
    print(f"[zsad] phase 7 took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 8. the sequence runner and the CLI on the card
    t0 = time.time()
    _sequence_phase(torch, engine, cfg, counters, dev, card, main_rate)
    print(f"[sequence] phase 8 took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 9. the row and 2-D tiling on one card (in-process transport)
    t0 = time.time()
    _tiling_phase(torch, engine, cfg, counters, dev, card, main_rate, results)
    print(f"[tiled] phase 9 took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 10. the CUDA engine against the port's oracle; JAX's work model
    #     against the measured stages of phase 4's batch
    t0 = time.time()
    _oracle_phase(torch, engine, MotionConfig, counters, dev, card)
    print(f"[oracle] 10(a) took {time.time() - t0:.1f} s ({card})")
    im1, im2 = _main_pairs(torch, dev)
    _work_model_phase(torch, engine, cfg, im1, im2, card)
    del im1, im2
    took = time.time() - t0
    print(f"[model] phase 10 took {took:.1f} s (budget {PHASE10_S} s) ({card})")
    if took > PHASE10_S:
        raise AssertionError(f"phase 10 took {took:.1f} s, over its {PHASE10_S} s budget")

    print(card)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
