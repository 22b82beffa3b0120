"""Command-line interface of the port (``blockbasedmotionestimation_tpu/cli.py``).

The same subcommands, flags, defaults and prints as the reference package's
CLI, plus ``--device`` (default ``cuda``) on the subcommands that estimate
flow; ``--device cpu`` runs the plain versions:

  python -m blockbasedmotionestimation_tpu_torch.cli estimate f1.png f2.png out.flo \
      [--gt gt.flo] [--png flow.png] [--levels 4 --block 32 --search 64 ...]
  python -m blockbasedmotionestimation_tpu_torch.cli evaluate flow.flo gt.flo
  python -m blockbasedmotionestimation_tpu_torch.cli colorize flow.flo out.png [--max-motion M]
  python -m blockbasedmotionestimation_tpu_torch.cli legend out.png [--range 10]
  python -m blockbasedmotionestimation_tpu_torch.cli sequence 'frames/*.png' out_dir [--batch 4]
  python -m blockbasedmotionestimation_tpu_torch.cli middlebury gt_dir [--frames-dir d]

``estimate`` replicates the reference driver (``main_class.cpp:6-85``):
grayscale read, interp-factor upsample, engine, stride subsample, color-coded
PNG, EPE against ground truth when given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _cfg_from_args(args) -> "MotionConfig":
    from blockbasedmotionestimation_tpu_torch.config import MotionConfig

    return MotionConfig(
        block_sizes=tuple([args.block] * args.levels),
        search_sizes=tuple([args.search] * args.levels),
        interp_factor=args.interp,
        regularizer=args.regularizer,
        sweeps_per_round=args.sweeps,
        cost=args.cost,
        rival_window=args.rival,
        rival_radius=args.rival_radius,
        mv_cap=args.mv_cap,
        cv_compact=args.cv_compact,
        cv_fused=args.cv_fused,
        cv_store_radius=(
            None if args.cv_store_radius is not None and args.cv_store_radius < 0
            else args.cv_store_radius
        ),
    )


def _rival_radius_arg(s: str):
    """'8' -> 8; '8,8,full,full' -> (8, 8, None, None) (finest level first)."""
    if "," not in s:
        return None if s == "full" else int(s)
    return tuple(None if t.strip() == "full" else int(t) for t in s.split(","))


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--levels", type=int, default=4, help="pyramid levels (main_class.cpp:19)")
    p.add_argument("--block", type=int, default=32, help="block size (main_class.cpp:21)")
    p.add_argument("--search", type=int, default=64, help="search size (main_class.cpp:20)")
    p.add_argument("--interp", type=int, default=4,
                   help="pre-upsample factor, 1 disables (main_class.cpp:32-33)")
    p.add_argument("--regularizer", default="windowed",
                   choices=["exact", "fourcolor", "jacobi", "windowed"])
    p.add_argument("--sweeps", type=int, default=2, help="sweeps per subdivision round")
    p.add_argument("--cost", default="sad", choices=["sad", "ssd", "zsad"],
                   help="matching cost: sad = the reference's cv::norm L1 "
                        "(motion_framework.cpp:315, default); zsad = "
                        "zero-mean SAD, robust to gain/offset brightness "
                        "nuisance (EVAL_robust.md)")
    p.add_argument("--rival", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="rival windows: close the windowed path's accuracy "
                        "gap at motion discontinuities (see config docs)")
    p.add_argument("--rival-radius", type=_rival_radius_arg,
                   default=(12, None, 8, 8),
                   help="rival window radius: one int for every level, or a "
                        "comma list finest-first with 'full' for the level's "
                        "primary radius (a short list repeats its last entry "
                        "for deeper levels).  Default '12,full,8,8' - the "
                        "measured accuracy/throughput knee; the large-motion "
                        "accuracy lives at level 1 (EVAL_full.md "
                        "Urban2/Urban3)")
    p.add_argument("--mv-cap", type=int, default=None,
                   help="cap cross-level MV predictions (bounds tiled halos)")
    p.add_argument("--cv-compact", type=int, default=None,
                   help="K-slot compact cost volumes (capacity mode for "
                        "very large frames; see config docs)")
    p.add_argument("--cv-fused", type=int, default=None,
                   help="chunk-fused fine rounds: recompute costs for "
                        "sub-block sizes <= this in-kernel from the windows' "
                        "pixels instead of materializing their dense cost "
                        "volumes (bit-exact; typical value 4)")
    p.add_argument("--device", default="cuda",
                   help="torch device the frames go to: cuda (the kernels) "
                        "or cpu (their plain versions)")
    p.add_argument("--cv-store-radius", type=int, default=4,
                   help="r_store: keep only a reduced column-delta band of "
                        "the cur=2 cost volume (the HBM dominator) and "
                        "recompute tail candidates bit-exactly from the "
                        "window slab (hybrid rival path only; bit-exact). "
                        "Default 4 (the production config); pass a "
                        "negative value for the dense volume")


def cmd_estimate(args) -> int:
    from blockbasedmotionestimation_tpu_torch.models.engine import estimate_flow_driver
    from blockbasedmotionestimation_tpu_torch.utils import flowio, profiling

    im1 = flowio.read_gray(args.frame1)
    im2 = flowio.read_gray(args.frame2)
    cfg = _cfg_from_args(args)

    t0 = time.time()
    flow = profiling.host_read(estimate_flow_driver(im1, im2, cfg, device=args.device),
                               "download").numpy()
    print(f"Seconds: {time.time() - t0:.3f}")  # parity: main_class.cpp:55

    flowio.write_flo(args.out, flow)
    if args.png:
        flowio.write_image(args.png, flowio.flow_to_color(flow, verbose=True))
    if args.gt:
        gt = flowio.read_flo(args.gt)
        print(f"The MSE is {flowio.average_epe(gt, flow)}")  # parity: main_class.cpp:82
    return 0


def cmd_evaluate(args) -> int:
    from blockbasedmotionestimation_tpu_torch.utils import flowio

    flow = flowio.read_flo(args.flow)
    gt = flowio.read_flo(args.gt)
    if flow.shape != gt.shape:
        print(f"shape mismatch: {flow.shape} vs {gt.shape}", file=sys.stderr)
        return 1
    print(f"average EPE: {flowio.average_epe(gt, flow):.6f}")
    return 0


def cmd_colorize(args) -> int:
    # the bundled color_flow tool (middlebury/flow-code/color_flow.cpp:68-99)
    from blockbasedmotionestimation_tpu_torch.utils import flowio

    flow = flowio.read_flo(args.flow)
    max_motion = -1.0 if args.max_motion is None else args.max_motion
    img = flowio.flow_to_color(flow, max_motion=max_motion, verbose=True)
    flowio.write_image(args.out, img)
    return 0


def cmd_legend(args) -> int:
    # the bundled colortest tool (middlebury/flow-code/colortest.cpp:12-61)
    from blockbasedmotionestimation_tpu_torch.utils import flowio

    flowio.write_image(args.out, flowio.color_legend(args.range))
    return 0


def cmd_sequence(args) -> int:
    import glob as globmod

    from blockbasedmotionestimation_tpu_torch.models import sequence

    frames = sorted(globmod.glob(args.frames_glob))
    if len(frames) < 2:
        print(f"need >= 2 frames, glob matched {len(frames)}", file=sys.stderr)
        return 1
    cfg = _cfg_from_args(args)

    def progress(r):
        state = "resumed" if r.skipped else f"{r.seconds:.3f}s"
        print(f"pair {r.index:05d}: {state}", flush=True)

    results = sequence.run_sequence(
        frames, args.out_dir, cfg, progress=progress, batch_size=args.batch,
        out_stride=args.out_stride, transfer_dtype=args.transfer, device=args.device,
    )
    done = [r for r in results if not r.skipped]
    total = sum(r.seconds for r in done)
    print(f"{len(done)} computed, {len(results) - len(done)} resumed, "
          f"{total:.2f}s ({len(done) / total:.2f} pairs/s)" if done else
          f"0 computed, {len(results)} resumed")
    return 0


def cmd_middlebury(args) -> int:
    from blockbasedmotionestimation_tpu_torch.models import evaluate

    cfg = _cfg_from_args(args)
    seqs = tuple(args.sequences) if args.sequences else evaluate.SEQUENCES
    results = evaluate.evaluate_middlebury(
        args.gt_dir, cfg, sequences=seqs, frames_dir=args.frames_dir, seed=args.seed,
        device=args.device,
    )
    print(evaluate.format_report(results))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="blockbasedmotionestimation_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("estimate", help="estimate flow between two grayscale frames")
    p.add_argument("frame1")
    p.add_argument("frame2")
    p.add_argument("out", help="output .flo path")
    p.add_argument("--png", help="also write a color-coded PNG")
    p.add_argument("--gt", help="ground-truth .flo for EPE")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("evaluate", help="average EPE between a flow and ground truth")
    p.add_argument("flow")
    p.add_argument("gt")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("colorize", help=".flo -> color PNG (color_flow tool)")
    p.add_argument("flow")
    p.add_argument("out")
    p.add_argument("--max-motion", type=float, default=None)
    p.set_defaults(fn=cmd_colorize)

    p = sub.add_parser("legend", help="render the color-wheel legend (colortest tool)")
    p.add_argument("out")
    p.add_argument("--range", type=int, default=10)
    p.set_defaults(fn=cmd_legend)

    p = sub.add_parser("sequence",
                       help="flow for every consecutive pair of a frame "
                            "sequence, with per-pair .flo checkpoint/resume")
    p.add_argument("frames_glob", help="glob of grayscale frames, sorted order")
    p.add_argument("out_dir")
    p.add_argument("--batch", type=int, default=1,
                   help="pairs per estimate call (throughput mode)")
    p.add_argument("--out-stride", type=int, default=1,
                   help="on-device flow subsampling before transfer (the "
                        "reference driver writes every interp_factor-th "
                        "pixel, main_class.cpp:57-70); cuts the "
                        "device-to-host copy")
    p.add_argument("--transfer", choices=("f32", "f16"), default="f32",
                   help="device->host dtype; f16 halves transfer and is "
                        "exact for quarter-pel |mv| <= 512")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_sequence)

    p = sub.add_parser("middlebury", help="evaluate over the Middlebury gt-flow set")
    p.add_argument("gt_dir", help="dir with <seq>/flow10.flo ground truth")
    p.add_argument("--frames-dir", default=None,
                   help="dir with <seq>/frame10.png pairs; default: synthesize "
                        "brightness-constant pairs by warping texture through gt")
    p.add_argument("--sequences", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    _add_engine_args(p)
    p.set_defaults(fn=cmd_middlebury)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
