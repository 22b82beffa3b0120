"""The benchmark of the PyTorch / CUDA motion estimator, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with an NVIDIA card; a cell
whose ``chips`` is above 1 runs one process a card (``ranks.py``), and
needs as many cards.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers the check compared, each
with its limit; the same numbers end standard error.  Without a CUDA card,
or without the program beside the benchmark, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches live in the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card and has no CPU fallback",
              file=sys.stderr)
        return 2
    try:
        import blockbasedmotionestimation_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if cell.chips > 1:
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA devices, this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from blockbasedmotionestimation_tpu_torch.kernels import _build

        from benchmark import ranks

        _build.build()  # once, before the ranks load it
        return ranks.launch(args.workload, args.seed, args.seconds, args.trace, cell.chips,
                            "cuda", T_START)
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"the run loaded JAX or the JAX package: {foreign}", file=sys.stderr)
        return 3
    harness.report(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
