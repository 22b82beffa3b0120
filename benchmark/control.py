"""The check's control: the cell's plain reference in the program's place, its
energy in bfloat16 (the nearest precision below the configuration's
float32), held to the reference in float32.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the run's request pool, draws ``check_fields``
fields of it from the seed, spread over the batch slots as the run's
sample is, and prints the pixels at which the lowered
reference's flow differs from the reference's: the reading the run's check
would give if the program computed its energies in bfloat16.  A sound
control reads above the check's limit (0) on every seed.  One JSON line a
seed; needs a CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds: list[int], device: str) -> list[dict]:
    import numpy as np
    import torch

    from benchmark import gen, harness

    reference = harness.reference_module(cell.reference)
    dev = torch.device(device)
    devices = [torch.device("cuda", i) for i in range(cell.chips)] if dev.type == "cuda" \
        else [dev]
    fields_cfg = harness.motion_fields(cell.config)
    tr = cell.traffic
    h, w = cell.config["frame"]["height"], cell.config["frame"]["width"]
    batch, n_pool, k = int(tr["batch"]), int(tr["pool_requests"]), int(tr["check_fields"])
    out = []
    for seed in seeds:
        t = time.perf_counter()
        frames = gen.pool(tr, h, w, seed, dev)
        rng = np.random.default_rng([seed, 0xC0])
        picks = [int(r) * batch + j for j in range(batch)
                 for r in rng.choice(n_pool, size=min(k // batch + (j < k % batch), n_pool),
                                     replace=False)]
        bad = 0
        for p in sorted(int(x) for x in picks):
            a, b = frames[p:p + 1], frames[p + 1:p + 2]
            want = reference.estimate(a, b, fields_cfg, devices=devices)
            low = reference.estimate(a, b, fields_cfg, energy_dtype=torch.bfloat16,
                                     devices=devices)
            bad += reference.mismatched_pixels(low, want)
        out.append({"seed": seed, "fields": len(picks), "mismatched_px": bad,
                    "seconds": time.perf_counter() - t})
        del frames
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for r in readings(harness.load_cell(args.workload), args.seeds, args.device):
        print(json.dumps(dict(r, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
