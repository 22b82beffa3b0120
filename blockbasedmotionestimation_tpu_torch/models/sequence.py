"""Multi-frame sequence runner with frame-granular checkpoint/resume
(``blockbasedmotionestimation_tpu/models/sequence.py``).

Estimates flow for every consecutive frame pair, writes one ``.flo`` (the
checkpoint unit) per pair, skips pairs whose output already exists (resume
after interruption), and writes a ``report.json`` of the run.  Each frame
is decoded and uploaded once (a small sliding cache of device tensors),
pairs are stacked on the device, batch k+1 is launched before batch k is
downloaded (the ``.cpu()`` copy is the barrier), and the ``.flo`` files
are written by a pool of 4 threads, each through a ``.tmp.flo`` renamed
into place.  PyTorch does not compile per shape, so a short tail batch
runs as it is (the reference pads it to the compiled batch; the flows are
the same).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.config import MotionConfig
from blockbasedmotionestimation_tpu_torch.models.engine import estimate_flow_driver_batched
from blockbasedmotionestimation_tpu_torch.utils import flowio, profiling


@dataclasses.dataclass
class PairResult:
    index: int
    out_path: str
    seconds: float
    skipped: bool  # already present -> resumed past it


def flo_name(index: int) -> str:
    return f"flow{index:05d}.flo"


def _shrink(flows: torch.Tensor, out_stride: int, transfer_dtype: str) -> torch.Tensor:
    """On-device subsample at ``out_stride`` (a reshape and an index) and
    downcast to f16 before the download."""
    if out_stride > 1:
        b, h, w, c = flows.shape
        hs, ws = h // out_stride, w // out_stride
        flows = flows[:, : hs * out_stride, : ws * out_stride].reshape(
            b, hs, out_stride, ws, out_stride, c
        )[:, :, 0, :, 0]
    if transfer_dtype == "f16":
        flows = flows.half()
    return flows


def _write_checkpoint(flow: np.ndarray, path: str) -> None:
    tmp = path[: -len(".flo")] + ".tmp.flo"
    flowio.write_flo(tmp, flow)
    os.replace(tmp, path)  # atomic: no torn checkpoints on interrupt


def run_sequence(
    frames: Sequence[np.ndarray] | Sequence[str],
    out_dir: str | os.PathLike,
    cfg: MotionConfig,
    progress: Callable[[PairResult], None] | None = None,
    write_report: bool = True,
    batch_size: int = 1,
    out_stride: int = 1,
    transfer_dtype: str = "f32",
    device=None,
) -> list[PairResult]:
    """Estimate flow for every consecutive pair, checkpointing per pair.

    frames: (H, W) uint8 arrays or image paths (read as grayscale).
    Existing outputs in out_dir are trusted and skipped (resume semantics);
    delete them to force recompute.  ``batch_size`` > 1 runs that many
    pending pairs in one ``estimate_flow_driver_batched`` call (the
    checkpoint unit stays one .flo per pair).  ``out_stride=s`` subsamples
    each field on the device at stride s before the download and
    ``transfer_dtype="f16"`` downloads float16 (exact for quarter-pel
    |mv| <= 512); the .flo then holds the subsampled field at its f32
    values.  ``device``: where the frames go (CUDA unless asked).
    """
    out_dir = os.fspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    batch_size = max(1, batch_size)
    if transfer_dtype not in ("f32", "f16"):
        raise ValueError(f"transfer_dtype must be f32 or f16, got {transfer_dtype}")
    dev = torch.device("cuda" if device is None else device)

    cache: dict[int, torch.Tensor] = {}

    def load(i: int) -> torch.Tensor:
        # consecutive pairs share a frame: each is decoded and uploaded once
        if i not in cache:
            f = frames[i]
            arr = flowio.read_gray(f) if isinstance(f, (str, os.PathLike)) else np.asarray(f)
            cache[i] = profiling.upload(arr, dev, "frames")
            for k in [k for k in cache if k < i - 2 * batch_size]:
                del cache[k]
        return cache[i]

    def launch(batch: list[tuple[int, str]]):
        a = torch.stack([load(i) for i, _ in batch])
        b = torch.stack([load(i + 1) for i, _ in batch])
        flows = _shrink(estimate_flow_driver_batched(a, b, cfg), out_stride, transfer_dtype)
        return batch, flows, time.time()

    results: list[PairResult] = []
    write_futs = []

    def drain(in_flight, pool: ThreadPoolExecutor) -> None:
        batch, flows, t0 = in_flight
        # the barrier: the whole batch
        host = profiling.host_read(flows, "download").to(torch.float32).numpy()
        per = (time.time() - t0) / len(batch)
        for (i, path), flow in zip(batch, host):
            write_futs.append(pool.submit(_write_checkpoint, np.ascontiguousarray(flow), path))
            r = PairResult(index=i, out_path=path, seconds=per, skipped=False)
            results.append(r)
            if progress is not None:
                progress(r)

    with ThreadPoolExecutor(max_workers=4) as pool:
        pending: list[tuple[int, str]] = []
        in_flight = None
        for i in range(len(frames) - 1):
            path = os.path.join(out_dir, flo_name(i))
            if os.path.exists(path):
                r = PairResult(index=i, out_path=path, seconds=0.0, skipped=True)
                results.append(r)
                if progress is not None:
                    progress(r)
                continue
            pending.append((i, path))
            if len(pending) >= batch_size:
                # batch k+1 is queued before batch k is downloaded
                nxt = launch(pending)
                pending = []
                if in_flight is not None:
                    drain(in_flight, pool)
                in_flight = nxt
        if pending:
            nxt = launch(pending)
            if in_flight is not None:
                drain(in_flight, pool)
            in_flight = nxt
        if in_flight is not None:
            drain(in_flight, pool)
        for f in write_futs:
            f.result()
    results.sort(key=lambda r: r.index)

    if write_report:
        done = [r for r in results if not r.skipped]
        report = {
            "pairs": len(results),
            "computed": len(done),
            "resumed": len(results) - len(done),
            "total_seconds": round(sum(r.seconds for r in done), 3),
            "pairs_per_sec": (
                round(len(done) / max(sum(r.seconds for r in done), 1e-9), 4)
                if done else None
            ),
            "out_stride": out_stride,
            "transfer_dtype": transfer_dtype,
            "config": {
                "block_sizes": list(cfg.block_sizes),
                "search_sizes": list(cfg.search_sizes),
                "interp_factor": cfg.interp_factor,
                "regularizer": cfg.regularizer,
                "cost": cfg.cost,
            },
        }
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
    return results
