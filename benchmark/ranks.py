"""A cell on several cards: one worker process a card.

``run.py`` calls ``launch`` for a cell whose ``chips`` is above 1; it
starts this file once a rank, on this machine:

    python3 benchmark/ranks.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        --device cuda --spec BENCHMARK.json --started <t> --parent <pid>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` (127.0.0.1) and a free ``MASTER_PORT`` in its environment,
and no ``CUDA_VISIBLE_DEVICES`` of its own: every rank sees every card of
the cell, and takes card ``LOCAL_RANK``.  A worker joins the program's
process group (``parallel.multihost.initialize_from_env``: NCCL on
``cuda``, gloo on ``cpu``) and a gloo group of the harness's own, which
carries its host-side collectives (the window's decisions, barriers, the
ranks' states), so that none of them is a device operation in a trace.

The contract: every rank runs ``harness.run`` and so the same requests;
rank 0 times them, decides when the window ends and runs the check once
every rank has freed the program's state; the other ranks wait until it
is done.  Then every rank hands rank 0 the modules of JAX or the JAX
package it holds, and rank 0 alone prints the check lines and the result.
The launcher relays that result only where every rank ended with 0 and it
holds no such module itself; where a rank ends otherwise, it stops the
others at once, and where the ranks have not all ended ``RUN_TIMEOUT_S``
after their start, it stops them all: either way the run ends non-zero
with no result line.  A collective that waits ``RANK_TIMEOUT_S`` raises.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# a collective of the program's group or the harness's waits this long
RANK_TIMEOUT_S = 300
# the workers of one run all end within this many seconds of their start
RUN_TIMEOUT_S = 330
_PR_SET_PDEATHSIG = 1
_CLEARED = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


class Ranks:
    """This worker's place among the cell's: its rank, the world's size,
    the cell's devices, and the harness's own gloo group."""

    def __init__(self, rank: int, world: int, devices: list, group):
        self.rank, self.world, self.devices, self.group = rank, world, devices, group

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, tensor) -> None:
        """Rank 0's ``tensor`` into every rank's, over the program's group."""
        import torch.distributed as dist

        dist.broadcast(tensor, src=0)

    def decide(self, stop: bool, start_trace: bool, busy: bool) -> tuple[bool, bool]:
        """After each request, once this rank's flow is synchronised: rank
        0's ``stop`` and ``start_trace``, the others' ignored; the window
        stops only where no rank's tracer is still ``busy``."""
        import torch
        import torch.distributed as dist

        lead = self.rank == 0
        votes = torch.tensor([stop and lead, start_trace and lead, busy], dtype=torch.int32)
        dist.all_reduce(votes, op=dist.ReduceOp.MAX, group=self.group)
        stop, start_trace, busy = (bool(v) for v in votes.tolist())
        return stop and not busy, start_trace


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(text: str, rank: int, limit: int | None = None) -> str:
    lines = text.splitlines()
    if limit is not None:
        lines = lines[-limit:]
    return "".join(f"[rank {rank}] {ln}\n" for ln in lines)


def launch(workload: str, seed: int, seconds: float, trace: int, chips: int, device: str,
           t_start: float, spec: Path = ROOT / "BENCHMARK.json", out=None, err=None,
           timeout_s: float = RUN_TIMEOUT_S) -> int:
    """Run the cell in ``chips`` worker processes and relay rank 0's result
    to ``out`` and the ranks' standard error to ``err`` (rank 0's last, so
    its check lines end it); returns the exit code.  ``t_start`` is this
    process's start on ``time.perf_counter``, where ``setup_s`` counts
    from."""
    from benchmark import harness

    out = out or sys.stdout
    err = err or sys.stderr
    started = time.monotonic() - (time.perf_counter() - t_start)
    env = {k: v for k, v in os.environ.items() if k not in _CLEARED}
    env.update(WORLD_SIZE=str(chips), LOCAL_WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace)),
           "--device", device, "--spec", str(Path(spec).resolve()), "--started", repr(started),
           "--parent", str(os.getpid())]
    failed = None
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        files, procs = [], []
        previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        try:
            for r in range(chips):
                o = open(Path(tmp) / f"{r}.out", "w+")
                e = open(Path(tmp) / f"{r}.err", "w+")
                files.append((o, e))
                procs.append(subprocess.Popen(cmd, stdout=o, stderr=e, stdin=subprocess.DEVNULL,
                                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            deadline = time.monotonic() + timeout_s
            while failed is None:
                codes = [p.poll() for p in procs]
                ended = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if ended:
                    r, c = ended[0]
                    failed = (f"ranks: rank {r} ended with {c}; every other rank stopped",
                              c if c > 0 else 1)
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    waiting = [r for r, c in enumerate(codes) if c is None]
                    failed = (f"ranks: ranks {waiting} had not ended {timeout_s:.0f} s after "
                              f"the workers started; every rank stopped", 1)
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            signal.signal(signal.SIGTERM, previous)
            texts = []
            for o, e in files:
                o.seek(0)
                e.seek(0)
                texts.append((o.read(), e.read()))
                o.close()
                e.close()
    if failed is None:
        foreign = harness.foreign_modules()
        if foreign:
            failed = (f"the launcher loaded JAX or the JAX package: {foreign}", 3)
    if failed is not None:
        for r, (_, e) in enumerate(texts):
            err.write(_tail(e, r, 60))
        print(failed[0], file=err, flush=True)
        return failed[1]
    for r, (_, e) in list(enumerate(texts))[1:]:
        err.write(_tail(e, r))
    err.write(texts[0][1])
    err.flush()
    out.write(texts[0][0])
    out.flush()
    return 0


def main(argv: list[str] | None = None) -> int:
    """One worker: the cell's run on this rank's card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--started", type=float, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    # a worker ends with its launcher, however that ends
    ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != args.parent:
        return 1
    t_start = time.perf_counter() - (time.monotonic() - args.started)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from blockbasedmotionestimation_tpu_torch.parallel import multihost

    from benchmark import harness

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = timedelta(seconds=RANK_TIMEOUT_S)
    multihost.initialize_from_env(args.device, timeout=timeout)
    try:
        group = dist.new_group(backend="gloo", timeout=timeout)
        if args.device == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            devices = [torch.device("cuda", i) for i in range(world)]
        else:
            dev = torch.device("cpu")
            devices = [dev]
        ranks = Ranks(rank, world, devices, group)
        cell = harness.load_cell(args.workload, Path(args.spec))
        done = harness.run(cell, args.seed, args.seconds, bool(args.trace), str(dev), t_start,
                           ranks=ranks)
        # every rank, once rank 0's check is done
        found = ranks.gather(harness.foreign_modules())
        if rank != 0:
            return 0
        foreign = {r: f for r, f in enumerate(found) if f}
        if foreign:
            print(f"the run loaded JAX or the JAX package: {foreign}", file=sys.stderr)
            return 3
        harness.report(*done)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
