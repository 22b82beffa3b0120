"""Multi-process runtime over ``torch.distributed``
(``blockbasedmotionestimation_tpu/parallel/multihost.py``).

Each process drives one device and holds one tile of the mesh.  Layout:
the "batch" axis maps to hosts (frame pairs never cross a host, so batch
traffic is embarrassingly parallel) and the "ty" row-tiling axis to the
processes of a host (the halo exchanges stay on the host's links).
``make_mesh`` builds exactly that.  The process group is NCCL for CUDA
devices and gloo for the CPU, chosen from the device asked for, never one
in place of the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from blockbasedmotionestimation_tpu_torch.parallel.tiled import Mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_from_env(device="cuda", **kwargs) -> None:
    """``torch.distributed.init_process_group`` with the reference's env
    fallbacks: COORDINATOR_ADDRESS (host:port) / NUM_PROCESSES /
    PROCESS_ID when all are set, else the launcher's ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``device`` picks the
    backend: NCCL for "cuda" (each process then takes CUDA device
    LOCAL_RANK, else rank modulo the devices), gloo for "cpu".  Idempotent:
    a second call is a no-op."""
    if getattr(initialize_from_env, "_done", False):
        return
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process group backend for device {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("NCCL needs a CUDA device, and none is available")
    addr = os.environ.get("COORDINATOR_ADDRESS")
    nproc = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if addr and nproc and pid:
        kwargs.setdefault("init_method", f"tcp://{addr}")
        kwargs.setdefault("world_size", int(nproc))
        kwargs.setdefault("rank", int(pid))
    else:
        kwargs.setdefault("init_method", "env://")
    dist.init_process_group(backend=_BACKENDS[kind], **kwargs)
    if kind == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    initialize_from_env._done = True


def _world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(batch: int | None = None, tiles: int | None = None, ranks=None) -> Mesh:
    """(batch, ty) mesh over ``ranks`` (default: every process).

    Defaults: batch = the number of hosts (world size over LOCAL_WORLD_SIZE,
    the processes a host runs; 1 when unset), tiles = the processes of a
    host, so halo exchange stays on a host and batch parallelism between
    hosts.
    """
    ranks = np.arange(_world()[1]) if ranks is None else np.asarray(ranks)
    n = ranks.size
    if batch is None:
        batch = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
        if n % batch:
            batch = 1
    if tiles is None:
        tiles = n // batch
    if batch * tiles != n:
        raise ValueError(f"mesh {batch}x{tiles} != {n} ranks")
    return Mesh((batch, tiles), ("batch", "ty"), ranks=ranks)


def describe() -> dict:
    """Structured runtime report: this process's index, the processes, the
    devices each drives (one) and in all, and the backend (the process
    group's, else the device platform)."""
    rank, world = _world()
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
        "backend": backend,
    }
