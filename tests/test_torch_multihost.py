"""The port's multi-process runtime (``parallel/multihost.py``) and its
``torch.distributed`` transport.

``make_mesh`` and ``describe`` (mirrors of tests/test_parallel_utils.py),
then two real processes joined by gloo on the CPU
(tests/_torch_distributed_worker.py): the row-tiled and batch-split engine
through the point-to-point transport equals the in-process transport and
the untiled engine (mirror of tests/test_multihost.py); and four processes
on a (ty=2, tx=2) mesh: the 2-D tiling through the same transport equals
them too.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blockbasedmotionestimation_tpu_torch.parallel import multihost, tiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_distributed_worker.py")


def test_make_mesh_shapes():
    mesh = multihost.make_mesh(batch=2, tiles=4, ranks=range(8))
    assert mesh.shape == {"batch": 2, "ty": 4}
    assert mesh.ranks.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.distributed
    mesh = multihost.make_mesh()  # no process group: one process, one tile
    assert mesh.shape["batch"] * mesh.shape["ty"] == 1
    assert not mesh.distributed
    with pytest.raises(ValueError, match="ranks"):
        multihost.make_mesh(batch=3, tiles=2, ranks=range(8))
    assert tiled.Mesh((2, 4)).shape == {"batch": 2, "ty": 4}


def test_describe_keys():
    d = multihost.describe()
    assert set(d) == {"process_index", "process_count", "local_devices", "global_devices",
                      "backend"}
    assert d["process_count"] == 1 and d["global_devices"] == 1 and d["process_index"] == 0


def test_initialize_refuses_nccl_without_cuda(monkeypatch):
    # the backend follows the device asked for; no quiet gloo for "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost.initialize_from_env, "_done", False, raising=False)
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize_from_env(device="cuda")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(nproc: int) -> list[str]:
    """Start ``nproc`` gloo workers on a free local port; their outputs, each
    checked for a 0 exit."""
    addr = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [
        subprocess.Popen([sys.executable, WORKER, addr, str(nproc), str(pid)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    return outs


def test_two_process_gloo_batch_tiled():
    for out in _run_workers(2):
        assert "checked 6 OK" in out, out


def test_four_process_gloo_2d_tiled():
    # a (ty=2, tx=2) mesh of 4 processes: halos, ghost rows and ghost
    # columns (corners included) swapped point to point along both lines
    for out in _run_workers(4):
        assert "checked 6 OK" in out, out
