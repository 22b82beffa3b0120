"""Worker for the gloo tests of the port (test_torch_multihost.py).

Each process joins the group through ``multihost.initialize_from_env``
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).  With 2 processes it
builds the (batch, ty) mesh of ranks and runs
``estimate_flow_padded_batch_tiled`` through the ``torch.distributed``
transport on a seeded 2-pair batch: rows over the two processes (the halo
and ghost-row exchanges point to point), then pairs over them.  With 4
processes it builds a (ty=2, tx=2) mesh of ranks and runs the 2-D tiling
(``axis_x``: halos, ghost rows and ghost columns with their corners point
to point along both lines) through ``estimate_flow_padded_tiled`` and
``estimate_flow_padded_batch_tiled``.  Each result must equal the
in-process transport's on the same pairs, computed locally, and the
untiled engine.  Imports no JAX.

Run: _torch_distributed_worker.py <coordinator_addr> <num_processes> <process_id>
"""

import os
import sys


def main() -> int:
    addr, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["COORDINATOR_ADDRESS"] = addr
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from blockbasedmotionestimation_tpu_torch.config import MotionConfig
    from blockbasedmotionestimation_tpu_torch.models import engine
    from blockbasedmotionestimation_tpu_torch.parallel import multihost, tiled

    multihost.initialize_from_env(device="cpu")
    multihost.initialize_from_env(device="cpu")  # idempotent
    info = multihost.describe()
    assert info == {"process_index": pid, "process_count": nproc, "local_devices": 1,
                    "global_devices": nproc, "backend": "gloo"}, info
    if nproc == 4:
        return _tiles_2d(pid)
    rows_mesh = multihost.make_mesh()  # one host: every process a row tile
    assert rows_mesh.shape == {"batch": 1, "ty": nproc}, rows_mesh
    batch_mesh = multihost.make_mesh(batch=nproc, tiles=1)

    rng = np.random.default_rng(7)  # the same pairs in every process
    base = rng.integers(0, 256, size=(2, 72, 72), dtype=np.uint8)
    im1s = np.ascontiguousarray(base[:, :64, :64])
    im2s = np.ascontiguousarray(base[:, 2:66, 1:65])
    checked = 0
    for cfg in (
        MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1),
        MotionConfig(block_sizes=(8, 8), search_sizes=(16, 16), interp_factor=1,
                     rival_radius=(4, None), cv_store_radius=2),
        MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                     regularizer="fourcolor"),
    ):
        local = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, cfg, tiled.Mesh((1, nproc)),
                                                       device="cpu")
        whole = engine.estimate_flow_padded(torch.as_tensor(im1s), torch.as_tensor(im2s), cfg)
        assert torch.equal(local, whole), cfg
        plan = tiled.plan_tiling(cfg, 64, 64, nproc)
        assert plan[0]["rows_ok"], plan
        for mesh in (rows_mesh, batch_mesh):
            got = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, cfg, mesh, device="cpu")
            assert torch.equal(got, local), (cfg, mesh)
            checked += 1
    flow = tiled.estimate_flow_batch(im1s, im2s, MotionConfig(block_sizes=(4,), search_sizes=(8,),
                                                              interp_factor=1), batch_mesh,
                                     device="cpu")
    want = engine.estimate_flow_driver_batched(im1s, im2s, MotionConfig(
        block_sizes=(4,), search_sizes=(8,), interp_factor=1), device="cpu")
    assert torch.equal(flow, want)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"process {pid}: checked {checked} OK")
    return 0


def _tiles_2d(pid: int) -> int:
    """The 2-D tiling on a (ty=2, tx=2) mesh of the 4 processes."""
    import numpy as np
    import torch

    from blockbasedmotionestimation_tpu_torch.config import MotionConfig
    from blockbasedmotionestimation_tpu_torch.models import engine
    from blockbasedmotionestimation_tpu_torch.parallel import tiled

    mesh = tiled.Mesh((2, 2), ("ty", "tx"), ranks=np.arange(4).reshape(2, 2))
    assert mesh.coords() == {"ty": pid // 2, "tx": pid % 2}, mesh.coords()
    rng = np.random.default_rng(8)  # the same pairs in every process
    base = rng.integers(0, 256, size=(2, 72, 88), dtype=np.uint8)
    im1s = np.ascontiguousarray(base[:, :64, :80])
    im2s = np.ascontiguousarray(base[:, 3:67, 1:81])
    checked = 0
    for cfg in (
        MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1),
        MotionConfig(block_sizes=(8, 8), search_sizes=(16, 16), interp_factor=1,
                     rival_radius=(4, None), cv_store_radius=2),
        MotionConfig(block_sizes=(4, 4), search_sizes=(6, 6), interp_factor=1,
                     regularizer="fourcolor"),
    ):
        plan = tiled.plan_tiling(cfg, 64, 80, 2, 2)
        assert plan[0]["rows_ok"] and plan[0]["cols_ok"], plan
        local = tiled.estimate_flow_padded_tiled(im1s[0], im2s[0], cfg, tiled.Mesh(
            (2, 2), ("ty", "tx")), axis_x="tx", device="cpu")
        whole = engine.estimate_flow_padded(torch.as_tensor(im1s), torch.as_tensor(im2s), cfg)
        assert torch.equal(local, whole[0]), cfg
        got = tiled.estimate_flow_padded_tiled(im1s[0], im2s[0], cfg, mesh, axis_x="tx",
                                               device="cpu")
        assert torch.equal(got, local), cfg
        got = tiled.estimate_flow_padded_batch_tiled(im1s, im2s, cfg, mesh, batch_axis=None,
                                                     axis_x="tx", device="cpu")
        assert torch.equal(got, whole), cfg
        checked += 2
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"process {pid}: checked {checked} OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
