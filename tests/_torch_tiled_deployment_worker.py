"""Worker for tests/test_torch_tiled_deployment.py: one process of a
(ty=2, tx=2) mesh of four, joined by gloo on the CPU.

Joins the group through ``multihost.initialize_from_env``
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), reads the request the
test wrote (``request.pt``: the pairs and the configuration's fields), runs
``tiled.estimate_flow_driver_tiled`` on it through the
``torch.distributed`` transport and writes its flow and what the
program's counters counted over the call to ``<pid>.pt`` beside it.
Imports no JAX.

Run: _torch_tiled_deployment_worker.py <coordinator_addr> <num_processes> <process_id> <dir>
"""

import os
import sys


def main() -> int:
    addr, nproc, pid, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    os.environ["COORDINATOR_ADDRESS"] = addr
    os.environ["NUM_PROCESSES"] = str(nproc)
    os.environ["PROCESS_ID"] = str(pid)

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from blockbasedmotionestimation_tpu_torch.config import MotionConfig
    from blockbasedmotionestimation_tpu_torch.parallel import multihost, tiled
    from blockbasedmotionestimation_tpu_torch.utils import profiling

    multihost.initialize_from_env(device="cpu")
    request = torch.load(os.path.join(out, "request.pt"))
    cfg = MotionConfig.from_fields(request["fields"])
    mesh = tiled.Mesh((2, 2), ("ty", "tx"), ranks=np.arange(4).reshape(2, 2))
    c0 = profiling.counters()
    flow = tiled.estimate_flow_driver_tiled(request["im1"], request["im2"], cfg, mesh,
                                            axis_x="tx")
    c1 = profiling.counters()
    counted = {k: {x: v - c0[k].get(x, 0) for x, v in c1[k].items()}
               for k in ("exchanges_by_kind", "exchange_bytes_by_kind", "tiled_levels_by_form")}
    counted["exchange_bytes"] = c1["exchange_bytes"] - c0["exchange_bytes"]
    torch.save({"flow": flow, "counted": counted}, os.path.join(out, f"{pid}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"process {pid}: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
