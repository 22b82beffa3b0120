"""Bytes the tiles of rank 0 sent the other ranks per flow field, in MB,
from the program's own counters (``utils.profiling.counters``'
``exchange_bytes`` of the port, counted from shapes where ``parallel/tiled.py``
exchanges: halos, ghost cells, winners' rings, joins and batch gathers).

Read as ``volumes.stored_gb_per_field`` reads its counter: totals over
every request of the run, after its last one (each request of a cell sends
the same bytes).  None where the program has no such counter, or unless
every request it counted returned the cell's batch."""

from __future__ import annotations

import importlib


def read(st):
    try:
        mod = importlib.import_module("blockbasedmotionestimation_tpu_torch.utils.profiling")
    except ImportError:
        return None
    counters = getattr(mod, "counters", None)
    if counters is None:
        return None
    c = counters()
    batch = st.context.get("batch")
    if ("exchange_bytes" not in c or not c["requests"] or c["requests"] < st.requests
            or c["fields"] != c["requests"] * batch):
        return None
    return c["exchange_bytes"] / c["fields"] / 1e6
