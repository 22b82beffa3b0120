"""Bytes of the cost volumes the program allocated per flow field, in GB,
from its own counters (``utils.profiling.counters``' ``volume_bytes`` of
the port, counted from shapes and dtypes where the volume wrappers
allocate): every volume of every level, summed, whichever form stored it.
What the volumes of a request take is the largest part of the cell's peak
memory.

Read as ``engine.syncs_per_field`` reads its counter: totals over every
request of the run, after its last one (each request of a cell allocates
the same volumes, so the totals read as the stretch would).  None where
the program has no such counter, or unless every request it counted
returned the cell's batch."""

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
    if ("volume_bytes" not in c or not c["requests"] or c["requests"] < st.requests
            or c["fields"] != c["requests"] * batch):
        return None
    return c["volume_bytes"] / c["fields"] / 1e9
